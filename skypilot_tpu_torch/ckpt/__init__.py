"""Preemption-aware checkpointing (counterpart of skypilot_tpu.ckpt).

Three layers, writing and reading the JAX package's files:

- ``ckpt.format`` — the sharded on-disk format: per-array shard files,
  a JSON manifest with SHA-256 content hashes, and an atomic
  temp-dir-rename commit with a ``COMMITTED`` marker.
- ``ckpt.writer`` — the bounded background writer of the async save
  pipeline.
- ``ckpt.manager`` — ``CheckpointManager``: interval saves, retention
  GC, committed-only discovery, hash-verified restore with
  walk-down-on-corruption, and the SIGTERM emergency-save hook.

The managed-jobs resume contract also lives here: ``resume_envs``
computes the ``SKYTPU_RESUME_*`` variables a controller injects into a
relaunched task so it resumes from the last *committed* step.
"""
from __future__ import annotations

from typing import Dict, Optional

from skypilot_tpu_torch.ckpt.format import (CorruptCheckpointError,
                                            Shard, latest_step,
                                            load_manifest,
                                            restore_pytree_resharded,
                                            scan_steps)
from skypilot_tpu_torch.ckpt.manager import CheckpointManager
from skypilot_tpu_torch.ckpt.writer import AsyncCheckpointWriter
from skypilot_tpu_torch.utils import env_contract

__all__ = ['AsyncCheckpointWriter', 'CheckpointManager',
           'CorruptCheckpointError', 'Shard', 'latest_step',
           'restore_pytree_resharded', 'resume_envs', 'scan_steps']


def resume_envs(ckpt_dir: Optional[str]) -> Dict[str, str]:
    """The resume env vars for a task whose checkpoint root is
    ``ckpt_dir`` (its ``SKYTPU_CKPT_DIR``).  Empty when the dir is
    unset, not locally visible (a ``://`` URI), or holds no committed
    checkpoint.  Besides the path/step, the WRITER grid of the resume
    step is published as ``SKYTPU_RESUME_TOPOLOGY`` so a relaunch onto
    different capacity knows the restore must reshard."""
    if not ckpt_dir or '://' in ckpt_dir:
        return {}
    step = latest_step(ckpt_dir)
    if step is None:
        return {}
    envs = {env_contract.RESUME_CKPT_PATH: ckpt_dir,
            env_contract.RESUME_STEP: str(step)}
    try:
        manifest = load_manifest(ckpt_dir, step)
        envs[env_contract.RESUME_TOPOLOGY] = str(
            int(manifest.get('process_count', 1)))
    except CorruptCheckpointError:
        # Legacy Orbax dirs carry no manifest; topology stays unknown
        # and the restore side detects the grid from the data itself.
        pass
    return envs
