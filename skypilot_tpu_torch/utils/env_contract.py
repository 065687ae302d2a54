"""The checkpoint/resume part of the environment contract of a job.

Counterpart of the resume subset of skypilot_tpu/utils/env_contract.py,
with the same variable names, so a managed-job controller or agent that
injects them drives either package.  ``CKPT_DIR`` is user-declared in the
task's envs: the checkpoint root the recipe writes to.  The others are
set by the system on a relaunch: ``RESUME_CKPT_PATH`` and ``RESUME_STEP``
name the last *committed* step (``ckpt.latest_step``), and
``RESUME_TOPOLOGY`` the process count of the grid that wrote it, so a
relaunch onto another grid knows its restore reshards.  Recipes read them
through ``resume_target()``, or call ``Trainer.restore_latest``, which
trusts the on-disk commit markers directly.

The distributed half of the reference contract (``initialize_from_env``)
comes with the mesh slice.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

CKPT_DIR = 'SKYTPU_CKPT_DIR'
RESUME_CKPT_PATH = 'SKYTPU_RESUME_CKPT_PATH'
RESUME_STEP = 'SKYTPU_RESUME_STEP'
RESUME_TOPOLOGY = 'SKYTPU_RESUME_TOPOLOGY'


def resume_target() -> Optional[Tuple[str, int]]:
    """The (checkpoint_dir, step) a relaunched task should resume from,
    per the injected resume contract; None when not a resumed run."""
    path = os.environ.get(RESUME_CKPT_PATH, '')
    step = os.environ.get(RESUME_STEP, '')
    if not path or not step:
        return None
    try:
        return path, int(step)
    except ValueError:
        return None


def resume_topology() -> Optional[int]:
    """Process count of the grid that wrote the resume checkpoint
    (``SKYTPU_RESUME_TOPOLOGY``); None when unset or unparseable.
    Compare it with the current grid to detect a resharding resume."""
    raw = os.environ.get(RESUME_TOPOLOGY, '')
    try:
        return int(raw) if raw else None
    except ValueError:
        return None
