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

The distributed half carries the reference's variables too
(``make_env_vars``): ``SKYPILOT_NODE_*`` for recipes, and
``SKYTPU_COORDINATOR_ADDRESS``/``SKYTPU_PROCESS_ID``/
``SKYTPU_NUM_PROCESSES`` for the process grid.  Where the JAX package
hands them to ``jax.distributed.initialize`` (one process a host),
``initialize_from_env`` hands them to ``torch.distributed.
init_process_group``: the coordinator's ``host:port`` is the TCP
rendezvous, and a host that runs one process a card (``procs_per_host``)
numbers its processes host-major, rank = process id x procs_per_host +
local rank.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

# Kept for recipe compatibility with the reference.
NODE_IPS = 'SKYPILOT_NODE_IPS'
NUM_NODES = 'SKYPILOT_NUM_NODES'
NODE_RANK = 'SKYPILOT_NODE_RANK'
NUM_CHIPS_PER_NODE = 'SKYPILOT_NUM_CHIPS_PER_NODE'
TASK_ID = 'SKYPILOT_TASK_ID'
CLUSTER_INFO = 'SKYPILOT_CLUSTER_INFO'

COORDINATOR_ADDRESS = 'SKYTPU_COORDINATOR_ADDRESS'
PROCESS_ID = 'SKYTPU_PROCESS_ID'
NUM_PROCESSES = 'SKYTPU_NUM_PROCESSES'
COORDINATOR_PORT_DEFAULT = 8476

# Multislice contract (the dp axis across slices).
MEGASCALE_COORDINATOR = 'MEGASCALE_COORDINATOR_ADDRESS'
MEGASCALE_NUM_SLICES = 'MEGASCALE_NUM_SLICES'
MEGASCALE_SLICE_ID = 'MEGASCALE_SLICE_ID'

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


def make_env_vars(node_rank: int,
                  node_ips: List[str],
                  num_chips_per_node: int,
                  task_id: str = '',
                  coordinator_port: int = COORDINATOR_PORT_DEFAULT,
                  num_slices: int = 1,
                  slice_id: int = 0) -> Dict[str, str]:
    """The env dict of one rank of a gang-scheduled job, as the
    reference builds it.  For several slices, ``node_ips`` is the global
    slice-major host list and ``node_rank`` the global rank: every slice
    agrees on slice 0's head as the one coordinator."""
    if num_slices > 1 and len(node_ips) % num_slices != 0:
        raise ValueError(
            f'{len(node_ips)} hosts not divisible by {num_slices} slices; '
            'node_ips must be the global slice-major host list.')
    head_ip = node_ips[0]
    envs = {
        NODE_IPS: '\n'.join(node_ips),
        NUM_NODES: str(len(node_ips)),
        NODE_RANK: str(node_rank),
        NUM_CHIPS_PER_NODE: str(num_chips_per_node),
        COORDINATOR_ADDRESS: f'{head_ip}:{coordinator_port}',
        PROCESS_ID: str(node_rank),
        NUM_PROCESSES: str(len(node_ips)),
    }
    if task_id:
        envs[TASK_ID] = task_id
    if num_slices > 1:
        envs[MEGASCALE_COORDINATOR] = f'{head_ip}:{coordinator_port + 1}'
        envs[MEGASCALE_NUM_SLICES] = str(num_slices)
        envs[MEGASCALE_SLICE_ID] = str(slice_id)
    return envs


def process_grid(procs_per_host: int = 1,
                 local_rank: int = 0) -> Tuple[int, int]:
    """(rank, world) of this process from the contract: hosts numbered
    by SKYTPU_PROCESS_ID, procs_per_host processes each."""
    hosts = int(os.environ.get(NUM_PROCESSES, '1'))
    host = int(os.environ.get(PROCESS_ID, '0'))
    if not 0 <= local_rank < procs_per_host:
        raise ValueError(f'local_rank={local_rank} outside '
                         f'[0, {procs_per_host})')
    return host * procs_per_host + local_rank, hosts * procs_per_host


def initialize_from_env(timeout_s: Optional[int] = None,
                        backend: Optional[str] = None,
                        procs_per_host: int = 1,
                        local_rank: int = 0) -> Tuple[int, int]:
    """``torch.distributed.init_process_group`` from the contract: the
    coordinator address as the TCP rendezvous, the grid of
    process_grid.  A world of one process initialises nothing.  backend
    None: 'nccl' with a CUDA device, else 'gloo'.  Returns (rank,
    world)."""
    rank, world = process_grid(procs_per_host, local_rank)
    if world <= 1:
        return rank, world
    import torch
    import torch.distributed as dist
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    kwargs = {}
    if timeout_s is not None:
        kwargs['timeout'] = timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=f'tcp://{os.environ[COORDINATOR_ADDRESS]}',
        world_size=world, rank=rank, **kwargs)
    return rank, world
