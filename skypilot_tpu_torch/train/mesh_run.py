"""Rank processes of the training entry points.

A training mesh runs one process a rank (parallel/mesh.py).  On one host
:func:`launch` starts them with ``multihost.launch_local_ranks`` (the env
contract of one host of `world` ranks, a coordinator on a free local
port); in a gang whose env contract (utils/env_contract.py) names one
process a host, this process is the rank.  :func:`join` puts a rank on
its device (``multihost.rank_device``: the card ``local_rank`` mod the
host's cards, or the CPU when asked) and into the process group: NCCL
when every rank has a card of its own, gloo otherwise (ranks sharing a
card check the path's semantics, not a multi-card rate).  Every group
has a timeout, so a rank that stops turns into a failure, not a hang.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from skypilot_tpu_torch.utils import env_contract

TIMEOUT_S = 900


def cards(device: Optional[str]) -> int:
    """The devices a mesh of this host spreads over when no axis is
    given: the host's cards, or 1 on the CPU."""
    if device == 'cpu' or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


def launch(world: int, target: Callable, argd: dict) -> None:
    """target(local_rank, procs_per_host, argd) on each of `world` ranks:
    spawned on this host, or this process when the gang's env contract
    runs one process a host for `world` hosts."""
    from skypilot_tpu_torch.infer import multihost
    hosts = int(os.environ.get(env_contract.NUM_PROCESSES, '1'))
    if hosts > 1:
        if hosts != world:
            raise SystemExit(f'the env contract names {hosts} processes; '
                             f'this mesh needs {world} (one a rank)')
        target(0, 1, argd)
        return
    multihost.launch_local_ranks(world, target, (argd,))


def run_on_mesh(args, run: Callable, mesh_config) -> None:
    """run(args, device, mesh) in this process on one device when
    `mesh_config` (a parallel.mesh.MeshConfig) holds one, else on each
    of its ranks (:func:`launch`), each joined to the group and given
    its device and the mesh."""
    import dataclasses
    from skypilot_tpu_torch.device import resolve_device
    if mesh_config.num_devices == 1:
        run(args, resolve_device(args.device), None)
        return
    launch(mesh_config.num_devices, _run_rank, dict(
        vars(args), mesh=dataclasses.asdict(mesh_config), run=run))


def _run_rank(local_rank: int, procs_per_host: int, argd: dict) -> None:
    import argparse
    import sys
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    argd = dict(argd)
    mesh_kw, run = argd.pop('mesh'), argd.pop('run')
    args = argparse.Namespace(**argd)
    sys.stdout.reconfigure(line_buffering=True)
    device, _ = join(args.device, local_rank, procs_per_host)
    try:
        run(args, device, mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw)))
    finally:
        leave()


def join(device: Optional[str], local_rank: int,
         procs_per_host: int) -> Tuple[torch.device, dict]:
    """This rank's device and its place in the process group
    (``multihost.initialize_from_env``'s dict: rank, world, ...)."""
    from skypilot_tpu_torch.infer import multihost
    hosts = int(os.environ.get(env_contract.NUM_PROCESSES, '1'))
    world = hosts * procs_per_host
    where = multihost.rank_device(device, local_rank)
    if where.startswith('cuda'):
        torch.cuda.set_device(where)
    info = multihost.initialize_from_env(
        timeout_s=TIMEOUT_S,
        backend=multihost.default_backend(device, world),
        procs_per_host=procs_per_host, local_rank=local_rank)
    return torch.device(where), info


def leave() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def lead_print(mesh):
    """print on rank 0 (and without a mesh); nothing elsewhere."""
    if mesh is None or mesh.rank == 0:
        return print
    return lambda *a, **k: None


def describe(mesh) -> str:
    """The mesh as the reference prints its MeshConfig:
    'mesh(fsdp=2, tp=2)'."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    return str(mesh_lib.MeshConfig(**dict(mesh.shape)))
