"""Device meshes as process groups.

Counterpart of skypilot_tpu/parallel/mesh.py.  The JAX package lays its
devices out as a ``jax.sharding.Mesh`` under one controller and lets
GSPMD insert the collectives.  The port runs ONE PROCESS A RANK under
``torch.distributed``: a :class:`Mesh` is the layout of the world's
ranks over named axes (outermost first, as the reference's
``('pp', 'dp', 'fsdp', 'ep', 'sp', 'tp')``), this rank's coordinates in
it, and one process group for every set of axes a collective runs
over, each created collectively, in the same order, on every rank.

``AXES``, ``MeshConfig``, ``device_coords``, ``ici_order`` and
``auto_mesh_config`` are the reference's pure functions, copied.
``ici_order`` keeps its meaning for any objects that carry ``coords``;
ranks carry none, so a mesh of ranks keeps their enumeration order
(NVLink within a host is all to all, and has no torus to walk).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

AXES: Tuple[str, ...] = ('pp', 'dp', 'fsdp', 'ep', 'sp', 'tp')


def device_coords(dev) -> Optional[Tuple[int, ...]]:
    """Torus coordinates of a device, or None for one that has none."""
    coords = getattr(dev, 'coords', None)
    if coords is None:
        return None
    try:
        return tuple(int(c) for c in coords)
    except (TypeError, ValueError):
        return None


def ici_order(devices: Sequence) -> list:
    """`devices` sorted along a serpentine walk of their torus
    coordinates, so consecutive ranks are neighbours; devices without
    coordinates, or with duplicate ones, come back unchanged (the
    reorder is a locality optimisation, never a correctness need)."""
    coords = [device_coords(d) for d in devices]
    # The core index breaks ties between the cores of one chip.
    ids = [None if c is None
           else c + (getattr(d, 'core_on_chip', 0),)
           for c, d in zip(coords, devices)]
    if (not ids or any(i is None for i in ids)
            or len(set(ids)) != len(ids)):
        return list(devices)
    ndim = max(len(c) for c in coords)
    coords = [c + (0,) * (ndim - len(c)) for c in coords]
    maxes = [max(c[i] for c in coords) for i in range(ndim)]

    def snake_key(idx: int):
        c = coords[idx]
        # Outermost axis last in coords; each inner axis reverses
        # whenever the walk index over the outer axes is odd.
        key = []
        walk = 0
        for i in reversed(range(ndim)):
            v = c[i] if walk % 2 == 0 else maxes[i] - c[i]
            key.append(v)
            walk = walk * (maxes[i] + 1) + v
        key.append(getattr(devices[idx], 'core_on_chip', 0))
        return tuple(key)

    order = sorted(range(len(devices)), key=snake_key)
    return [devices[i] for i in order]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def num_devices(self) -> int:
        return (self.pp * self.dp * self.fsdp * self.ep * self.sp *
                self.tp)

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.pp, self.dp, self.fsdp, self.ep, self.sp, self.tp)

    def __str__(self) -> str:
        return ('mesh(' + ', '.join(
            f'{a}={s}' for a, s in zip(AXES, self.axis_sizes()) if s > 1)
            + ')') if self.num_devices > 1 else 'mesh(single-device)'


class Mesh:
    """The world's ranks laid out over named axes.

    ranks: an integer array of the mesh's shape holding global ranks
    (the reference's ``mesh.devices``); axis_names: one name an axis.
    rank: this process's global rank (default: ``dist.get_rank()``, or
    0 without a process group).  A mesh of one rank needs no process
    group.  With ``torch.distributed`` initialised, the constructor
    creates a group for every non-empty set of axes of size > 1, on
    every rank in the same order (``dist.new_group`` is collective);
    ``group(axes)`` returns the one holding this rank."""

    def __init__(self, ranks, axis_names: Sequence[str],
                 rank: Optional[int] = None, backend: Optional[str] = None):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f'{self.devices.ndim}-d ranks for axes '
                             f'{self.axis_names}')
        if sorted(self.devices.ravel().tolist()) != list(
                range(self.devices.size)):
            raise ValueError('a mesh holds each rank of its world once')
        import torch.distributed as dist
        live = dist.is_available() and dist.is_initialized()
        if rank is None:
            rank = dist.get_rank() if live else 0
        self.rank = int(rank)
        where = np.argwhere(self.devices == self.rank)
        if len(where) != 1:
            raise ValueError(f'rank {self.rank} is not in the mesh')
        self.coords = tuple(int(c) for c in where[0])
        self.backend = backend or (dist.get_backend() if live else None)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._fibers: Dict[Tuple[str, ...], list] = {}
        sized = [a for a in self.axis_names if self.shape[a] > 1]
        if self.devices.size > 1 and not live:
            raise RuntimeError(
                f'a mesh of {self.devices.size} ranks needs '
                f'torch.distributed initialised (init_process_group)')
        for n in range(1, len(sized) + 1):
            for axes in itertools.combinations(sized, n):
                self._make_groups(axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's flat index over `axes` (major to minor): its slot
        in a gather over them, the reference's ``lax.axis_index``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        index = 0
        for a in axes:
            if a in self.axis_names:
                i = self.axis_names.index(a)
                index = index * self.devices.shape[i] + self.coords[i]
        return index

    def fiber(self, axes) -> list:
        """Global ranks of this rank's group over `axes`, in flat mesh
        order over those axes (the order a gather stacks them in)."""
        axes = self._key(axes)
        if not axes:
            return [self.rank]
        return self._fibers[axes]

    def group(self, axes):
        """The process group over `axes` that holds this rank, or None
        when the axes have size 1 (no collective is needed)."""
        axes = self._key(axes)
        if not axes:
            return None
        return self._groups[axes]

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f'axis {a!r} not in {self.axis_names}')
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def _make_groups(self, axes: Tuple[str, ...]) -> None:
        import torch.distributed as dist
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        # Move the group's axes last: each row of `arr` is one fiber,
        # its ranks in flat order over those axes.
        arr = np.transpose(self.devices, rest + idx).reshape(
            -1, math.prod(self.devices.shape[i] for i in idx))
        for fiber in arr.tolist():
            group = dist.new_group(ranks=fiber, backend=self.backend)
            if self.rank in fiber:
                self._groups[axes] = group
                self._fibers[axes] = fiber

    def __repr__(self) -> str:
        dims = ', '.join(f'{a}={s}' for a, s in self.shape.items())
        return f'Mesh({dims}; rank {self.rank} at {self.coords})'


def make_mesh(config: MeshConfig, ranks: Optional[Sequence[int]] = None,
              rank: Optional[int] = None) -> Mesh:
    """A mesh with the canonical axis names over `ranks` (default: the
    world's ranks in order)."""
    if ranks is None:
        ranks = list(range(config.num_devices))
    if config.num_devices != len(ranks):
        raise ValueError(
            f'{config} needs {config.num_devices} devices, have '
            f'{len(ranks)}.')
    arr = np.asarray(ranks).reshape(config.axis_sizes())
    return Mesh(arr, AXES, rank=rank)


def make_multislice_mesh(config: MeshConfig, num_slices: int,
                         ranks: Optional[Sequence[int]] = None,
                         rank: Optional[int] = None) -> Mesh:
    """The hybrid mesh of a job over several slices (here: hosts): the
    dp axis spans the slices, slice-major, and every other axis stays
    inside one.  Slice s holds the contiguous block of ranks
    [s * per_slice, (s + 1) * per_slice).  Needs config.dp % num_slices
    == 0."""
    if num_slices <= 1:
        return make_mesh(config, ranks, rank)
    if ranks is None:
        ranks = list(range(config.num_devices))
    if config.num_devices != len(ranks):
        raise ValueError(f'{config} needs {config.num_devices} devices, '
                         f'have {len(ranks)}.')
    if config.dp % num_slices:
        raise ValueError(
            f'dp={config.dp} not divisible by num_slices={num_slices}: '
            f'the DCN boundary rides the dp axis (put the cross-slice '
            f'factor in dp; fsdp/tp/sp must stay inside a slice).')
    per_slice = len(ranks) // num_slices
    dp_inner = config.dp // num_slices
    ici_shape = (config.pp, dp_inner, config.fsdp, config.ep,
                 config.sp, config.tp)
    blocks = [np.asarray(ranks[s * per_slice:(s + 1) * per_slice]
                         ).reshape(ici_shape) for s in range(num_slices)]
    return Mesh(np.concatenate(blocks, axis=1), AXES, rank=rank)


def auto_mesh_config(num_devices: int,
                     model_params_b: float = 8.0,
                     seq_len: int = 8192,
                     num_slices: int = 1) -> MeshConfig:
    """The reference's heuristic mesh for a device count and model
    scale: tp for models of 30B and up (8 from 100B), sp for contexts
    over 32k, fsdp until the parameters fit, the rest dp; with several
    slices, fsdp moves into dp until dp % num_slices == 0."""
    remaining = num_devices
    tp = 1
    if model_params_b >= 30:
        tp = min(4, remaining)
    if model_params_b >= 100:
        tp = min(8, remaining)
    remaining //= tp
    sp = 1
    if seq_len > 32768 and remaining >= 4:
        sp = 4
        remaining //= sp
    want_fsdp = max(1, int(2 ** math.ceil(math.log2(
        max(1.0, model_params_b * 12 / 12.0)))))
    fsdp = 1
    while fsdp * 2 <= min(remaining, want_fsdp):
        fsdp *= 2
    remaining //= fsdp
    dp = remaining
    while num_slices > 1 and dp % num_slices and fsdp > 1:
        fsdp //= 2
        dp *= 2
    if num_slices > 1 and dp % num_slices:
        raise ValueError(
            f'Cannot place {num_slices} slices on the dp axis for '
            f'{num_devices} devices (dp={dp}); pass an explicit mesh '
            f'(e.g. --dp {num_slices}).')
    return MeshConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp)
