"""Collectives of the port's meshes on ``torch.distributed``.

Counterpart of skypilot_tpu/parallel/collectives.py.  The reference
builds ``ring_all_gather``, ``ring_reduce_scatter`` and
``pipelined_psum`` from ``lax.ppermute`` hops inside ``shard_map``
regions.  The port has no ``shard_map`` shim, and needs none: each rank
is its own process, so every function here is already "inside the
region".  The functions keep the reference's CONTRACTS, bit for bit:

- a gather stacks the shards in flat mesh-rank order over its axes;
- ``ring_reduce_scatter`` sums rank d's chunk in the ring's arrival
  order d+1, d+2, ..., d;
- ``_rank_order_allreduce`` and ``pipelined_psum`` sum the partials
  locally in flat mesh-rank order (rank 0 first), the same order on
  every rank and for every chunk count, so a combine is deterministic
  and independent of the backend.

How a gather moves bytes: ``all_gather_into_tensor`` on the tensor's
bytes (a uint8 view, so every dtype travels exactly), then the rows put
in flat mesh-rank order (a group numbers its ranks in sorted order).
NCCL runs it natively; gloo runs it on CPU and CUDA tensors alike
(``scripts/torch_gloo_probe.py`` on the card's torch 2.11: all_reduce,
broadcast, all_gather, all_gather_into_tensor and reduce_scatter_tensor
run on CUDA tensors, send/recv does not), so the CPU tests run the path
the card runs.  Under gloo the bytes of a CUDA tensor cross the host: a
gloo mesh checks semantics, it is not a fast path.

Every function takes the mesh and the axes it runs over; axes of size 1
need no collective.  ``psum_bench`` and ``all_gather_bench`` time the
backend's own all-reduce and this module's gather.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

AxisNames = Union[str, Sequence[str]]


def _axis_tuple(axis_name: AxisNames) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _ring_perm(n: int) -> List[Tuple[int, int]]:
    """The forward ring over mesh-rank order: rank i sends to i+1 mod n."""
    return [(i, (i + 1) % n) for i in range(n)]


class _Pending:
    """A gather in flight: wait() returns the (n, *shape) stack."""

    def __init__(self, work, buf, dtype, shape, order=None):
        self._work, self._buf = work, buf
        self._dtype, self._shape, self._order = dtype, shape, order

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        buf = self._buf
        if self._order is not None:
            buf = buf[self._order]
        n = buf.shape[0]
        return buf.view(torch.uint8).view(self._dtype).reshape(
            (n,) + tuple(self._shape))


def _start_gather(x: torch.Tensor, mesh, axes, async_op: bool = True
                  ) -> _Pending:
    import torch.distributed as dist
    axes = _axis_tuple(axes)
    n = mesh.axis_size(axes)
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    if n == 1:
        return _Pending(None, raw[None], x.dtype, x.shape)
    out = torch.empty((n * raw.numel(),), dtype=torch.uint8,
                      device=x.device)
    work = dist.all_gather_into_tensor(out, raw, group=mesh.group(axes),
                                       async_op=async_op)
    out = out.view(n, raw.numel())
    # Group ranks are the fiber's global ranks sorted; row j of the
    # result must be the fiber's j-th rank.
    fiber = mesh.fiber(axes)
    ranked = sorted(fiber)
    order = [ranked.index(r) for r in fiber]
    return _Pending(work if async_op else None, out, x.dtype, x.shape,
                    order if order != list(range(n)) else None)


def all_gather(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """(n, *x.shape): every rank's x over `axes`, stacked in flat
    mesh-rank order (``lax.all_gather``'s contract)."""
    return _start_gather(x, mesh, axes, async_op=False).wait()


def ring_all_gather(x: torch.Tensor, mesh, axis_name: AxisNames, *,
                    tiled: bool = False) -> torch.Tensor:
    """The reference's ring all-gather contract: the shards stacked on
    a new leading axis in mesh-rank order, or concatenated along x's
    leading axis with tiled=True.  The hops are the backend's."""
    g = all_gather(x, mesh, axis_name)
    return g.reshape((-1,) + tuple(x.shape[1:])) if tiled else g


def rank_order_sum(g: torch.Tensor) -> torch.Tensor:
    """sum over g's leading axis, accumulated from index 0 up."""
    acc = g[0]
    for j in range(1, g.shape[0]):
        acc = acc + g[j]
    return acc


def ring_reduce_scatter(x: torch.Tensor, mesh,
                        axis_name: AxisNames) -> torch.Tensor:
    """x (n * c, ...) on every rank; rank d returns the sum over ranks p
    of x_p[d * c:(d + 1) * c] (``psum_scatter``'s tiled contract),
    accumulated in the ring's arrival order d+1, d+2, ..., d, as the
    reference's ring computes it."""
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(
            f'ring_reduce_scatter: leading axis {x.shape[0]} not '
            f'divisible by axis size {n}')
    c = x.shape[0] // n
    d = mesh.axis_index(axis_name)
    chunks = all_gather(x, mesh, axis_name)[:, d * c:(d + 1) * c]
    acc = chunks[(d + 1) % n]
    for t in range(2, n + 1):
        acc = acc + chunks[(d + t) % n]
    return acc


def _rank_order_allreduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """All-reduce as a gather and a local sum in flat mesh-rank order:
    the same order on every rank and for every chunking."""
    axes = _axis_tuple(axes)
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return rank_order_sum(all_gather(x, mesh, axes))


def chunk_bounds(dim: int, chunks: int) -> List[Tuple[int, int]]:
    """[0, dim) in `chunks` contiguous spans, the first dim % chunks one
    element longer (numpy's array_split)."""
    chunks = max(1, min(chunks, dim))
    base, extra = divmod(dim, chunks)
    bounds, lo = [], 0
    for c in range(chunks):
        hi = lo + base + (1 if c < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def pipelined_psum(x: torch.Tensor, mesh, axis_name: AxisNames,
                   chunks: int = 1, on_chunk: Optional[Callable] = None):
    """Chunked deterministic all-reduce of x's last axis over `axis_name`.

    The spans (chunk_bounds(x.shape[-1], chunks)) are gathered one after
    another and each summed locally in flat mesh-rank order, so the
    result is bitwise the same for any chunk count.  Span c+1's gather
    is issued (``async_op``) before span c is waited on, so its transfer
    runs while on_chunk(c, lo, span) computes with span c's sum.
    Returns (reduced x, [on_chunk results] or None)."""
    axes = _axis_tuple(axis_name)
    bounds = chunk_bounds(x.shape[-1], chunks)
    n = mesh.axis_size(axes) if mesh is not None else 1

    def start(ci):
        lo, hi = bounds[ci]
        return _start_gather(x[..., lo:hi], mesh, axes) if n > 1 else \
            x[..., lo:hi]

    outs, results = [], []
    pending = start(0)
    for ci, (lo, _) in enumerate(bounds):
        nxt = start(ci + 1) if ci + 1 < len(bounds) else None
        red = rank_order_sum(pending.wait()) if n > 1 else pending
        outs.append(red)
        if on_chunk is not None:
            results.append(on_chunk(ci, lo, red))
        pending = nxt
    red = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return red, (results if on_chunk is not None else None)


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def psum_bench(mesh, axis_name: str = 'dp', payload_mb: float = 128.0,
               iters: int = 10, warmup: int = 3,
               device=None) -> Dict[str, float]:
    """The backend's own all-reduce of a payload over `axis_name`:
    algbw and busbw = algbw x 2(n-1)/n in GB/s, as nccl-tests report."""
    import torch.distributed as dist
    device = torch.device(device or 'cpu')
    n = mesh.axis_size(axis_name)
    num_elems = int(payload_mb * 1024 * 1024 / 4)
    x = torch.ones((num_elems,), dtype=torch.float32, device=device)
    group = mesh.group(axis_name)
    for _ in range(warmup):
        dist.all_reduce(x, group=group)
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(x, group=group)
    _sync(device)
    elapsed = (time.perf_counter() - start) / iters
    algbw = num_elems * 4 / elapsed / 1e9
    return {'payload_mb': payload_mb, 'ranks': n, 'time_s': elapsed,
            'algbw_gbps': algbw, 'busbw_gbps': algbw * 2 * (n - 1) / n}


def all_gather_bench(mesh, axis_name: str = 'fsdp',
                     payload_mb: float = 128.0, iters: int = 10,
                     warmup: int = 3, device=None) -> Dict[str, float]:
    """This module's exact gather of payload_mb in all (each rank
    contributes 1/n of it) over `axis_name`."""
    device = torch.device(device or 'cpu')
    n = mesh.axis_size(axis_name)
    num_elems = int(payload_mb * 1024 * 1024 / 4)
    x = torch.ones((num_elems // n,), dtype=torch.float32, device=device)
    for _ in range(warmup):
        all_gather(x, mesh, axis_name)
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        all_gather(x, mesh, axis_name)
    _sync(device)
    elapsed = (time.perf_counter() - start) / iters
    algbw = num_elems * 4 / elapsed / 1e9
    return {'payload_mb': payload_mb, 'ranks': n, 'time_s': elapsed,
            'algbw_gbps': algbw, 'busbw_gbps': algbw * (n - 1) / n}
