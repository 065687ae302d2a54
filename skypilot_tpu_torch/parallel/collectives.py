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
- ``all_reduce_sum`` and ``pipelined_psum`` sum the partials locally
  in flat mesh-rank order (rank 0 first), in the tensor's dtype as
  XLA's psum does, the same order on every rank and for every chunk
  count, so a combine is deterministic and independent of the backend.

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

The training meshes add the collectives GSPMD inserts into a sharded
train step, as ``torch.autograd.Function``s with their transposes:
``gather_scatter`` (FSDP's weight gather; its gradient reduce-scattered
in rank order, each block sent once to its rank), Megatron's
``sum_forward`` ("g") and ``sum_backward`` ("f"), ``split_gather`` and
``ring_permute`` (ring attention's hop, one send and one receive).  The
pipeline (parallel/pipeline.py) adds ``permute`` (a stage hand-off, no
gradient) and ``broadcast`` (a rank's tensor, bytes as they are, on
every rank of a group).
Point-to-point transfers (``_send_recv``) are ``batch_isend_irecv``:
NCCL moves CUDA tensors itself; gloo has no send/recv on CUDA tensors,
so theirs cross through host copies, as gloo's own collectives on CUDA
tensors do.
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


def rank_order_sum(g) -> torch.Tensor:
    """sum over g's leading axis (a stack or a list), accumulated from
    index 0 up in g's dtype."""
    acc = g[0]
    for part in g[1:]:
        acc = acc + part
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


# ---- collectives with gradients (the training meshes) ---------------------
#
# GSPMD inserts the collectives of a sharded train step, and their
# transposes in the backward, by itself; here each is a
# ``torch.autograd.Function`` with its transpose written out.  Every sum
# runs in flat mesh-rank order (rank 0 first), so a replicated result
# holds the same bits on every rank.

_PIECE_BYTES = 64 << 20


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of x over `axes` in flat mesh-rank order, on every rank:
    a gather and a local ``rank_order_sum``, in pieces whose n copies
    stay under _PIECE_BYTES."""
    axes = _axis_tuple(axes)
    n = mesh.axis_size(axes) if mesh is not None else 1
    if n == 1:
        return x
    flat = x.reshape(-1)
    spans = chunk_bounds(flat.numel(), max(1, -(-n * x.numel()
                                              * x.element_size()
                                              // _PIECE_BYTES)))
    out = [rank_order_sum(all_gather(flat[lo:hi], mesh, axes))
           for lo, hi in spans]
    return (out[0] if len(out) == 1 else torch.cat(out)).reshape(x.shape)


def all_reduce_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of x over `axes` (no gradient)."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return all_gather(x, mesh, axes).amax(dim=0)


def _send_recv(pairs, mesh, axes) -> List[torch.Tensor]:
    """One ``batch_isend_irecv`` over the group of `axes`: for each
    (x, to, frm) of `pairs` x goes to global rank `to`, and a tensor
    like x comes back from global rank `frm`.  Under gloo a CUDA
    tensor crosses through a host copy (gloo has no send/recv on CUDA
    tensors)."""
    import torch.distributed as dist
    group = mesh.group(axes)
    ops, recvs = [], []
    for x, to, frm in pairs:
        host = mesh.backend == 'gloo' and x.device.type != 'cpu'
        send = x.contiguous().cpu() if host else x.contiguous()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, to, group),
                dist.P2POp(dist.irecv, recv, frm, group)]
        recvs.append(recv)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(x.device) for r, (x, _, _) in zip(recvs, pairs)]


def _exchange(chunks: List[torch.Tensor], mesh, axes) -> List[torch.Tensor]:
    """chunks[j] goes to rank j of the fiber over `axes`; returns what
    each rank p sent here, in fiber order (this rank's own chunk in its
    place): one send of each chunk to its rank."""
    fiber = mesh.fiber(axes)
    d = mesh.axis_index(axes)
    got = iter(_send_recv([(c, fiber[j], fiber[j])
                           for j, c in enumerate(chunks) if j != d],
                          mesh, axes))
    return [chunks[j] if j == d else next(got) for j in range(len(fiber))]


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0
                   ) -> torch.Tensor:
    """Rank d of the n over `axes` gets sum over ranks p of block d of
    x_p along `dim` (n equal blocks), summed in flat mesh-rank order.
    Each block travels once, to its rank (``_exchange``): (n - 1) / n of
    x's bytes a rank, where a gather of x would move n times them."""
    axes = _axis_tuple(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f'reduce_scatter: dimension {dim} of '
                         f'{tuple(x.shape)} does not divide over {n}')
    return rank_order_sum(_exchange(list(x.chunk(n, dim)), mesh, axes))


def gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of every rank over `axes` concatenated along `dim` in
    flat mesh-rank order (no gradient)."""
    if mesh.axis_size(axes) == 1:
        return x
    return torch.cat(tuple(all_gather(x, mesh, axes)), dim=dim)


class _GatherScatter(torch.autograd.Function):
    """FSDP's weight gather: all-gather along `dim` forward, the rank-
    order reduce-scatter of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_scatter(grad.contiguous(), ctx.mesh, ctx.axes,
                               ctx.dim), None, None, None)


class _SumForward(torch.autograd.Function):
    """Megatron's "g": the rank-order all-reduce forward, the identity
    backward (every rank holds the same gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _SumBackward(torch.autograd.Function):
    """Megatron's "f": the identity forward, the rank-order all-reduce
    of the gradient backward (each rank's gradient is a partial sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.mesh, ctx.axes), \
            None, None


class _SplitGather(torch.autograd.Function):
    """This rank's block of a replicated x along `dim` forward; the
    blocks' gradients gathered back along `dim` backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n = mesh.axis_size(axes)
        c = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(axes) * c, c).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return (gather_dim(grad.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None)


def gather_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """All-gather x along `dim` over `axes`; its gradient is reduce-
    scattered back (the FSDP gather of a weight)."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return _GatherScatter.apply(x, mesh, _axis_tuple(axes), dim)


def sum_forward(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Megatron's "g" over `axes` (after wo and w_down)."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return _SumForward.apply(x, mesh, _axis_tuple(axes))


def sum_backward(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Megatron's "f" over `axes` (before wq/wk/wv and w_gate/w_up)."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return _SumBackward.apply(x, mesh, _axis_tuple(axes))


def split_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of x along `dim` over `axes`, gradient gathered
    back to the whole."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return _SplitGather.apply(x, mesh, _axis_tuple(axes), dim)


def _permute(x: torch.Tensor, mesh, axis_name: str,
             shift: int) -> torch.Tensor:
    """Rank i's x lands on rank i + shift (mod n) along axis_name: one
    send and one receive a rank."""
    n = mesh.axis_size(axis_name)
    i = mesh.axis_index(axis_name)
    fiber = mesh.fiber(axis_name)
    (out,) = _send_recv([(x, fiber[(i + shift) % n],
                          fiber[(i - shift) % n])], mesh, axis_name)
    return out


class _RingPermute(torch.autograd.Function):
    """The ring's hop (rank i sends to i + 1) forward; the inverse hop
    of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return _permute(x, mesh, axis_name, 1)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, ctx.mesh, ctx.axis_name, -1), None, None


def ring_permute(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """``lax.ppermute`` over the forward ring of axis_name (rank i's x
    goes to rank i + 1 mod n), with its transpose as the gradient."""
    if mesh.axis_size(axis_name) == 1:
        return x
    return _RingPermute.apply(x, mesh, axis_name)


def permute(x: torch.Tensor, mesh, axis_name: str,
            shift: int) -> torch.Tensor:
    """Rank i's x lands on rank i + shift (mod n) along axis_name (no
    gradient): the pipeline's stage hand-off."""
    if mesh.axis_size(axis_name) == 1:
        return x
    return _permute(x, mesh, axis_name, shift)


def broadcast(x: torch.Tensor, mesh, axes, index: int) -> torch.Tensor:
    """The x of rank `index` of the fiber over `axes`, on every rank of
    it (x gives the shape and dtype elsewhere; no gradient).  The bytes
    travel as a uint8 view, so every dtype arrives bitwise."""
    import torch.distributed as dist
    if mesh.axis_size(axes) == 1:
        return x
    src = x.contiguous()
    raw = src.reshape(-1).view(torch.uint8)
    if mesh.axis_index(axes) != index:
        raw = torch.empty_like(raw)
    dist.broadcast(raw, src=mesh.fiber(axes)[index], group=mesh.group(axes))
    return raw.view(x.dtype).reshape(x.shape)

