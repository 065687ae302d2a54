"""RMSNorm: hand-written CUDA kernel (csrc/rmsnorm.cu) and its plain
PyTorch version.

Counterpart of skypilot_tpu/ops/rmsnorm.py.  The kernel replaces the TPU's
``_rmsnorm_pallas`` (body ``_rmsnorm_kernel``); it is bound by bytes on
the H100 (one read of x and w, one write of y), see the source note.
:func:`_norm_launch` decides each launch's configuration from the shapes
alone.
When a gradient is wanted :func:`rms_norm` is an autograd Function, the
counterpart of ``_rms_norm_pallas_diff``: the kernel forward and the JAX
package's f32 recompute backward in plain torch (the TPU had no backward
kernel either).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from skypilot_tpu_torch.ops import _kernels

# The kernel's compile-time vectors (16 bytes each) a thread, and the most
# a thread may hold at each block size (csrc/rmsnorm.cu, rms_max_threads:
# x's and w's vectors stay in registers).  A row longer than 4 vectors a
# thread at 1,024 threads takes the kernel's loop (0 vectors).
_NORM_VECS = (1, 2, 3, 4, 6, 8, 12, 16)
_NORM_MAX_VECS = {256: 16, 512: 12, 1024: 4}
_NORM_MIN_BLOCK = 256
_NORM_MAX_THREADS = 1024
# Blocks an SM at most: past that, a block walks more rows with the w it
# loaded once.
_NORM_BLOCKS_PER_SM = 4


def _rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Mirror of the JAX ``_rms_norm_xla``: f32 math, cast back to x's
    dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _norm_launch(rows: int, d: int, elem_size: int,
                 sms: int) -> Tuple[int, int, int]:
    """(threads a row, vectors a thread, blocks) of a K3 launch over
    (rows, d) elements of `elem_size` bytes on `sms` SMs.

    A pure function of the shapes, the dtype's size and the SM count, so
    one decision holds for every replay of a captured graph.  Takes the
    fewest threads a row (from a warp, in powers of two) whose vectors of
    the row fit the registers; then, while the rows make fewer blocks
    than SMs, doubles the threads a row (never past one vector a thread),
    so that a few rows spread over more SMs.  A block has max(threads a
    row, 256) threads; the grid is capped at _NORM_BLOCKS_PER_SM blocks an
    SM, and a block walks the rest."""
    if rows < 1:
        raise ValueError(f'rms_norm: {rows} rows')
    if d < 8 or d % 8:
        raise ValueError(f'rms_norm: d={d} is not a multiple of 8')
    nvec = d * elem_size // 16

    def vecs(tpr):
        """The fewest compile-time vectors a thread that cover the row and
        fit the registers at tpr threads a row, or None."""
        need = -(-nvec // tpr)
        cap = _NORM_MAX_VECS[max(tpr, _NORM_MIN_BLOCK)]
        return next((v for v in _NORM_VECS if need <= v <= cap), None)

    def blocks(tpr):
        return -(-rows // (max(tpr, _NORM_MIN_BLOCK) // tpr))

    cap = _NORM_BLOCKS_PER_SM * sms
    tpr = 32
    while vecs(tpr) is None and tpr < _NORM_MAX_THREADS:
        tpr *= 2
    if vecs(tpr) is None:
        return _NORM_MAX_THREADS, 0, min(rows, cap)
    while (2 * tpr <= min(nvec, _NORM_MAX_THREADS) and blocks(tpr) < sms
           and vecs(2 * tpr) is not None):
        tpr *= 2
    return tpr, vecs(tpr), min(blocks(tpr), cap)


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    d = x.shape[-1]
    code = _kernels.dtype_code(x, 'rms_norm')
    _kernels.check(weight.device == x.device and weight.dtype == x.dtype,
                   'rms_norm: weight must match x in device and dtype')
    _kernels.check(weight.shape == (d,), f'rms_norm: weight shape '
                   f'{tuple(weight.shape)} != ({d},)')
    _kernels.check(d % 8 == 0, f'rms_norm: d={d} is not a multiple of 8')
    _kernels.check(x.is_contiguous() and weight.is_contiguous()
                   and _kernels.aligned(x) and _kernels.aligned(weight),
                   'rms_norm: x and weight must be contiguous and '
                   '16-byte aligned')
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        tpr, nv, grid = _norm_launch(rows, d, x.element_size(),
                                     _kernels.sm_count(x.device))
        _kernels.launch('skk_rmsnorm', x.device, x.data_ptr(),
                        weight.data_ptr(), y.data_ptr(), rows, d,
                        float(eps), code, tpr, nv, grid)
        rms_norm.launches += 1
    return y


def _rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror of the JAX ``_rms_norm_bwd``: recompute in f32, then
    (dx in x's dtype, dw in weight's dtype)."""
    xf, gf, wf = x.float(), g.float(), weight.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    dw = torch.sum(gf * xhat, dim=tuple(range(x.ndim - 1)))
    gw = gf * wf
    dx = rstd * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dw.to(weight.dtype)


def _rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    if x.device.type == 'cpu':
        return _rms_norm_plain(x, weight, eps)
    return _rms_norm_cuda(x, weight, eps)


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _rms_norm_fwd(x, weight, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _rms_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * weight over the last dim.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    which raises on a dtype, shape or layout it does not take.  When a
    gradient is wanted this is an autograd Function with the f32
    recompute backward."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return _rms_norm_fwd(x, weight, eps)


_kernels.counter(rms_norm, 'launches')
