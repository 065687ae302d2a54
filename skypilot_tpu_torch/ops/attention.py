"""Prefill attention: hand-written causal flash-forward kernel
(csrc/flash_fwd.cu) and its plain PyTorch version.

Counterpart of skypilot_tpu/ops/attention.py.  The kernel replaces the
TPU's ``_flash_fwd`` (body ``_flash_fwd_kernel``) without the lse output,
which only training needs; the backward kernels come with training.
"""
from __future__ import annotations

import ctypes

import torch

from skypilot_tpu_torch.ops import _kernels

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128, 256)


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    """Mirror of the JAX ``reference_attention`` (what the JAX prefill
    runs off the TPU).  Layout (B, S, H, D); GQA-aware: scores in q's
    dtype then f32, softmax in f32, probabilities cast to q's dtype."""
    seq_len, num_heads, head_dim = q.shape[1], q.shape[2], q.shape[3]
    num_kv = k.shape[2]
    if num_kv != num_heads:
        k = torch.repeat_interleave(k, num_heads // num_kv, dim=2)
        v = torch.repeat_interleave(v, num_heads // num_kv, dim=2)
    scale = head_dim ** -0.5
    s = torch.einsum('bqhd,bkhd->bhqk', q, k).float() * scale
    if causal:
        mask = torch.tril(torch.ones(seq_len, seq_len, dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p, v)


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool) -> torch.Tensor:
    batch, seq_len, heads, head_dim = q.shape
    kv_heads = k.shape[2]
    code = _kernels.dtype_code(q, 'flash_attention')
    _kernels.check(k.dtype == q.dtype and v.dtype == q.dtype
                   and k.device == q.device and v.device == q.device,
                   'flash_attention: q, k, v must share dtype and device')
    _kernels.check(k.shape == (batch, seq_len, kv_heads, head_dim)
                   and v.shape == k.shape,
                   f'flash_attention: k/v shape {tuple(k.shape)} does not '
                   f'fit q {tuple(q.shape)}')
    _kernels.check(head_dim in _HEAD_DIMS, f'flash_attention: head_dim '
                   f'{head_dim} not in {_HEAD_DIMS}')
    _kernels.check(heads % kv_heads == 0, f'flash_attention: {heads} '
                   f'heads not a multiple of {kv_heads} KV heads')
    vec = 16 // q.element_size()
    for name, t in (('q', q), ('k', k), ('v', v)):
        _kernels.check(t.stride(3) == 1 and _kernels.aligned(t)
                       and all(s % vec == 0 for s in t.stride()[:3]),
                       f'flash_attention: {name} needs a contiguous last '
                       f'dim, 16-byte aligned rows and base')
    o = torch.empty((batch, seq_len, heads, head_dim), dtype=q.dtype,
                    device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    strides_arr = (ctypes.c_longlong * 12)(*strides)
    _kernels.launch('skk_flash_fwd', q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), batch, seq_len, heads,
                    kv_heads, head_dim, int(bool(causal)),
                    float(head_dim ** -0.5), strides_arr, code)
    flash_attention.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Multi-head attention, layout (batch, seq, heads, head_dim), GQA
    through the h // (H / KV) head map.

    A CPU tensor takes the plain version; a CUDA tensor takes the flash
    kernel, which raises on a dtype, shape or layout it does not take."""
    if q.ndim != 4:
        raise ValueError(f'Expected (B, S, H, D), got {tuple(q.shape)}')
    if q.device.type == 'cpu':
        return _attention_plain(q, k, v, causal=causal)
    return _flash_attention_cuda(q, k, v, causal)


flash_attention.launches = 0
