"""Prefill and training attention: hand-written flash kernels
(csrc/flash_fwd.cu, csrc/flash_bwd.cu) and their plain PyTorch versions.

Counterpart of skypilot_tpu/ops/attention.py.  Three kernels replace the
TPU's pallas_calls: the forward ``_flash_fwd`` (K2, which writes the row
logsumexp only when a gradient is wanted) and the two of ``_flash_bwd``
(K5: dq; K6: dk and dv).  In bf16 all three run on the tensor cores at
every head_dim (64, 128, 256); f32 runs on f32 FMAs.
:func:`flash_attention` is a
``torch.autograd.Function`` when a gradient is wanted, the counterpart of
``_flash_attention_vjp``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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


def _heads_f32(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) f32, each KV head repeated over its
    group (bf16 -> f32 is exact, so products of these are the kernels'
    input-dtype products accumulated in f32)."""
    t = t.float()
    if t.shape[2] != num_heads:
        t = torch.repeat_interleave(t, num_heads // t.shape[2], dim=2)
    return t


def _scores_f32(q: torch.Tensor, k: torch.Tensor,
                causal: bool) -> torch.Tensor:
    """scale * q k^T (B, H, S, S) in f32, masked to -1e30 (causal)."""
    seq_len, num_heads, head_dim = q.shape[1], q.shape[2], q.shape[3]
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(),
                     _heads_f32(k, num_heads)) * head_dim ** -0.5
    if causal:
        mask = torch.tril(torch.ones(seq_len, seq_len, dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, _NEG_INF)
    return s


def _attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Row logsumexp (B, H, S) f32 of the scaled, masked scores with f32
    products: what K2 writes for the backward."""
    return torch.logsumexp(_scores_f32(q, k, causal), dim=-1)


def _flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's own numerics, as the JAX ``_flash_fwd`` kernel computes them:
    scores and the softmax in f32, p = exp(s - m) rounded to v's dtype
    before P.V, P.V summed in f32 and divided by the f32 row sum l.
    Returns (o (B, S, H, D) in q's dtype, lse = m + log l (B, H, S) f32).
    The kernels round p against the running max of their k-tile, this
    version against the row's final max: the same p up to one rounding
    each."""
    s = _scores_f32(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    p_lo = p.to(v.dtype).float()
    o = torch.einsum('bhqk,bkhd->bhqd', p_lo, _heads_f32(v, q.shape[2])) / l
    return o.transpose(1, 2).to(q.dtype), (m + torch.log(l))[..., 0]


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(o * do) in f32, (B, H, S): the backward's softmax term,
    computed outside the kernels as the JAX ``_flash_bwd`` does."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2)


def _bwd_probs_plain(q, k, v, do, lse, delta, causal):
    """p = exp(s - lse) in f32 and ds = p (dp - delta) rounded to q's
    dtype, (B, H, S, S) each."""
    s = _scores_f32(q, k, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum('bqhd,bkhd->bhqk', do.float(),
                      _heads_f32(v, q.shape[2]))
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return p, ds


def _group_sum(t: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, S, H, D) per-query-head partials -> (B, S, KV, D), summed over
    each KV head's group in f32."""
    batch, seq_len, num_heads, head_dim = t.shape
    return t.reshape(batch, seq_len, num_kv, num_heads // num_kv,
                     head_dim).sum(3)


def _flash_attention_dq_plain(q, k, v, do, lse, delta, causal=True):
    """K5's plain version: dq = scale * ds k, f32 sums."""
    _, ds = _bwd_probs_plain(q, k, v, do, lse, delta, causal)
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, _heads_f32(k, q.shape[2]))
    return (dq * q.shape[3] ** -0.5).to(q.dtype)


def _flash_attention_dkv_plain(q, k, v, do, lse, delta, causal=True):
    """K6's plain version: dk = scale * ds^T q and dv = p^T do (p rounded
    to q's dtype), f32 sums over the rows and the GQA group."""
    p, ds = _bwd_probs_plain(q, k, v, do, lse, delta, causal)
    p_lo = p.to(q.dtype).float()
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q.float()) * q.shape[3] ** -0.5
    dv = torch.einsum('bhqk,bqhd->bkhd', p_lo, do.float())
    num_kv = k.shape[2]
    return (_group_sum(dk, num_kv).to(k.dtype),
            _group_sum(dv, num_kv).to(v.dtype))


def _flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True):
    """The backward's plain version, from the saved lse as the kernels
    take it: the JAX ``_flash_bwd`` math (its XLA twin is
    ``_xla_attention_bwd``).  Returns (dq, dk, dv)."""
    delta = _delta(o, do)
    dq = _flash_attention_dq_plain(q, k, v, do, lse, delta, causal)
    dk, dv = _flash_attention_dkv_plain(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def _check_qkv(kernel: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, *more: torch.Tensor) -> int:
    """Dtype, shape and layout checks shared by the three kernels; `more`
    are further (B, S, H, D) operands (o, do).  Returns q's dtype code."""
    batch, seq_len, heads, head_dim = q.shape
    kv_heads = k.shape[2]
    code = _kernels.dtype_code(q, kernel)
    _kernels.check(all(t.dtype == q.dtype and t.device == q.device
                       for t in (k, v, *more)),
                   f'{kernel}: q, k, v, o, do must share dtype and device')
    _kernels.check(k.shape == (batch, seq_len, kv_heads, head_dim)
                   and v.shape == k.shape
                   and all(t.shape == q.shape for t in more),
                   f'{kernel}: k/v shape {tuple(k.shape)} does not fit q '
                   f'{tuple(q.shape)}')
    _kernels.check(head_dim in _HEAD_DIMS, f'{kernel}: head_dim '
                   f'{head_dim} not in {_HEAD_DIMS}')
    _kernels.check(heads % kv_heads == 0, f'{kernel}: {heads} heads not a '
                   f'multiple of {kv_heads} KV heads')
    vec = 16 // q.element_size()
    for t in (q, k, v, *more):
        _kernels.check(t.stride(3) == 1 and _kernels.aligned(t)
                       and all(s % vec == 0 for s in t.stride()[:3]),
                       f'{kernel}: every operand needs a contiguous last '
                       f'dim, 16-byte aligned rows and base')
    return code


def _check_stats(kernel: str, q: torch.Tensor, *stats: torch.Tensor):
    batch, seq_len, heads, _ = q.shape
    for t in stats:
        _kernels.check(t.dtype == torch.float32 and t.device == q.device
                       and t.shape == (batch, heads, seq_len)
                       and t.is_contiguous(),
                       f'{kernel}: lse and delta must be contiguous '
                       f'(B, H, S) float32 on q\'s device')


def _strides(*tensors: torch.Tensor):
    strides = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(strides))(*strides)


def _count_route(wrapper, route: str, code: int, head_dim: int) -> None:
    """One launch of K2, K5 or K6 on its route: `launches` counts every
    launch, `launches_tc` those that the library's entry point `route`
    says went to the tensor-core kernels (bf16 at head_dim 64, 128 and
    256; f32 takes the FMA kernels)."""
    wrapper.launches += 1
    if getattr(_kernels.LIBRARY.get(), route)(code, head_dim):
        wrapper.launches_tc += 1


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool, need_lse: bool
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    batch, seq_len, heads, head_dim = q.shape
    code = _check_qkv('flash_attention', q, k, v)
    o = torch.empty((batch, seq_len, heads, head_dim), dtype=q.dtype,
                    device=q.device)
    lse = (torch.empty((batch, heads, seq_len), dtype=torch.float32,
                       device=q.device) if need_lse else None)
    _kernels.launch('skk_flash_fwd', q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(),
                    None if lse is None else lse.data_ptr(), batch, seq_len,
                    heads, k.shape[2], head_dim, int(bool(causal)),
                    float(head_dim ** -0.5), _strides(q, k, v, o), code)
    _count_route(flash_attention, 'skk_flash_fwd_route', code, head_dim)
    if need_lse:
        flash_attention.launches_lse += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, need_lse: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2's wrapper: (o (B, S, H, D), lse (B, H, S) f32 or None).

    need_lse=False (serving) writes no lse.  A CPU tensor takes the plain
    version; a CUDA tensor takes the kernel, which raises on a dtype,
    shape or layout it does not take.  No autograd: see
    :func:`flash_attention`."""
    if q.device.type == 'cpu':
        o = _attention_plain(q, k, v, causal=causal)
        return o, (_attention_lse_plain(q, k, causal) if need_lse else None)
    return _flash_attention_cuda(q, k, v, causal, need_lse)


def flash_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool = True
                       ) -> torch.Tensor:
    """K5's wrapper: dq (B, S, H, D) from do, the forward's lse and
    delta = rowsum(o * do), both (B, H, S) f32.  A CPU tensor takes the
    plain version, a CUDA tensor the kernel."""
    if q.device.type == 'cpu':
        return _flash_attention_dq_plain(q, k, v, do, lse, delta, causal)
    batch, seq_len, heads, head_dim = q.shape
    code = _check_qkv('flash_attention_dq', q, k, v, do)
    _check_stats('flash_attention_dq', q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _kernels.launch('skk_flash_bwd_dq', q.device, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), batch,
                    seq_len, heads, k.shape[2], head_dim, int(bool(causal)),
                    float(head_dim ** -0.5), _strides(q, k, v, do, dq, dq),
                    code)
    _count_route(flash_attention_dq, 'skk_flash_bwd_route', code,
                 head_dim)
    return dq


def flash_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's wrapper: (dk, dv) (B, S, KV, D), summed over each KV head's
    query-head group.  Arguments as :func:`flash_attention_dq`."""
    if q.device.type == 'cpu':
        return _flash_attention_dkv_plain(q, k, v, do, lse, delta, causal)
    batch, seq_len, heads, head_dim = q.shape
    code = _check_qkv('flash_attention_dkv', q, k, v, do)
    _check_stats('flash_attention_dkv', q, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _kernels.launch('skk_flash_bwd_dkv', q.device, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), batch, seq_len, heads, k.shape[2],
                    head_dim, int(bool(causal)), float(head_dim ** -0.5),
                    _strides(q, k, v, do, dk, dv), code)
    _count_route(flash_attention_dkv, 'skk_flash_bwd_route', code,
                 head_dim)
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` from its saved o and lse
    (B, H, S) f32 and the incoming gradient do: delta in plain torch,
    then K5 and K6 (their plain versions on CPU tensors)."""
    delta = _delta(o, do).contiguous()
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash_attention_vjp``: K2 with its lse forward,
    K5 and K6 backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal, need_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The incoming gradient may be a strided view (the reshape in
        # the layer); the kernels take a contiguous last dim.
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Multi-head attention, layout (batch, seq, heads, head_dim), GQA
    through the h // (H / KV) head map.

    A CPU tensor takes the plain versions; a CUDA tensor takes the flash
    kernels, which raise on a dtype, shape or layout they do not take.
    When a gradient is wanted this is an autograd Function (K2 with its
    lse forward, K5 and K6 backward); otherwise K2 writes no lse.  On the
    card, `launches` counts K2's launches and `launches_lse` those that
    wrote the lse."""
    if q.ndim != 4:
        raise ValueError(f'Expected (B, S, H, D), got {tuple(q.shape)}')
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal)[0]


_kernels.counter(flash_attention, 'launches', 'launches_tc', 'launches_lse')
_kernels.counter(flash_attention_dq, 'launches', 'launches_tc')
_kernels.counter(flash_attention_dkv, 'launches', 'launches_tc')
