"""Paged decode attention over the pooled KV arena: hand-written CUDA
kernel (csrc/paged_decode.cu) and its plain PyTorch version.

Counterpart of skypilot_tpu/ops/decode_attention.py.  The kernel replaces
the TPU's ``decode_attention_pooled`` (``_pooled_attn_kernel`` with body
``_decode_attn_kernel``, window 1).  Each thread block reads only its
slot's live keys through the block table; bound by bytes on the H100 (see
the source note).  The int8 arena and the window (speculative-verify)
variant come with later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.ops import _kernels

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8


def _gather_layer(arena: torch.Tensor, tables: torch.Tensor,
                  layer: int) -> torch.Tensor:
    """(L, NB, BS, KV, hd) arena -> (B, T * BS, KV, hd) logical view of
    one layer through the block table."""
    batch, t_width = tables.shape
    _, _, bs, kv_heads, head_dim = arena.shape
    return arena[layer][tables.long()].reshape(batch, t_width * bs,
                                               kv_heads, head_dim)


def _decode_attention_plain(q: torch.Tensor, k_arena: torch.Tensor,
                            v_arena: torch.Tensor, tables: torch.Tensor,
                            layer: int,
                            positions: torch.Tensor) -> torch.Tensor:
    """Gather through the table, then the math of the JAX decode off the
    TPU (llama_infer._token_attention, window 1): f32 scores and
    softmax, probabilities cast to q's dtype before P.V."""
    k_eff = _gather_layer(k_arena, tables, layer)
    v_eff = _gather_layer(v_arena, tables, layer)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum('bkgd,bskd->bkgs', q.float(),
                     k_eff.to(q.dtype).float()) * scale
    visible = (torch.arange(k_eff.shape[1], device=q.device)[None, :]
               <= positions.long()[:, None])              # (B, S)
    s = torch.where(visible[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum('bkgs,bskd->bkgd', p, v_eff.to(q.dtype))


def reference_decode_attention(q: torch.Tensor, k_layer: torch.Tensor,
                               v_layer: torch.Tensor,
                               positions: torch.Tensor) -> torch.Tensor:
    """All-f32 oracle over one layer's gathered (B, S, KV, hd) slice,
    the port of the JAX ``reference_decode_attention``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum('bkgd,bskd->bkgs', q.float(), k_layer.float()) * scale
    visible = (torch.arange(k_layer.shape[1], device=q.device)[None, :]
               <= positions.long()[:, None])
    s = torch.where(visible[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum('bkgs,bskd->bkgd', p, v_layer.float())
    return o.to(q.dtype)


def _decode_attention_cuda(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, tables: torch.Tensor,
                           layer: int,
                           positions: torch.Tensor) -> torch.Tensor:
    batch, kv_heads, group, head_dim = q.shape
    n_layers, n_blocks, bs, arena_kv, arena_hd = k_arena.shape
    code = _kernels.dtype_code(q, 'decode_attention_pooled')
    _kernels.check(k_arena.dtype == q.dtype and v_arena.dtype == q.dtype,
                   'decode_attention_pooled: arena dtype must match q')
    _kernels.check(v_arena.shape == k_arena.shape
                   and (arena_kv, arena_hd) == (kv_heads, head_dim),
                   f'decode_attention_pooled: arena {tuple(k_arena.shape)} '
                   f'does not fit q {tuple(q.shape)}')
    _kernels.check(head_dim in _HEAD_DIMS, f'decode_attention_pooled: '
                   f'head_dim {head_dim} not in {_HEAD_DIMS}')
    _kernels.check(1 <= group <= _MAX_GROUP, f'decode_attention_pooled: '
                   f'group {group} not in 1..{_MAX_GROUP}')
    _kernels.check(0 <= layer < n_layers, f'decode_attention_pooled: '
                   f'layer {layer} out of range')
    _kernels.check(tables.dtype == torch.int32 and tables.dim() == 2
                   and tables.shape[0] == batch
                   and positions.dtype == torch.int32
                   and positions.shape == (batch,),
                   'decode_attention_pooled: tables (B, T) and positions '
                   '(B,) must be int32')
    devices = {t.device for t in (q, k_arena, v_arena, tables, positions)}
    _kernels.check(len(devices) == 1,
                   'decode_attention_pooled: inputs on several devices')
    for t in (q, k_arena, v_arena, tables, positions):
        _kernels.check(t.is_contiguous() and _kernels.aligned(t),
                       'decode_attention_pooled: inputs must be contiguous '
                       'and 16-byte aligned')
    out = torch.empty_like(q)
    _kernels.launch('skk_paged_decode', q.device, q.data_ptr(),
                    k_arena.data_ptr(), v_arena.data_ptr(),
                    tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
                    batch, kv_heads, group, head_dim, n_blocks, bs,
                    tables.shape[1], int(layer), float(head_dim ** -0.5),
                    code)
    decode_attention_pooled.launches += 1
    return out


def decode_attention_pooled(q: torch.Tensor, k_arena: torch.Tensor,
                            v_arena: torch.Tensor, tables: torch.Tensor,
                            layer: int, positions: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Single-token GQA attention over a pooled block arena.

    q: (B, KV, G, hd) current-token queries (post-rope), head h = kv*G+g.
    k_arena/v_arena: (L, NB, BS, KV, hd); tables: (B, T) int32, where
    tables[b, j] is the arena block of slot b's logical rows
    [j*BS, (j+1)*BS); layer: int; positions: (B,) int32, the current
    cache row (rows <= positions[b] are attended).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    which raises on a dtype, shape or layout it does not take.
    Returns (B, KV, G, hd) in q's dtype."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            'int8 KV (k_scale/v_scale) is not ported yet: ROADMAP.md '
            'Queue A item 7')
    if q.device.type == 'cpu':
        return _decode_attention_plain(q, k_arena, v_arena, tables, layer,
                                       positions)
    return _decode_attention_cuda(q, k_arena, v_arena, tables, layer,
                                  positions)


decode_attention_pooled.launches = 0
