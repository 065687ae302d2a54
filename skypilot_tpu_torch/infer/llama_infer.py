"""KV-cache prefill and decode for the stacked-layer Llama parameters.

Counterpart of the pooled serving subset of skypilot_tpu/infer/
llama_infer.py.  Where the JAX package scanned the layers with
``lax.scan``/``fori_loop`` and donated the cache to each jitted program,
this module runs a plain Python loop over the layers and updates the
caches IN PLACE (functions return the same dicts they were given).  The
loop issues each layer's kernels one by one, so at 8B widths a decode
step is bound by launch overhead on the host; CUDA graphs are later work.

Kernels on this path (each with a plain PyTorch version for CPU tensors):
``ops.rmsnorm.rms_norm`` (every norm), ``ops.attention.flash_attention``
(prefill) and ``ops.decode_attention.decode_attention_pooled`` (decode).
The chunked-prefill window attends with plain einsums, as the JAX
package does.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.infer import quant
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import decode_attention as decode_attention_ops
from skypilot_tpu_torch.ops import rmsnorm as rmsnorm_ops
from skypilot_tpu_torch.ops import rope as rope_ops

Cache = Dict[str, torch.Tensor]


def init_cache(config: llama.LlamaConfig, batch: int, max_len: int,
               kv_dtype: Optional[str] = None, device=None) -> Cache:
    """Contiguous k/v cache (L, B, max_len, KV, hd) of zeros in the model
    dtype.  The int8 cache comes with ROADMAP.md Queue A item 7."""
    if kv_dtype is not None:
        raise NotImplementedError(
            "kv_dtype='int8' is not ported yet: ROADMAP.md Queue A item 7")
    shape = (config.n_layers, batch, max_len, config.n_kv_heads,
             config.head_dim)
    device = resolve_device(device)
    return {'k': torch.zeros(shape, dtype=config.dtype, device=device),
            'v': torch.zeros(shape, dtype=config.dtype, device=device)}


@functools.lru_cache(maxsize=16)
def _rope_tables(head_dim: int, length: int, theta: float,
                 scaling: Optional[tuple], device: torch.device):
    return rope_ops.rope_frequencies(
        head_dim, length, theta, scaling=dict(scaling) if scaling else None,
        device=device)


def rope_tables(config: llama.LlamaConfig, length: int,
                device: torch.device):
    """(cos, sin) for `length` positions, computed once per shape and
    device (the JAX programs folded them into constants)."""
    return _rope_tables(config.head_dim, length, config.rope_theta,
                        config.rope_scaling, torch.device(device))


def _qkv(x, attn_p, config):
    batch, seq, _ = x.shape
    hd, nh, nkv = config.head_dim, config.n_heads, config.n_kv_heads
    q = quant.matmul(x, attn_p['wq'])
    k = quant.matmul(x, attn_p['wk'])
    v = quant.matmul(x, attn_p['wv'])
    if 'bq' in attn_p:  # Qwen2-family qkv biases (config.attn_bias)
        q, k, v = q + attn_p['bq'], k + attn_p['bk'], v + attn_p['bv']
    return (q.reshape(batch, seq, nh, hd), k.reshape(batch, seq, nkv, hd),
            v.reshape(batch, seq, nkv, hd))


def _mlp(x, mlp_p, act: str = 'silu'):
    gate = llama.gate_activation(quant.matmul(x, mlp_p['w_gate']), act)
    return quant.matmul(gate * quant.matmul(x, mlp_p['w_up']),
                        mlp_p['w_down'])


def _ffn(x, layer_params, config):
    """Per-layer dense gated MLP.  The MoE expert bank comes with the
    training slice's models/moe.py (ROADMAP.md Queue A item 11)."""
    if 'moe' in layer_params:
        raise NotImplementedError(
            "MoE layers ('moe' subtree) are not ported yet: ROADMAP.md "
            'Queue A item 11')
    return _mlp(x, layer_params['mlp'], config.mlp_act)


def prefill(params: llama.Params, tokens: torch.Tensor,
            config: llama.LlamaConfig, cache: Cache,
            lengths: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, S) padded; lengths (B,) valid prefix lengths.

    Fills cache rows [0, S) of every layer in place (pad rows too: they
    sit above every row's length and stay masked) and returns
    (next-token logits (B, vocab) f32 at each row's last valid position,
    cache).  S must be <= the cache's max_len."""
    batch, seq = tokens.shape
    cos, sin = rope_tables(config, seq, tokens.device)
    h = llama.embed_tokens(params, tokens, config)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        o = attention_ops.flash_attention(q, k, v, causal=True)
        h = h + quant.matmul(o.reshape(batch, seq, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
        cache['k'][i, :, :seq] = k
        cache['v'][i, :, :seq] = v
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    # Logits only at each row's last valid position.
    last = h[torch.arange(batch, device=h.device), lengths.long() - 1]
    logits = quant.matmul(last, params['lm_head'], out_dtype=torch.float32)
    return logits, cache


def scatter_prefill_pooled(small: Cache, arena: Cache,
                           tables_scatter: torch.Tensor) -> Cache:
    """Move a contiguous prefill cache into pooled arena blocks, in place.

    small: (L, B, S, KV, hd) filled by `prefill`; arena: the pooled
    (L, NB, BS, KV, hd) arena; tables_scatter: (B, nb) with
    nb == ceil(S / BS), the arena blocks of each row's first nb logical
    blocks (entries past a short prompt's own blocks point at the
    garbage block, where duplicate writes are harmless).  S is padded up
    to a BS multiple first; pad rows land above every row's length."""
    bs = arena['k'].shape[2]
    s_len = small['k'].shape[2]
    pad = (-s_len) % bs
    nb = (s_len + pad) // bs
    idx = tables_scatter.long()
    for key, arr in small.items():
        if pad:
            arr = torch.nn.functional.pad(
                arr, (0, 0, 0, 0, 0, pad))
        n_layers, batch = arr.shape[:2]
        resh = arr.reshape((n_layers, batch, nb, bs) + tuple(arr.shape[3:]))
        arena[key][:, idx] = resh
    return arena


def _window_attention(q, k_slot, v_slot, visible, config):
    """Masked GQA attention of a window of W queries over a gathered
    (S, KV, hd) slot view; the einsum math of the JAX window prefill."""
    w = q.shape[1]
    group = config.n_heads // config.n_kv_heads
    q_g = q[0].reshape(w, config.n_kv_heads, group, config.head_dim)
    s = torch.einsum('wkgd,skd->kgws', q_g.float(), k_slot.float()) * (
        config.head_dim ** -0.5)
    s = torch.where(visible[None, None, :, :], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum('kgws,skd->wkgd', p, v_slot)


def prefill_window_pooled(params: llama.Params, tokens_w: torch.Tensor,
                          config: llama.LlamaConfig, cache: Cache,
                          table_row: torch.Tensor, start: int
                          ) -> Tuple[torch.Tensor, Cache]:
    """Advance ONE sequence's prefill by a window (chunked prefill),
    writing the window's K/V through its block table in place.

    tokens_w: (W,); cache: pooled (L, NB, BS, KV, hd) arena; table_row:
    (T,) int32, the sequence's block table; start: the window's first
    position.  Window rows whose logical block falls past the table (pad
    rows of the final window) go to the garbage block 0.  The window
    attends over the gathered (T * BS, KV, hd) logical view with the
    `key <= query position` mask.  Returns (hidden states (W, d) after
    the final norm, cache)."""
    (w,) = tokens_w.shape
    bs = cache['k'].shape[2]
    (t_width,) = table_row.shape
    s_len = t_width * bs
    device = tokens_w.device
    cos, sin = rope_tables(config, s_len, device)
    h = llama.embed_tokens(params, tokens_w[None], config)   # (1, W, d)
    q_pos = start + torch.arange(w, device=device)          # (W,)
    visible = torch.arange(s_len, device=device)[None, :] <= q_pos[:, None]
    blk_idx = q_pos // bs
    table = table_row.long()
    blk = torch.where(blk_idx >= t_width, 0,
                      table[torch.clamp_max(blk_idx, t_width - 1)])
    off = q_pos % bs
    kv_shape = (s_len, config.n_kv_heads, config.head_dim)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin, positions=q_pos[None])
        k = rope_ops.apply_rope(k, cos, sin, positions=q_pos[None])
        cache['k'][i, blk, off] = k[0]
        cache['v'][i, blk, off] = v[0]
        k_slot = cache['k'][i][table].reshape(kv_shape)
        v_slot = cache['v'][i][table].reshape(kv_shape)
        o = _window_attention(q, k_slot, v_slot, visible, config)
        h = h + quant.matmul(o.reshape(1, w, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    return h[0], cache


def decode_step_pooled(params: llama.Params, token: torch.Tensor,
                       config: llama.LlamaConfig, cache: Cache,
                       positions: torch.Tensor, tables: torch.Tensor
                       ) -> Tuple[torch.Tensor, Cache]:
    """One-token step over the pooled block arena (the default data
    plane).

    token: (B,); positions: (B,) int32, each slot's current cache row;
    tables: (B, T) int32 block tables (unmapped entries are 0, the
    garbage block).  Each layer first writes the new K/V row in place at
    (layer, tables[b, pos // BS], pos % BS), then attends through the
    paged decode kernel on the same stream, so the row is visible to its
    own query.  Returns (logits (B, vocab) f32, cache)."""
    batch = token.shape[0]
    bs = cache['k'].shape[2]
    t_width = tables.shape[1]
    group = config.n_heads // config.n_kv_heads
    cos, sin = rope_tables(config, t_width * bs, token.device)
    h = llama.embed_tokens(params, token, config)[:, None]   # (B, 1, d)
    pos_long = positions.long()
    pos = pos_long[:, None]
    b_idx = torch.arange(batch, device=token.device)
    blk = tables.long()[b_idx, pos_long // bs]
    off = pos_long % bs
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin, positions=pos)
        k = rope_ops.apply_rope(k, cos, sin, positions=pos)
        cache['k'][i, blk, off] = k[:, 0]
        cache['v'][i, blk, off] = v[:, 0]
        q_r = q[:, 0].reshape(batch, config.n_kv_heads, group,
                              config.head_dim)
        o = decode_attention_ops.decode_attention_pooled(
            q_r, cache['k'], cache['v'], tables, i, positions)
        h = h + quant.matmul(o.reshape(batch, 1, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    logits = quant.matmul(h[:, 0], params['lm_head'], out_dtype=torch.float32)
    return logits, cache
