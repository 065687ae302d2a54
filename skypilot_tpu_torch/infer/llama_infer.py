"""KV-cache prefill and decode for the stacked-layer Llama parameters.

Counterpart of the serving subset of skypilot_tpu/infer/llama_infer.py:
the pooled block arena (the default plane) and the contiguous,
length-bucketed slot cache of the legacy decode planes ('paged',
'inplace', 'scan', 'unroll'; ``resize_cache`` migrates it between
buckets).  Where the JAX package scanned the layers with
``lax.scan``/``fori_loop`` and donated the cache to each jitted program,
this module runs a plain Python loop over the layers and updates the
caches IN PLACE (functions return the same dicts they were given).  The
loop issues each layer's kernels one by one; on the card the engines
capture whole decode chunks as CUDA graphs (``engine.ChunkGraphs``), so
a decode, verify or fused step reads no device value on the host.

Kernels on this path (each with a plain PyTorch version for CPU tensors):
``ops.rmsnorm.rms_norm`` (every norm), ``ops.attention.flash_attention``
(prefill), ``ops.decode_attention.decode_attention_pooled`` (decode),
``decode_window_attention_pooled`` (speculative verify),
``fused_step_attention_pooled`` (the fused prefill+decode step) and
``decode_attention`` (K7, the 'paged' plane's decode).  The
chunked-prefill windows and the 'inplace' decode attend with plain
einsums, as the JAX package does.  An int8 cache (``kv_dtype='int8'``) holds int8 k/v and per-(row,
KV head) f32 absmax scales ``k_scale``/``v_scale``.
"""
from __future__ import annotations

import functools
import warnings
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
    dtype, or int8 with (L, B, max_len, KV) f32 scales for
    kv_dtype='int8'."""
    shape = (config.n_layers, batch, max_len, config.n_kv_heads,
             config.head_dim)
    device = resolve_device(device)
    if kv_dtype is None:
        return {'k': torch.zeros(shape, dtype=config.dtype, device=device),
                'v': torch.zeros(shape, dtype=config.dtype, device=device)}
    if kv_dtype != 'int8':
        raise ValueError(f'kv_dtype must be None or "int8", '
                         f'got {kv_dtype!r}')
    return {'k': torch.zeros(shape, dtype=torch.int8, device=device),
            'v': torch.zeros(shape, dtype=torch.int8, device=device),
            'k_scale': torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            'v_scale': torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)}


def resize_cache(cache: Cache, new_len: int) -> Cache:
    """Pad (zeros) or truncate the position axis (2) of every entry to
    new_len: the bucket migration of the legacy decode planes.  k/v
    (L, B, S, KV, hd) and the int8 scales (L, B, S, KV) share that axis.

    Returns a NEW dict of contiguous tensors (a truncating slice alone
    would be a view, and the kernels take contiguous inputs), or `cache`
    itself when the length already matches.  Zero tail rows stay
    invisible: every decode masks keys past its position, and a position
    reaches a row only after that row's K/V write.  Truncating is legal
    only while every live slot's position is < new_len."""
    cur = cache['k'].shape[2]
    if new_len == cur:
        return cache
    out = {}
    for key, arr in cache.items():
        if new_len > cur:
            # Pad axis 2 of a 5-d k/v or a 4-d scale plane.
            out[key] = torch.nn.functional.pad(
                arr, (0, 0) * (arr.dim() - 3) + (0, new_len - cur))
        else:
            out[key] = arr[:, :, :new_len].contiguous()
    return out


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 values, f32 absmax scale over hd)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                            1e-8)
    return torch.round(xf / scale).to(torch.int8), scale[..., 0]


def _write_kv(cache: Cache, idx: tuple, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """Write K/V rows to cache[key][idx] in place (an int8 cache takes
    the quantized rows and their scales at the same index)."""
    if 'k_scale' in cache:
        k, cache['k_scale'][idx] = _quantize_kv(k)
        v, cache['v_scale'][idx] = _quantize_kv(v)
    cache['k'][idx] = k
    cache['v'][idx] = v


def _table_rows(table: torch.Tensor, rows: torch.Tensor, bs: int):
    """(block, offset) of logical cache rows through a (..., T) table;
    rows past the table go to the garbage block 0 (clamp first: the
    lookup itself must stay in bounds)."""
    t_width = table.shape[-1]
    blk_idx = rows // bs
    blk = torch.gather(table.long(), -1,
                       torch.clamp_max(blk_idx, t_width - 1))
    return torch.where(blk_idx >= t_width, 0, blk), rows % bs


# Unbounded: a captured decode graph reads the tables at their address,
# so an entry must never be evicted (one per prompt bucket, cache bucket
# and arena capacity, a few KB each).
@functools.lru_cache(maxsize=None)
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
        _write_kv(cache, (i, slice(None), slice(None, seq)), k, v)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    # Logits only at each row's last valid position.
    last = h[torch.arange(batch, device=h.device), lengths.long() - 1]
    logits = quant.matmul(last, params['lm_head'], out_dtype=torch.float32)
    return logits, cache


def prefill_window(params: llama.Params, tokens_w: torch.Tensor,
                   config: llama.LlamaConfig, cache: Cache, slot: int,
                   start: int) -> Tuple[torch.Tensor, Cache]:
    """Advance ONE slot's prefill by a window (chunked prefill over the
    contiguous cache of the legacy planes): queries at positions
    [start, start + W) attend over the slot's cache prefix and the
    window itself; the window's K/V are written to cache[:, slot,
    start:start + W) in place.

    tokens_w: (W,); cache: (L, B, S, KV, hd).  Pad tokens past the
    prompt are written but sit above every later query's mask.  Window
    rows past the cache's S rows are dropped, as the JAX scatter drops
    them (their rotation clamps to the last row, like the JAX gather).
    Returns (hidden states (W, d) after the final norm, cache)."""
    (w,) = tokens_w.shape
    s_len = cache['k'].shape[2]
    device = tokens_w.device
    cos, sin = rope_tables(config, s_len, device)
    h = llama.embed_tokens(params, tokens_w[None], config)   # (1, W, d)
    q_pos = start + torch.arange(w, device=device)          # (W,)
    visible = torch.arange(s_len, device=device)[None, :] <= q_pos[:, None]
    rot = torch.clamp_max(q_pos, s_len - 1)[None]
    keep = max(0, min(w, s_len - start))                    # rows in cache
    dest = slice(start, start + keep)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin, positions=rot)
        k = rope_ops.apply_rope(k, cos, sin, positions=rot)
        _write_kv(cache, (i, slot, dest), k[0, :keep], v[0, :keep])
        k_slot, v_slot = cache['k'][i, slot], cache['v'][i, slot]
        if 'k_scale' in cache:
            k_slot = decode_attention_ops._dequantize(
                k_slot, cache['k_scale'][i, slot], q.dtype)
            v_slot = decode_attention_ops._dequantize(
                v_slot, cache['v_scale'][i, slot], q.dtype)
        o = _window_attention(q, k_slot, v_slot, visible, config)
        h = h + quant.matmul(o.reshape(1, w, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    return h[0], cache


def scatter_prefill_pooled(small: Cache, arena: Cache,
                           tables_scatter: torch.Tensor) -> Cache:
    """Move a contiguous prefill cache into pooled arena blocks, in place.

    small: (L, B, S, KV, hd) filled by `prefill` (plus (L, B, S, KV)
    scales when int8); arena: the pooled (L, NB, BS, KV, hd) arena;
    tables_scatter: (B, nb) with nb == ceil(S / BS), the arena blocks of
    each row's first nb logical blocks (entries past a short prompt's own
    blocks point at the garbage block, where duplicate writes are
    harmless).  S is padded up to a BS multiple first; pad rows land
    above every row's length."""
    bs = arena['k'].shape[2]
    s_len = small['k'].shape[2]
    pad = (-s_len) % bs
    nb = (s_len + pad) // bs
    idx = tables_scatter.long()
    for key, arr in small.items():
        if pad:
            # Pad axis 2 (S) of a 5-d k/v or a 4-d scale plane.
            arr = torch.nn.functional.pad(
                arr, (0, 0) * (arr.dim() - 3) + (0, pad))
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


def _slot_view(cache: Cache, key: str, layer: int, table: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """One layer of one sequence's K or V through its (T,) table, as a
    (T * BS, KV, hd) view in `dtype`; an int8 cache is dequantized with
    its scales in `dtype`, as the JAX window prefill does."""
    rows = cache[key][layer][table]
    rows = rows.reshape((-1,) + tuple(rows.shape[2:]))
    if f'{key}_scale' not in cache:
        return rows
    scale = cache[f'{key}_scale'][layer][table].reshape(rows.shape[:-1])
    return decode_attention_ops._dequantize(rows, scale, dtype)


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
    table = table_row.long()
    blk, off = _table_rows(table, q_pos, bs)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin, positions=q_pos[None])
        k = rope_ops.apply_rope(k, cos, sin, positions=q_pos[None])
        _write_kv(cache, (i, blk, off), k[0], v[0])
        k_slot = _slot_view(cache, 'k', i, table, q.dtype)
        v_slot = _slot_view(cache, 'v', i, table, q.dtype)
        o = _window_attention(q, k_slot, v_slot, visible, config)
        h = h + quant.matmul(o.reshape(1, w, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    return h[0], cache


def get_decode_fn(impl: str):
    """Decode step by GeneratorConfig.decode_impl name; an unknown name
    raises, so a typo cannot select another path.  'pooled' takes a
    block-table operand the others do not; the engines call it directly.

    'inplace', 'scan' and 'unroll' are one function here: the JAX package
    shares their math (_token_attn_mlp) and differs only in how XLA
    carries the cache through the layer loop, which eager PyTorch does
    not have.  'scan' and 'paged' keep the JAX package's
    DeprecationWarning."""
    if impl in ('inplace', 'unroll'):
        return decode_step_inplace
    if impl == 'scan':
        warnings.warn(
            "decode_impl='scan' is deprecated and will be removed once "
            "a hardware bench confirms parity; use the default "
            "decode_impl='pooled' block-pool data plane instead.",
            DeprecationWarning, stacklevel=2)
        return decode_step_inplace
    if impl == 'paged':
        warnings.warn(
            "decode_impl='paged' is deprecated and will be removed once "
            "a hardware bench confirms parity; use the default "
            "decode_impl='pooled' block-pool data plane instead (same "
            "length-aware reads, plus shared-arena block tables).",
            DeprecationWarning, stacklevel=2)
        return decode_step_paged
    if impl == 'pooled':
        return decode_step_pooled
    raise ValueError(
        f"decode_impl must be 'pooled', 'inplace', 'scan', 'unroll' or "
        f"'paged', got {impl!r}")


def _decode_contig(params: llama.Params, token: torch.Tensor,
                   config: llama.LlamaConfig, cache: Cache,
                   positions: torch.Tensor, kernel: bool
                   ) -> Tuple[torch.Tensor, Cache]:
    """One-token step over the contiguous (L, B, S, KV, hd) cache: each
    layer writes its new K/V row in place at (layer, b, positions[b]),
    then attends over the layer with keys <= positions[b] visible.
    kernel: K7 (the 'paged' plane); else the plain masked math of the
    JAX inplace/scan/unroll steps."""
    batch = token.shape[0]
    s_len = cache['k'].shape[2]
    group = config.n_heads // config.n_kv_heads
    cos, sin = rope_tables(config, s_len, token.device)
    h = llama.embed_tokens(params, token, config)[:, None]   # (B, 1, d)
    pos = positions.long()[:, None]
    b_idx = torch.arange(batch, device=token.device)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin, positions=pos)
        k = rope_ops.apply_rope(k, cos, sin, positions=pos)
        _write_kv(cache, (i, b_idx, pos[:, 0]), k[:, 0], v[:, 0])
        q_g = q.reshape(batch, 1, config.n_kv_heads, group, config.head_dim)
        if kernel:
            o = decode_attention_ops.decode_attention(
                q_g[:, 0], cache['k'], cache['v'], i, positions,
                cache.get('k_scale'), cache.get('v_scale'))
        else:
            scales = [cache[key][i] if key in cache else None
                      for key in ('k_scale', 'v_scale')]
            o = decode_attention_ops._token_attention(
                q_g, cache['k'][i], cache['v'][i], positions, *scales)
        h = h + quant.matmul(o.reshape(batch, 1, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    logits = quant.matmul(h[:, 0], params['lm_head'], out_dtype=torch.float32)
    return logits, cache


def decode_step_inplace(params: llama.Params, token: torch.Tensor,
                        config: llama.LlamaConfig, cache: Cache,
                        positions: torch.Tensor
                        ) -> Tuple[torch.Tensor, Cache]:
    """One-token step of the 'inplace', 'scan' and 'unroll' planes over
    the contiguous cache, updated in place: plain masked attention over
    each layer's full (B, S, KV, hd) slice (an int8 cache's scales
    applied after each contraction).  token (B,); positions (B,) int32,
    each slot's current cache row.  Returns (logits (B, vocab) f32,
    cache)."""
    return _decode_contig(params, token, config, cache, positions,
                          kernel=False)


def decode_step_paged(params: llama.Params, token: torch.Tensor,
                      config: llama.LlamaConfig, cache: Cache,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, Cache]:
    """decode_step_inplace with attention through K7
    (ops.decode_attention.decode_attention), which reads only each
    slot's live rows straight from the stacked cache, dequantizing an
    int8 cache before each product.  Needs S % 64 == 0 and
    head_dim % 128 == 0."""
    return _decode_contig(params, token, config, cache, positions,
                          kernel=True)


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
        _write_kv(cache, (i, blk, off), k[:, 0], v[:, 0])
        q_r = q[:, 0].reshape(batch, config.n_kv_heads, group,
                              config.head_dim)
        o = decode_attention_ops.decode_attention_pooled(
            q_r, cache['k'], cache['v'], tables, i, positions,
            cache.get('k_scale'), cache.get('v_scale'))
        h = h + quant.matmul(o.reshape(batch, 1, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    logits = quant.matmul(h[:, 0], params['lm_head'], out_dtype=torch.float32)
    return logits, cache


def decode_verify_pooled(params: llama.Params, tokens: torch.Tensor,
                         config: llama.LlamaConfig, cache: Cache,
                         positions: torch.Tensor, tables: torch.Tensor
                         ) -> Tuple[torch.Tensor, Cache]:
    """Speculative VERIFY step over the pooled arena: score a window of
    W = spec_k + 1 tokens per slot in one batched forward.

    tokens: (B, W) int32; tokens[:, 0] is each slot's last committed
    token and tokens[:, 1:] the drafter's proposals.  positions: (B,)
    int32, the cache row of tokens[:, 0]; window column w lands at row
    positions + w.  Per layer all W rows' K/V scatter through the block
    table first (rows past the table go to the garbage block 0: a parked
    chunked-prefill slot sits at the last cache row), then every window
    query attends with the per-row mask `key <= positions + w` through
    the window kernel.  Rejected rows need no cleanup: the batcher's
    cursor never advances over them.  Returns ((B, W, vocab) f32 logits,
    cache)."""
    batch, win = tokens.shape
    bs = cache['k'].shape[2]
    t_width = tables.shape[1]
    group = config.n_heads // config.n_kv_heads
    cos, sin = rope_tables(config, t_width * bs, tokens.device)
    h = llama.embed_tokens(params, tokens, config)           # (B, W, d)
    pos_w = positions.long()[:, None] + torch.arange(win,
                                                     device=tokens.device)
    blk, off = _table_rows(tables, pos_w, bs)                # (B, W)
    # Rows past the table (garbage writes) take the last row's rotation,
    # as the JAX package's clamped gather does.
    rot = torch.clamp_max(pos_w, t_width * bs - 1)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin, positions=rot)
        k = rope_ops.apply_rope(k, cos, sin, positions=rot)
        _write_kv(cache, (i, blk, off), k, v)
        o = decode_attention_ops.decode_window_attention_pooled(
            q.reshape(batch, win, config.n_kv_heads, group,
                      config.head_dim),
            cache['k'], cache['v'], tables, i, positions,
            cache.get('k_scale'), cache.get('v_scale'))
        h = h + quant.matmul(o.reshape(batch, win, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    logits = quant.matmul(h, params['lm_head'], out_dtype=torch.float32)
    return logits, cache


def fused_step_pooled(params: llama.Params, token: torch.Tensor,
                      config: llama.LlamaConfig, cache: Cache,
                      positions: torch.Tensor, tables: torch.Tensor,
                      pf_tokens: torch.Tensor, pf_table_row: torch.Tensor,
                      pf_start: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """Fused prefill+decode step over the pooled arena: ONE forward
    carries the decode batch's single-token columns AND a fixed-width
    chunk of an in-flight prompt.

    token (B,) / positions (B,) / tables (B, T): the decode contract of
    :func:`decode_step_pooled`.  pf_tokens (F,): the prompt chunk, padded
    to the fuse budget; pf_table_row (T,): the prefill slot's table row;
    pf_start: the chunk's first cache row.  Pad tokens past the real
    chunk write K/V at rows above every later query's mask (garbage
    block 0 when past the table), which the next chunk overwrites.

    All B + F rows share one _qkv/rope/scatter per layer; attention goes
    through :func:`ops.decode_attention.fused_step_attention_pooled`
    (K1 for the decode rows, K4 as one window row for the prefill lane),
    each lane with its unfused numerics.  The prefill lane samples
    nothing.  Returns (decode logits (B, vocab) f32, chunk hiddens
    (F, d) after the final norm, cache)."""
    batch = token.shape[0]
    fuse = pf_tokens.shape[0]
    bs = cache['k'].shape[2]
    t_width = tables.shape[1]
    group = config.n_heads // config.n_kv_heads
    device = token.device
    cos, sin = rope_tables(config, t_width * bs, device)
    h = llama.embed_tokens(params, torch.cat([token, pf_tokens]),
                           config)[:, None]                  # (B+F, 1, d)
    pf_pos = pf_start + torch.arange(fuse, device=device)
    # Pad rows past the table take the last row's rotation (the JAX
    # package's clamped gather); they only write the garbage block.
    pos = torch.clamp_max(torch.cat([positions.long(), pf_pos]),
                          t_width * bs - 1)[:, None]
    dec_blk, dec_off = _table_rows(tables, positions.long()[:, None], bs)
    pf_blk, pf_off = _table_rows(pf_table_row, pf_pos, bs)
    blk = torch.cat([dec_blk[:, 0], pf_blk])
    off = torch.cat([dec_off[:, 0], pf_off])
    kv_shape = (config.n_kv_heads, group, config.head_dim)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)                    # (B+F, 1, ...)
        q = rope_ops.apply_rope(q, cos, sin, positions=pos)
        k = rope_ops.apply_rope(k, cos, sin, positions=pos)
        _write_kv(cache, (i, blk, off), k[:, 0], v[:, 0])
        o_dec, o_pf = decode_attention_ops.fused_step_attention_pooled(
            q[:batch, 0].reshape((batch,) + kv_shape),
            q[batch:, 0].reshape((fuse,) + kv_shape), cache['k'],
            cache['v'], tables, pf_table_row, i, positions, pf_start,
            cache.get('k_scale'), cache.get('v_scale'))
        o = torch.cat([o_dec, o_pf])
        h = h + quant.matmul(o.reshape(batch + fuse, 1, -1), attn_p['wo'])
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    logits = quant.matmul(h[:batch, 0], params['lm_head'],
                          out_dtype=torch.float32)
    return logits, h[batch:, 0], cache
