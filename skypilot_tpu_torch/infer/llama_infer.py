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
(prefill and ``encode``, the embeddings' forward), ``ops.decode_attention.decode_attention_pooled`` (decode),
``decode_window_attention_pooled`` (speculative verify),
``fused_step_attention_pooled`` (the fused prefill+decode step) and
``decode_attention`` (K7, the 'paged' plane's decode).  The
chunked-prefill windows and the 'inplace' decode attend with plain
einsums, as the JAX package does.  An int8 cache (``kv_dtype='int8'``) holds int8 k/v and per-(row,
KV head) f32 absmax scales ``k_scale``/``v_scale``.

Under a tensor-parallel mesh (``mesh=``, infer/tp.py) every rank runs
these functions on its own blocks of the weights and the arena: the head
counts come from the shards' shapes, the combines after wo and w_down
are explicit (``_combine``), the d-sharded embedding and the
vocab-sharded logits are gathered, and the pooled steps split their slot
rows over a 'dp' axis, gathering each layer's K/V rows over it before
the write so every replica's arena stays the same.  The legacy planes'
steps (``decode_step_inplace``, ``decode_step_paged``, ``prefill``,
``prefill_window``) run every slot on every rank over a contiguous cache
of the rank's KV heads (K7 per shard on 'paged'), with the same
combines.  ``overlap=`` (a
chunk count, engine.resolve_overlap) runs the pooled steps' layer stack
through :func:`_combine_then_project`, which overlaps each combine with
the projections that consume it.
"""
from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.infer import quant
from skypilot_tpu_torch.infer import tp as tp_lib
from skypilot_tpu_torch.models import llama, moe
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import decode_attention as decode_attention_ops
from skypilot_tpu_torch.ops import rmsnorm as rmsnorm_ops
from skypilot_tpu_torch.ops import rope as rope_ops
from skypilot_tpu_torch.parallel import collectives

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


def _combine(x: torch.Tensor, mesh) -> torch.Tensor:
    """The megatron combine of a partial product over the model axes
    ('tp', 'tpq'): summed in flat mesh-rank order, bitwise the same on
    every rank (x itself without a mesh)."""
    if mesh is None:
        return x
    return collectives.all_reduce_sum(x, mesh, tp_lib.MODEL_AXES)


def _gather_cols(x: torch.Tensor, mesh) -> torch.Tensor:
    """x's last axis, split over the model axes, put back together."""
    if mesh is None or tp_lib.model_size(mesh) == 1:
        return x
    g = collectives.all_gather(x, mesh, tp_lib.MODEL_AXES)
    return g.movedim(0, -2).reshape(*x.shape[:-1], -1)


def _dp_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Each dp replica's slot rows (leading axis) stacked in batch
    order."""
    if tp_lib.dp_degree(mesh) == 1:
        return x
    return collectives.ring_all_gather(x, mesh, 'dp', tiled=True)


def _embed(params, tokens, config, mesh):
    """Token embeddings; a d-sharded table's column blocks gathered."""
    return _gather_cols(llama.embed_tokens(params, tokens, config), mesh)


def logits(h: torch.Tensor, params, mesh=None) -> torch.Tensor:
    """f32 logits of hidden rows h (..., d) through lm_head (its vocab
    blocks gathered under a mesh, before any sampling)."""
    return _gather_cols(quant.matmul(h, params['lm_head'],
                                     out_dtype=torch.float32), mesh)


def _qkv(x, attn_p, config):
    """q, k, v (B, S, heads, hd); the head counts are the weights' (a
    rank's own under a mesh)."""
    batch, seq, _ = x.shape
    hd = config.head_dim
    q = quant.matmul(x, attn_p['wq'])
    k = quant.matmul(x, attn_p['wk'])
    v = quant.matmul(x, attn_p['wv'])
    if 'bq' in attn_p:  # Qwen2-family qkv biases (config.attn_bias)
        q, k, v = q + attn_p['bq'], k + attn_p['bk'], v + attn_p['bv']
    return (q.reshape(batch, seq, -1, hd), k.reshape(batch, seq, -1, hd),
            v.reshape(batch, seq, -1, hd))


def _mlp(x, mlp_p, act: str = 'silu', mesh=None):
    gate = llama.gate_activation(quant.matmul(x, mlp_p['w_gate']), act)
    return _combine(quant.matmul(gate * quant.matmul(x, mlp_p['w_up']),
                                 mlp_p['w_down']), mesh)


def _attn_out(o, attn_p, mesh):
    """The attention output projection (B, S, heads * hd) @ wo,
    combined over the model axes."""
    return _combine(quant.matmul(o, attn_p['wo']), mesh)


def _ffn(x, layer_params, config, mesh=None):
    """Per-layer feed-forward: the dense gated MLP, or, when the layer
    carries a Mixtral-style expert bank ('moe' subtree, models/moe.py),
    the exact dropless top-k block.  Decode streams every expert's
    weights regardless once batch x top_k covers the experts, so the
    dense formulation costs the weight-bound step nothing; the banks
    stay in the model dtype under weights_dtype='int8'
    (quant._QUANT_PATH does not match them)."""
    if 'moe' in layer_params:
        y, _ = moe.moe_block_dense(x, layer_params['moe'], config)
        return _combine(y, mesh)
    return _mlp(x, layer_params['mlp'], config.mlp_act, mesh)


def prefill(params: llama.Params, tokens: torch.Tensor,
            config: llama.LlamaConfig, cache: Cache,
            lengths: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, S) padded; lengths (B,) valid prefix lengths.

    Fills cache rows [0, S) of every layer in place (pad rows too: they
    sit above every row's length and stay masked) and returns
    (next-token logits (B, vocab) f32 at each row's last valid position,
    cache).  S must be <= the cache's max_len.  Under a mesh every rank
    prefills all rows (replicated over dp) on its heads, into a cache of
    its KV heads."""
    batch, seq = tokens.shape
    cos, sin = rope_tables(config, seq, tokens.device)
    h = _embed(params, tokens, config, mesh)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        o = attention_ops.flash_attention(q, k, v, causal=True)
        h = h + _attn_out(o.reshape(batch, seq, -1), attn_p, mesh)
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config, mesh)
        _write_kv(cache, (i, slice(None), slice(None, seq)), k, v)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    # Logits only at each row's last valid position.
    last = h[torch.arange(batch, device=h.device), lengths.long() - 1]
    return logits(last, params, mesh), cache


def hidden_states(params: llama.Params, tokens: torch.Tensor,
                  config: llama.LlamaConfig, mesh=None) -> torch.Tensor:
    """tokens (B, S) -> hidden states (B, S, d) after the final norm: the
    quant-aware, mesh-aware layer stack of :func:`prefill` (K2 causal
    without lse, K3) with no KV cache.  Under a mesh every rank returns
    the same rows."""
    batch, seq = tokens.shape
    cos, sin = rope_tables(config, seq, tokens.device)
    h = _embed(params, tokens, config, mesh)
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p = lp['attn']
        x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
        q, k, v = _qkv(x, attn_p, config)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        o = attention_ops.flash_attention(q, k, v, causal=True)
        h = h + _attn_out(o.reshape(batch, seq, -1), attn_p, mesh)
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config, mesh)
    return rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)


def encode(params: llama.Params, tokens: torch.Tensor,
           config: llama.LlamaConfig, lengths: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """Mean-pooled final hidden states (B, d) f32 over each row's valid
    prefix: the /v1/embeddings path, over :func:`hidden_states`.  Causal
    attention keeps each row's valid prefix blind to the bucket's right
    padding, and the mask drops the padding from the mean, so a row's
    vector does not depend on the bucket or the batch it rides in (up to
    the rounding of the batched products)."""
    seq = tokens.shape[1]
    h = hidden_states(params, tokens, config, mesh)
    mask = (torch.arange(seq, device=h.device)[None, :]
            < lengths.to(h.device)[:, None]).to(h.dtype)
    pooled = (h * mask[..., None]).sum(dim=1) / torch.clamp_min(
        mask.sum(dim=1), 1.0)[:, None]
    return pooled.float()


def prefill_window(params: llama.Params, tokens_w: torch.Tensor,
                   config: llama.LlamaConfig, cache: Cache, slot: int,
                   start: int, mesh=None) -> Tuple[torch.Tensor, Cache]:
    """Advance ONE slot's prefill by a window (chunked prefill over the
    contiguous cache of the legacy planes): queries at positions
    [start, start + W) attend over the slot's cache prefix and the
    window itself; the window's K/V are written to cache[:, slot,
    start:start + W) in place.

    tokens_w: (W,); cache: (L, B, S, KV, hd).  Pad tokens past the
    prompt are written but sit above every later query's mask.  Window
    rows past the cache's S rows are dropped, as the JAX scatter drops
    them (their rotation clamps to the last row, like the JAX gather).
    Under a mesh every rank runs the window on its heads and its cache
    of its KV heads, the combines as in prefill.
    Returns (hidden states (W, d) after the final norm, cache)."""
    (w,) = tokens_w.shape
    s_len = cache['k'].shape[2]
    device = tokens_w.device
    cos, sin = rope_tables(config, s_len, device)
    h = _embed(params, tokens_w[None], config, mesh)         # (1, W, d)
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
        h = h + _attn_out(o.reshape(1, w, -1), attn_p, mesh)
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config, mesh)
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
    q_g = q[0].reshape(w, k_slot.shape[1], -1, config.head_dim)
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
                          table_row: torch.Tensor, start: int, mesh=None
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
    h = _embed(params, tokens_w[None], config, mesh)         # (1, W, d)
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
        h = h + _attn_out(o.reshape(1, w, -1), attn_p, mesh)
        x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
        h = h + _ffn(x, lp, config, mesh)
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
                   positions: torch.Tensor, kernel: bool, mesh=None
                   ) -> Tuple[torch.Tensor, Cache]:
    """One-token step over the contiguous (L, B, S, KV, hd) cache: each
    layer writes its new K/V row in place at (layer, b, positions[b]),
    then attends over the layer with keys <= positions[b] visible.
    kernel: K7 (the 'paged' plane); else the plain masked math of the
    JAX inplace/scan/unroll steps.  Under a mesh every rank decodes
    every slot (the cache is replicated over dp, as the reference's
    CACHE_SPEC) on its heads over its cache of its KV heads (K7 per
    shard), with the pooled steps' rank-order combines (_layer_stack's
    synchronous path)."""
    batch = token.shape[0]
    s_len, kv_heads = cache['k'].shape[2], cache['k'].shape[3]
    cos, sin = rope_tables(config, s_len, token.device)
    h = _embed(params, token, config, mesh)[:, None]        # (B, 1, d)
    pos = positions.long()[:, None]
    b_idx = torch.arange(batch, device=token.device)

    def write(i, k, v):
        _write_kv(cache, (i, b_idx, pos[:, 0]), k[:, 0], v[:, 0])

    def attend(i, q):
        q_g = q.reshape(batch, 1, kv_heads, -1, config.head_dim)
        if kernel:
            o = decode_attention_ops.decode_attention(
                q_g[:, 0], cache['k'], cache['v'], i, positions,
                cache.get('k_scale'), cache.get('v_scale'))
        else:
            scales = [cache[key][i] if key in cache else None
                      for key in ('k_scale', 'v_scale')]
            o = decode_attention_ops._token_attention(
                q_g, cache['k'][i], cache['v'][i], positions, *scales)
        return o.reshape(batch, 1, -1)

    h = _layer_stack(params, h, config, mesh, None, cos, sin, pos, write,
                     attend)
    return _final(h[:, 0], params, config, mesh), cache


def decode_step_inplace(params: llama.Params, token: torch.Tensor,
                        config: llama.LlamaConfig, cache: Cache,
                        positions: torch.Tensor, mesh=None
                        ) -> Tuple[torch.Tensor, Cache]:
    """One-token step of the 'inplace', 'scan' and 'unroll' planes over
    the contiguous cache, updated in place: plain masked attention over
    each layer's full (B, S, KV, hd) slice (an int8 cache's scales
    applied after each contraction).  token (B,); positions (B,) int32,
    each slot's current cache row.  Returns (logits (B, vocab) f32,
    cache)."""
    return _decode_contig(params, token, config, cache, positions,
                          kernel=False, mesh=mesh)


def decode_step_paged(params: llama.Params, token: torch.Tensor,
                      config: llama.LlamaConfig, cache: Cache,
                      positions: torch.Tensor, mesh=None
                      ) -> Tuple[torch.Tensor, Cache]:
    """decode_step_inplace with attention through K7
    (ops.decode_attention.decode_attention), which reads only each
    slot's live rows straight from the stacked cache, dequantizing an
    int8 cache before each product.  Needs S % 64 == 0 and
    head_dim % 128 == 0."""
    return _decode_contig(params, token, config, cache, positions,
                          kernel=True, mesh=mesh)


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result, never rounded to x's dtype (the
    reference's preferred_element_type=f32)."""
    if x.dtype == torch.float32 or x.device.type == 'cpu':
        return x.float() @ w.float()
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _combine_then_project(pending, h, gain, weights, mesh, chunks, eps):
    """h_new = h + combine(pending), then rms_norm(h_new, gain) @ W for
    each weight, with the combine's chunks (> 1) feeding the projections
    as they land.  pending None: h_new = h (the first layer).

    The norm is factorised, as the reference's overlapped path does:
    rms_norm(x, g) @ W == ((x * g) @ W) * rsqrt(mean(x^2) + eps), the
    per-row scalar commuting with the contraction, so each landed span
    (pipelined_psum's chunk_bounds(d_model, chunks)) starts its slice of
    the products while the next span's gather is in flight.  The
    combine is pipelined_psum's rank-order sum, so h_new is bitwise the
    synchronous path's; the projections round differently (f32 span
    products, the norm's scale last) and change with the chunk count.
    Returns (h_new, [y_j in h's dtype])."""
    d_model = h.shape[-1]
    ssq = torch.zeros(h.shape[:-1] + (1,), dtype=torch.float32,
                      device=h.device)
    accs = [None] * len(weights)
    gain_f = gain.float()

    def consume(ci, lo, span):
        nonlocal ssq
        hi = lo + span.shape[-1]
        hc = h[..., lo:hi] + span if pending is not None else span
        hcf = hc.float()
        ssq = ssq + (hcf * hcf).sum(-1, keepdim=True)
        t = (hcf * gain_f[lo:hi]).to(h.dtype)
        for j, w in enumerate(weights):
            y = _f32_product(t, w[lo:hi])
            accs[j] = y if accs[j] is None else accs[j] + y
        return hc

    if pending is None:
        spans = [consume(ci, lo, h[..., lo:hi]) for ci, (lo, hi) in
                 enumerate(collectives.chunk_bounds(d_model, chunks))]
    else:
        _, spans = collectives.pipelined_psum(
            pending, mesh, tp_lib.MODEL_AXES, chunks=chunks,
            on_chunk=consume)
    h_new = torch.cat(spans, dim=-1)
    inv = torch.rsqrt(ssq / d_model + eps)
    return h_new, [(a * inv).to(h.dtype) for a in accs]


def _layer_stack(params, h, config, mesh, overlap, cos, sin, rot, write,
                 attend):
    """The pooled steps' layer stack over rows h (R, W, d), identical on
    every rank.  rot (R, W): the rows' rope positions; write(i, k, v)
    stores layer i's K/V rows (R, W, KV, hd); attend(i, q) returns the
    rows' attention output (R, W, heads * hd).

    overlap None (the synchronous path): per layer K3, the whole
    projections, and the combines after wo and w_down (no combine
    without a mesh).  overlap = c > 1 chunks (a mesh of model size > 1,
    dense unquantized weights; engine.resolve_overlap): every combine
    goes through _combine_then_project; the post-attention combine's
    chunks feed gate/up, and the post-MLP combine rides to the next
    layer as an unreduced partial that its q/k/v products consume.
    Returns h after the last layer (before the final norm)."""
    hd = config.head_dim
    if overlap is None:
        for i in range(config.n_layers):
            lp = llama.layer_params(params, i)
            attn_p = lp['attn']
            x = rmsnorm_ops.rms_norm(h, lp['ln1'], eps=config.norm_eps)
            q, k, v = _qkv(x, attn_p, config)
            q = rope_ops.apply_rope(q, cos, sin, positions=rot)
            k = rope_ops.apply_rope(k, cos, sin, positions=rot)
            write(i, k, v)
            h = h + _attn_out(attend(i, q), attn_p, mesh)
            x = rmsnorm_ops.rms_norm(h, lp['ln2'], eps=config.norm_eps)
            h = h + _ffn(x, lp, config, mesh)
        return h
    eps = config.norm_eps
    pending = None
    rows, w = h.shape[:2]
    for i in range(config.n_layers):
        lp = llama.layer_params(params, i)
        attn_p, mlp_p = lp['attn'], lp['mlp']
        h, (q, k, v) = _combine_then_project(
            pending, h, lp['ln1'], [attn_p['wq'], attn_p['wk'], attn_p['wv']],
            mesh, overlap, eps)
        if 'bq' in attn_p:
            q, k, v = q + attn_p['bq'], k + attn_p['bk'], v + attn_p['bv']
        q = rope_ops.apply_rope(q.reshape(rows, w, -1, hd), cos, sin,
                                positions=rot)
        k = rope_ops.apply_rope(k.reshape(rows, w, -1, hd), cos, sin,
                                positions=rot)
        write(i, k, v.reshape(rows, w, -1, hd))
        part = quant.matmul(attend(i, q), attn_p['wo'])
        h, (g, u) = _combine_then_project(
            part, h, lp['ln2'], [mlp_p['w_gate'], mlp_p['w_up']], mesh,
            overlap, eps)
        pending = quant.matmul(llama.gate_activation(g, config.mlp_act) * u,
                               mlp_p['w_down'])
    red, _ = collectives.pipelined_psum(pending, mesh, tp_lib.MODEL_AXES,
                                        chunks=overlap)
    return h + red


def _final(h, params, config, mesh):
    """The final norm and the gathered f32 logits of rows h (..., d)."""
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    return logits(h, params, mesh)


def decode_step_pooled(params: llama.Params, token: torch.Tensor,
                       config: llama.LlamaConfig, cache: Cache,
                       positions: torch.Tensor, tables: torch.Tensor,
                       mesh=None, overlap: Optional[int] = None
                       ) -> Tuple[torch.Tensor, Cache]:
    """One-token step over the pooled block arena (the default data
    plane).

    token: (B,); positions: (B,) int32, each slot's current cache row;
    tables: (B, T) int32 block tables (unmapped entries are 0, the
    garbage block).  Each layer first writes the new K/V row in place at
    (layer, tables[b, pos // BS], pos % BS), then attends through the
    paged decode kernel on the same stream, so the row is visible to its
    own query.  Under a mesh, this rank's dp replica decodes its slot
    rows (tp.slot_rows) on its heads; the K/V rows of every replica are
    written, and the logits of every row returned.  Returns (logits
    (B, vocab) f32, cache)."""
    batch = token.shape[0]
    lo, hi = tp_lib.slot_rows(mesh, batch)
    bs = cache['k'].shape[2]
    t_width = tables.shape[1]
    cos, sin = rope_tables(config, t_width * bs, token.device)
    h = _embed(params, token[lo:hi], config, mesh)[:, None]   # (b, 1, d)
    pos_long = positions.long()
    b_idx = torch.arange(batch, device=token.device)
    blk = tables.long()[b_idx, pos_long // bs]
    off = pos_long % bs
    tables_l, positions_l = tables[lo:hi], positions[lo:hi]

    def write(i, k, v):
        _write_kv(cache, (i, blk, off), _dp_gather(k[:, 0], mesh),
                  _dp_gather(v[:, 0], mesh))

    def attend(i, q):
        q_r = q[:, 0].reshape(hi - lo, cache['k'].shape[3], -1,
                              config.head_dim)
        o = decode_attention_ops.decode_attention_pooled(
            q_r, cache['k'], cache['v'], tables_l, i, positions_l,
            cache.get('k_scale'), cache.get('v_scale'))
        return o.reshape(hi - lo, 1, -1)

    h = _layer_stack(params, h, config, mesh, overlap, cos, sin,
                     pos_long[lo:hi, None], write, attend)
    return _dp_gather(_final(h[:, 0], params, config, mesh), mesh), cache


def decode_verify_pooled(params: llama.Params, tokens: torch.Tensor,
                         config: llama.LlamaConfig, cache: Cache,
                         positions: torch.Tensor, tables: torch.Tensor,
                         mesh=None, overlap: Optional[int] = None
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
    cursor never advances over them.  Under a mesh the slot rows split
    over dp as in decode_step_pooled.  Returns ((B, W, vocab) f32
    logits, cache)."""
    batch, win = tokens.shape
    lo, hi = tp_lib.slot_rows(mesh, batch)
    bs = cache['k'].shape[2]
    t_width = tables.shape[1]
    cos, sin = rope_tables(config, t_width * bs, tokens.device)
    h = _embed(params, tokens[lo:hi], config, mesh)          # (b, W, d)
    pos_w = positions.long()[:, None] + torch.arange(win,
                                                     device=tokens.device)
    blk, off = _table_rows(tables, pos_w, bs)                # (B, W)
    # Rows past the table (garbage writes) take the last row's rotation,
    # as the JAX package's clamped gather does.
    rot = torch.clamp_max(pos_w, t_width * bs - 1)[lo:hi]
    tables_l, positions_l = tables[lo:hi], positions[lo:hi]

    def write(i, k, v):
        _write_kv(cache, (i, blk, off), _dp_gather(k, mesh),
                  _dp_gather(v, mesh))

    def attend(i, q):
        o = decode_attention_ops.decode_window_attention_pooled(
            q.reshape(hi - lo, win, cache['k'].shape[3], -1,
                      config.head_dim),
            cache['k'], cache['v'], tables_l, i, positions_l,
            cache.get('k_scale'), cache.get('v_scale'))
        return o.reshape(hi - lo, win, -1)

    h = _layer_stack(params, h, config, mesh, overlap, cos, sin, rot,
                     write, attend)
    return _dp_gather(_final(h, params, config, mesh), mesh), cache


def fused_step_pooled(params: llama.Params, token: torch.Tensor,
                      config: llama.LlamaConfig, cache: Cache,
                      positions: torch.Tensor, tables: torch.Tensor,
                      pf_tokens: torch.Tensor, pf_table_row: torch.Tensor,
                      pf_start: int, mesh=None,
                      overlap: Optional[int] = None
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
    nothing.  Under a mesh the decode rows split over dp and the prefill
    lane is replicated over it.  Returns (decode logits (B, vocab) f32,
    chunk hiddens (F, d) after the final norm, cache)."""
    batch = token.shape[0]
    lo, hi = tp_lib.slot_rows(mesh, batch)
    b_l = hi - lo
    fuse = pf_tokens.shape[0]
    bs = cache['k'].shape[2]
    t_width = tables.shape[1]
    device = token.device
    cos, sin = rope_tables(config, t_width * bs, device)
    h = _embed(params, torch.cat([token[lo:hi], pf_tokens]), config,
               mesh)[:, None]                                # (b+F, 1, d)
    pf_pos = pf_start + torch.arange(fuse, device=device)
    # Pad rows past the table take the last row's rotation (the JAX
    # package's clamped gather); they only write the garbage block.
    pos = torch.clamp_max(torch.cat([positions.long()[lo:hi], pf_pos]),
                          t_width * bs - 1)[:, None]
    dec_blk, dec_off = _table_rows(tables, positions.long()[:, None], bs)
    pf_blk, pf_off = _table_rows(pf_table_row, pf_pos, bs)
    blk = torch.cat([dec_blk[:, 0], pf_blk])
    off = torch.cat([dec_off[:, 0], pf_off])
    tables_l, positions_l = tables[lo:hi], positions[lo:hi]

    def write(i, k, v):
        rows_k = torch.cat([_dp_gather(k[:b_l, 0], mesh), k[b_l:, 0]])
        rows_v = torch.cat([_dp_gather(v[:b_l, 0], mesh), v[b_l:, 0]])
        _write_kv(cache, (i, blk, off), rows_k, rows_v)

    def attend(i, q):
        kv_shape = (cache['k'].shape[3], -1, config.head_dim)
        o_dec, o_pf = decode_attention_ops.fused_step_attention_pooled(
            q[:b_l, 0].reshape((b_l,) + kv_shape),
            q[b_l:, 0].reshape((fuse,) + kv_shape), cache['k'],
            cache['v'], tables_l, pf_table_row, i, positions_l, pf_start,
            cache.get('k_scale'), cache.get('v_scale'))
        return torch.cat([o_dec, o_pf]).reshape(b_l + fuse, 1, -1)

    h = _layer_stack(params, h, config, mesh, overlap, cos, sin, pos,
                     write, attend)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    dec_logits = logits(h[:b_l, 0], params, mesh)
    return _dp_gather(dec_logits, mesh), h[b_l:, 0], cache
