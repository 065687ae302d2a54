"""Decode attention over the KV cache: hand-written CUDA kernels
(csrc/paged_decode.cu, csrc/paged_window.cu) and their plain PyTorch
versions.

Counterpart of skypilot_tpu/ops/decode_attention.py.  Three kernels
replace the TPU's ``_decode_attn_kernel`` (and ``_pooled_attn_kernel``,
which runs that body through block tables):

- ``decode_attention_pooled`` (window 1, K1): one query token per slot
  over the pooled arena.
- ``decode_window_attention_pooled`` (window W, K4): W query tokens per
  slot, row w seeing keys <= positions + w; the speculative verify step.
  ``fused_step_attention_pooled`` composes the two for the fused
  prefill+decode step (its prefill lane is K4 with one slot).
- ``decode_attention`` (K7): one query token per slot over the
  contiguous, length-bucketed (L, B, S, KV, hd) cache of the legacy
  ``decode_impl='paged'`` plane.  K1 and K7 share one CUDA body and
  differ in how a key row is found.

Each kernel reads only its slot's live keys, from a bf16/f32 cache or an
int8 cache with per-(row, KV head) f32 scales.  K1 and K7 split a slot's
keys across blocks (split-KV, :func:`_decode_splits`), and so does K4's
tensor-core route (:func:`_window_splits`); with more than one split a
second, deterministic pass sums the blocks' partials
(:func:`_combine_splits_plain` is its plain version).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _kernels

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8

# Cache-length granularity of the contiguous decode (K7): the legacy
# 'paged' plane's cache buckets are multiples of it, as on the TPU.
DEFAULT_BLOCK = 64

# Keys a K1/K7 block stages at a time (kDecChunk in csrc/paged_decode.cu);
# a split's length is a multiple of it.
_DECODE_CHUNK = 32
# Blocks an SM that the split policy aims for when every slot is full:
# K1/K7's, and K4's (of 1, 2, 4 and 8, four were fastest at the verify
# and fused-lane shapes: scripts/torch_window_splits.py).
_BLOCKS_PER_SM = 2
_WINDOW_BLOCKS_PER_SM = 4
# The combine keeps a weight per (query row, split) in 48 KB of shared
# memory.
_MAX_SPLITS = 48 * 1024 // (4 * _MAX_GROUP)
# Keys a K4 tensor-core block stages at a time (kWinKeys in
# csrc/paged_window.cu; a split's length is a multiple of it), and query
# rows of its tile (kWinTcRows).
_WINDOW_CHUNK = 64
_WINDOW_ROWS = 64
_SM_COUNTS = {}


@functools.lru_cache(maxsize=None)
def _decode_splits(batch: int, kv_heads: int, capacity: int, chunk: int,
                   sms: int, per_sm: int = _BLOCKS_PER_SM
                   ) -> Tuple[int, int]:
    """(splits, split_len) of a K1/K7 launch: block s of a (slot, KV
    head) takes keys [s * split_len, (s + 1) * split_len).

    A fixed function of what the host knows before the launch (batch, KV
    heads, the capacity in keys, the chunk and the SM count), never of
    the positions, so one launch fits every step of a decode chunk.  Aims
    for per_sm blocks an SM when every slot is full: splits =
    ceil(per_sm SMs / (B KV)), at most one chunk a split (and
    _MAX_SPLITS), split_len rounded up to the chunk, and splits trimmed
    so that none starts past the capacity.  B KV >= per_sm SMs gives one
    split."""
    max_splits = min(max(1, -(-capacity // chunk)), _MAX_SPLITS)
    splits = min(max(1, -(-per_sm * sms // (batch * kv_heads))),
                 max_splits)
    split_len = -(-capacity // splits)
    split_len = max(chunk, -(-split_len // chunk) * chunk)
    return max(1, -(-capacity // split_len)), split_len


@functools.lru_cache(maxsize=None)
def _window_splits(batch: int, kv_heads: int, row_tiles: int,
                   capacity: int, chunk: int, sms: int) -> Tuple[int, int]:
    """(splits, split_len) of a K4 tensor-core launch: block s of a
    (slot, KV head, row tile) takes keys [s * split_len, (s + 1) *
    split_len) up to the tile's deepest visible key.

    :func:`_decode_splits`'s policy over the launch's batch x row_tiles
    blocks a KV head: a fixed function of sizes the host knows (never of
    positions, so one launch fits a captured step), about
    _WINDOW_BLOCKS_PER_SM blocks an SM when every slot is full."""
    return _decode_splits(batch * row_tiles, kv_heads, capacity, chunk, sms,
                          _WINDOW_BLOCKS_PER_SM)


def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of `device` (read once per device)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNTS[index]


def _live_splits(positions: torch.Tensor, capacity: int,
                 split_len: int) -> torch.Tensor:
    """(B,) splits that hold keys of each slot: ceil(min(pos + 1,
    capacity) / split_len), at least 1 (what the combine kernel reads)."""
    n_keys = torch.clamp(positions.long() + 1, max=capacity)
    return torch.clamp_min(-(-n_keys // split_len), 1)


def _window_live_splits(positions: torch.Tensor, win: int, group: int,
                        capacity: int, split_len: int) -> torch.Tensor:
    """(B, W * G) splits that hold keys of each K4 row r = w * G + g:
    floor(min(pos + w, capacity - 1) / split_len) + 1, every split that
    holds the row's first key (what K4's combine kernel reads)."""
    last = torch.clamp_max(positions.long()[:, None] + torch.arange(
        win, device=positions.device), capacity - 1)
    return (last // split_len + 1).repeat_interleave(group, dim=1)


def _combine_splits_plain(m: torch.Tensor, l: torch.Tensor,
                          acc: torch.Tensor,
                          live: torch.Tensor) -> torch.Tensor:
    """The split-KV combine: m, l (B, KV, S, R) are each split's running
    max and sum of e^(s - m) for R query rows (K1/K7: the G rows of a KV
    head; K4: its W * G rows), acc (B, KV, S, R, hd) its unnormalised
    P.V; only splits [0, live) hold partials of a row (the rest are never
    written and may hold anything), live (B,) for every row of a slot or
    (B, R) per row.  Returns the f32 (B, KV, R, hd) o = sum_s e^(m_s - M)
    acc_s / sum_s e^(m_s - M) l_s, M the max of the live m_s."""
    live = live.to(m.device)
    if live.dim() == 1:
        live = live[:, None]
    alive = (torch.arange(m.shape[2], device=m.device)[None, :, None]
             < live[:, None, :])[:, None]            # (B, 1, S, R or 1)
    m_live = torch.where(alive, m, _NEG_INF)
    w = torch.where(alive, torch.exp(m_live - m_live.amax(2, keepdim=True)),
                    0.0)
    num = (w[..., None] * torch.where(alive[..., None], acc, 0.0)).sum(2)
    den = (w * torch.where(alive, l, 0.0)).sum(2)
    return num / den[..., None]


def _gather_layer(arena: torch.Tensor, tables: torch.Tensor,
                  layer: int) -> torch.Tensor:
    """(L, NB, BS, ...) arena -> (B, T * BS, ...) logical view of one
    layer through the block table (k/v rows or their int8 scales)."""
    batch, t_width = tables.shape
    bs = arena.shape[2]
    return arena[layer][tables.long()].reshape(
        (batch, t_width * bs) + tuple(arena.shape[3:]))


def _dequantize(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """int8 rows (..., hd) times their (...) scale, in `dtype` (the JAX
    ``llama_infer._dequantize``: both factors rounded to dtype first)."""
    return q.to(dtype) * scale[..., None].to(dtype)


def _token_attention(q: torch.Tensor, k_eff: torch.Tensor,
                     v_eff: torch.Tensor, positions: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked GQA attention of q (B, W, KV, G, hd) over contiguous
    (B, S, KV, hd) cache views: the math of the JAX decode off the TPU
    (llama_infer._token_attention).  f32 scores and softmax over a
    (B, W, S) mask (window row w sees keys <= positions + w),
    probabilities cast to q's dtype before P.V.  An int8 view takes its
    (B, S, KV) scales after each contraction, to the scores and to the
    probabilities.  Returns (B, W, KV, G, hd) in q's dtype."""
    win = q.shape[1]
    s = torch.einsum('bwkgd,bskd->bwkgs', q.float(),
                     k_eff.to(q.dtype).float()) * q.shape[-1] ** -0.5
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, None, :, None, :]
    rows = positions.long()[:, None] + torch.arange(win, device=q.device)
    visible = (torch.arange(k_eff.shape[1], device=q.device)[None, None, :]
               <= rows[:, :, None])                       # (B, W, S)
    s = torch.where(visible[:, :, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, None, :, None, :]
    return torch.einsum('bwkgs,bskd->bwkgd', p.to(q.dtype),
                        v_eff.to(q.dtype))


def _decode_window_attention_plain(q: torch.Tensor, k_arena: torch.Tensor,
                                   v_arena: torch.Tensor,
                                   tables: torch.Tensor, layer: int,
                                   positions: torch.Tensor,
                                   k_scale: Optional[torch.Tensor] = None,
                                   v_scale: Optional[torch.Tensor] = None,
                                   dequantize_first: bool = False
                                   ) -> torch.Tensor:
    """Gather through the table, then :func:`_token_attention`.

    int8 follows the JAX CPU path that calls it: the decode and verify
    rows (llama_infer._token_attention) apply the scales after each
    contraction; the fused prefill lane (dequantize_first) dequantizes K
    and V in q's dtype before the products, as prefill_window_pooled
    does."""
    k_eff = _gather_layer(k_arena, tables, layer)
    v_eff = _gather_layer(v_arena, tables, layer)
    ks = vs = None
    if k_scale is not None:
        ks = _gather_layer(k_scale, tables, layer)       # (B, S, KV)
        vs = _gather_layer(v_scale, tables, layer)
        if dequantize_first:
            k_eff = _dequantize(k_eff, ks, q.dtype)
            v_eff = _dequantize(v_eff, vs, q.dtype)
            ks = vs = None
    return _token_attention(q, k_eff, v_eff, positions, ks, vs)


def _decode_attention_plain(q: torch.Tensor, k_arena: torch.Tensor,
                            v_arena: torch.Tensor, tables: torch.Tensor,
                            layer: int, positions: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The window plain version at W = 1 (the single-token decode of the
    JAX package off the TPU)."""
    return _decode_window_attention_plain(
        q[:, None], k_arena, v_arena, tables, layer, positions, k_scale,
        v_scale)[:, 0]


def _decode_attention_contig_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor, layer: int,
                                   positions: torch.Tensor,
                                   k_scale: Optional[torch.Tensor] = None,
                                   v_scale: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """K7's plain version, with the numerics of the TPU kernel that the
    JAX package runs on the CPU too (interpret mode,
    decode_attention.py:79-124): q, K and V in f32, an int8 cache
    dequantized in f32 BEFORE each product, f32 probabilities, and only
    the output cast to q's dtype.  (The pooled plane's CPU math,
    :func:`_token_attention`, differs in all three.)"""
    k = k_cache[layer].float()                            # (B, S, KV, hd)
    v = v_cache[layer].float()
    if k_scale is not None:
        k = k * k_scale[layer][..., None]
        v = v * v_scale[layer][..., None]
    s = torch.einsum('bkgd,bskd->bkgs', q.float(), k) * q.shape[-1] ** -0.5
    visible = (torch.arange(k.shape[1], device=q.device)[None, :]
               <= positions.long()[:, None])              # (B, S)
    s = torch.where(visible[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum('bkgs,bskd->bkgd', p, v).to(q.dtype)


def reference_decode_attention(q: torch.Tensor, k_layer: torch.Tensor,
                               v_layer: torch.Tensor,
                               positions: torch.Tensor) -> torch.Tensor:
    """All-f32 oracle over one layer's gathered (B, S, KV, hd) slice,
    the port of the JAX ``reference_decode_attention``."""
    return reference_decode_window_attention(q[:, None], k_layer, v_layer,
                                             positions)[:, 0]


def reference_decode_window_attention(q: torch.Tensor,
                                      k_layer: torch.Tensor,
                                      v_layer: torch.Tensor,
                                      positions: torch.Tensor
                                      ) -> torch.Tensor:
    """All-f32 oracle over a gathered (B, S, KV, hd) layer slice, the
    port of the JAX ``reference_decode_window_attention``.
    q: (B, W, KV, G, hd); window row w masks keys at index <= positions
    + w."""
    win = q.shape[1]
    s = torch.einsum('bwkgd,bskd->bwkgs', q.float(),
                     k_layer.float()) * q.shape[-1] ** -0.5
    rows = positions.long()[:, None] + torch.arange(win, device=q.device)
    visible = (torch.arange(k_layer.shape[1], device=q.device)[None, None, :]
               <= rows[:, :, None])
    s = torch.where(visible[:, :, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum('bwkgs,bskd->bwkgd', p, v_layer.float())
    return o.to(q.dtype)


def reference_fused_step_attention(q_dec: torch.Tensor, k_dec: torch.Tensor,
                                   v_dec: torch.Tensor,
                                   positions: torch.Tensor,
                                   q_pf: torch.Tensor, k_pf: torch.Tensor,
                                   v_pf: torch.Tensor, pf_start: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-f32 oracle of :func:`fused_step_attention_pooled` over gathered
    layer slices: k_dec/v_dec (B, S, KV, hd) are the decode slots' views,
    k_pf/v_pf (S, KV, hd) the prefill slot's."""
    o_dec = reference_decode_attention(q_dec, k_dec, v_dec, positions)
    start = torch.tensor([int(pf_start)], device=q_pf.device)
    o_pf = reference_decode_window_attention(q_pf[None], k_pf[None],
                                             v_pf[None], start)
    return o_dec, o_pf[0]


def _check_arena(kernel: str, q: torch.Tensor, k_arena: torch.Tensor,
                 v_arena: torch.Tensor, tables: Optional[torch.Tensor],
                 layer: int, positions: torch.Tensor,
                 k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor], kv_heads: int, group: int,
                 head_dim: int) -> Tuple[int, int]:
    """Shape, dtype, device and layout checks shared by the kernels (q's
    layout is each kernel's own).  tables None: a contiguous (L, B, S,
    KV, hd) cache, whose axis 1 must be q's batch.  Returns (q dtype
    code, cache dtype code)."""
    # Serving kernels have no backward (the TPU kernels have no vjp): a
    # graph through them would lose its gradient without a word.
    _kernels.check(not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k_arena, v_arena))),
        f'{kernel}: no backward; an input requires grad (serving only)')
    batch = q.shape[0]
    n_layers = k_arena.shape[0]
    q_code = _kernels.dtype_code(q, kernel)
    quantized = k_arena.dtype == torch.int8
    _kernels.check(v_arena.dtype == k_arena.dtype
                   and (k_arena.dtype == q.dtype or quantized),
                   f'{kernel}: arena dtype must match q, or be int8')
    _kernels.check(quantized == (k_scale is not None)
                   and quantized == (v_scale is not None),
                   f'{kernel}: k_scale/v_scale go with an int8 arena')
    _kernels.check(v_arena.shape == k_arena.shape and k_arena.dim() == 5
                   and tuple(k_arena.shape[3:]) == (kv_heads, head_dim),
                   f'{kernel}: arena {tuple(k_arena.shape)} does not fit '
                   f'q {tuple(q.shape)}')
    scales = ()
    if quantized:
        scales = (k_scale, v_scale)
        for sc in scales:
            _kernels.check(sc.dtype == torch.float32
                           and sc.shape == k_arena.shape[:4],
                           f'{kernel}: scales must be f32 '
                           f'{tuple(k_arena.shape[:4])}')
    _kernels.check(head_dim in _HEAD_DIMS, f'{kernel}: '
                   f'head_dim {head_dim} not in {_HEAD_DIMS}')
    _kernels.check(0 <= layer < n_layers, f'{kernel}: '
                   f'layer {layer} out of range')
    _kernels.check(positions.dtype == torch.int32
                   and positions.shape == (batch,),
                   f'{kernel}: positions (B,) must be int32')
    if tables is None:
        _kernels.check(k_arena.shape[1] == batch, f'{kernel}: cache batch '
                       f'{k_arena.shape[1]} is not q\'s {batch}')
        tensors = (k_arena, v_arena, positions) + scales
    else:
        _kernels.check(tables.dtype == torch.int32 and tables.dim() == 2
                       and tables.shape[0] == batch,
                       f'{kernel}: tables (B, T) must be int32')
        tensors = (k_arena, v_arena, tables, positions) + scales
    _kernels.check(len({t.device for t in tensors + (q,)}) == 1,
                   f'{kernel}: inputs on several devices')
    for t in tensors:
        _kernels.check(t.is_contiguous() and _kernels.aligned(t),
                       f'{kernel}: inputs must be contiguous and 16-byte '
                       'aligned')
    return q_code, _kernels.KV_DTYPE_CODES[k_arena.dtype]


def _scale_ptrs(k_scale, v_scale):
    if k_scale is None:
        return None, None
    return k_scale.data_ptr(), v_scale.data_ptr()


def _split_partials(q: torch.Tensor, scratch: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Views of a split launch's f32 scratch: acc (B, KV, splits, R, hd),
    then (m, l) (B, KV, splits, R, 2), for K1/K7's q (B, KV, G, hd) (R =
    G) or K4's (B, W, KV, G, hd) (R = W * G, row w * G + g)."""
    if q.dim() == 5:
        batch, win, kv_heads, group, head_dim = q.shape
        rows = win * group
    else:
        batch, kv_heads, rows, head_dim = q.shape
    splits = scratch.numel() // (batch * kv_heads * rows * (head_dim + 2))
    n = batch * kv_heads * splits * rows
    return (scratch[:n * head_dim].view(batch, kv_heads, splits, rows,
                                        head_dim),
            scratch[n * head_dim:].view(batch, kv_heads, splits, rows, 2))


def _launch_split(entry: str, counter, q: torch.Tensor, capacity: int,
                  operands, sizes, layer: int, q_code: int, kv_code: int):
    """Launch K1 or K7 (`entry`) with the split policy of
    :func:`_decode_splits`; `operands` are its pointers up to positions,
    `sizes` its cache sizes.  Returns (out, scratch, split_len): scratch
    is the flat f32 buffer of the partials (:func:`_split_partials`), None
    with one split."""
    batch, kv_heads, group, head_dim = q.shape
    _kernels.check(1 <= group <= _MAX_GROUP, f'{counter.__name__}: group '
                   f'{group} not in 1..{_MAX_GROUP}')
    _kernels.check(q.is_contiguous() and _kernels.aligned(q),
                   f'{counter.__name__}: inputs must be contiguous and '
                   '16-byte aligned')
    splits, split_len = _decode_splits(batch, kv_heads, capacity,
                                       _DECODE_CHUNK, _sm_count(q.device))
    out = torch.empty_like(q)
    scratch = acc_ptr = ml_ptr = None
    if splits > 1:
        n = batch * kv_heads * splits * group
        scratch = torch.empty(n * (head_dim + 2), dtype=torch.float32,
                              device=q.device)
        acc_ptr = scratch.data_ptr()
        ml_ptr = acc_ptr + 4 * n * head_dim
    _kernels.launch(entry, q.device, *operands, out.data_ptr(), acc_ptr,
                    ml_ptr, batch, kv_heads, group, head_dim, *sizes,
                    int(layer), splits, split_len, float(head_dim ** -0.5),
                    q_code, kv_code)
    counter.launches += 1
    if splits > 1:
        counter.launches_split += 1
    return out, scratch, split_len


def _decode_attention_cuda(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, tables: torch.Tensor,
                           layer: int, positions: torch.Tensor,
                           k_scale: Optional[torch.Tensor],
                           v_scale: Optional[torch.Tensor]):
    """K1; returns (out, scratch, split_len) as :func:`_launch_split`."""
    batch, kv_heads, group, head_dim = q.shape
    q_code, kv_code = _check_arena(
        'decode_attention_pooled', q, k_arena, v_arena, tables, layer,
        positions, k_scale, v_scale, kv_heads, group, head_dim)
    n_blocks, block_size, t_width = (k_arena.shape[1], k_arena.shape[2],
                                     tables.shape[1])
    return _launch_split(
        'skk_paged_decode', decode_attention_pooled, q, t_width * block_size,
        (q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
         *_scale_ptrs(k_scale, v_scale), tables.data_ptr(),
         positions.data_ptr()),
        (n_blocks, block_size, t_width), layer, q_code, kv_code)


def _decode_combine_cuda(acc: torch.Tensor, ml: torch.Tensor,
                         positions: torch.Tensor, capacity: int,
                         split_len: int, dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel alone on the partials of a split launch
    (:func:`_split_partials`; the launch runs it itself): (B, KV, G, hd)
    in `dtype`.  Checked against :func:`_combine_splits_plain` on the
    card; no main path calls it."""
    batch, kv_heads, splits, group, head_dim = acc.shape
    out = torch.empty(batch, kv_heads, group, head_dim, dtype=dtype,
                      device=acc.device)
    _kernels.launch('skk_decode_combine', acc.device, acc.data_ptr(),
                    ml.data_ptr(), positions.data_ptr(), out.data_ptr(),
                    batch, kv_heads, group, head_dim, splits, split_len,
                    capacity, _kernels.DTYPE_CODES[dtype])
    return out


def decode_attention_pooled(q: torch.Tensor, k_arena: torch.Tensor,
                            v_arena: torch.Tensor, tables: torch.Tensor,
                            layer: int, positions: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Single-token GQA attention over a pooled block arena.

    q: (B, KV, G, hd) current-token queries (post-rope), head h = kv*G+g.
    k_arena/v_arena: (L, NB, BS, KV, hd) in q's dtype, or int8 with
    k_scale/v_scale (L, NB, BS, KV) f32; tables: (B, T) int32, where
    tables[b, j] is the arena block of slot b's logical rows
    [j*BS, (j+1)*BS); layer: int; positions: (B,) int32, the current
    cache row (rows <= positions[b] are attended).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    which raises on a dtype, shape or layout it does not take.
    Returns (B, KV, G, hd) in q's dtype."""
    if q.device.type == 'cpu':
        return _decode_attention_plain(q, k_arena, v_arena, tables, layer,
                                       positions, k_scale, v_scale)
    return _decode_attention_cuda(q, k_arena, v_arena, tables, layer,
                                  positions, k_scale, v_scale)[0]


# launches_split: launches with more than one split (a combine pass
# after the blocks).
_kernels.counter(decode_attention_pooled, 'launches', 'launches_split')


def _decode_attention_contig_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor, layer: int,
                                  positions: torch.Tensor,
                                  k_scale: Optional[torch.Tensor],
                                  v_scale: Optional[torch.Tensor]):
    """K7; returns (out, scratch, split_len) as :func:`_launch_split`."""
    batch, kv_heads, group, head_dim = q.shape
    q_code, kv_code = _check_arena(
        'decode_attention', q, k_cache, v_cache, None, layer, positions,
        k_scale, v_scale, kv_heads, group, head_dim)
    s_len = k_cache.shape[2]
    return _launch_split(
        'skk_contig_decode', decode_attention, q, s_len,
        (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
         *_scale_ptrs(k_scale, v_scale), positions.data_ptr()),
        (s_len,), layer, q_code, kv_code)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, layer: int,
                     positions: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Single-token GQA attention over the valid prefix of the
    contiguous cache (the legacy 'paged' decode plane, K7).

    q: (B, KV, G, hd) current-token queries (post-rope), head h = kv*G+g.
    k_cache/v_cache: (L, B, S, KV, hd) stacked cache, S % block == 0, in
    q's dtype, or int8 with k_scale/v_scale (L, B, S, KV) f32; layer:
    int, the stacked layer to read; positions: (B,) int32, the cache row
    of the current token (rows <= positions[b] are attended).

    Raises the JAX kernel's ValueErrors for S % block and head_dim % 128
    on every device.  A CPU tensor takes the plain version (the TPU
    kernel's numerics); a CUDA tensor takes the kernel, which raises on a
    dtype, shape or layout it does not take.
    Returns (B, KV, G, hd) in q's dtype."""
    s_len, head_dim = k_cache.shape[2], k_cache.shape[4]
    if s_len % block:
        raise ValueError(f'cache length {s_len} not a multiple of the '
                         f'decode block {block}')
    if head_dim % 128:
        raise ValueError(f'head_dim {head_dim} must be a multiple of '
                         f'128 for the TPU decode kernel')
    if q.device.type == 'cpu':
        return _decode_attention_contig_plain(q, k_cache, v_cache, layer,
                                              positions, k_scale, v_scale)
    return _decode_attention_contig_cuda(q, k_cache, v_cache, layer,
                                         positions, k_scale, v_scale)[0]


_kernels.counter(decode_attention, 'launches', 'launches_split')


def _window_route(q_code: int, head_dim: int) -> bool:
    """True when K4 takes its tensor-core kernel and the split policy
    (the library's skk_paged_window_route: bf16 q at head_dim 64 and
    128); False for the FMA kernel (f32, and bf16 at 256), one split."""
    return bool(_kernels.LIBRARY.get().skk_paged_window_route(q_code,
                                                              head_dim))


def _decode_window_attention_cuda(q: torch.Tensor, k_arena: torch.Tensor,
                                  v_arena: torch.Tensor,
                                  tables: torch.Tensor, layer: int,
                                  positions: torch.Tensor,
                                  k_scale: Optional[torch.Tensor],
                                  v_scale: Optional[torch.Tensor],
                                  counter):
    """K4 on (B, W, KV, G, hd) queries, read and written in that layout
    (a contiguous q is passed as it is); `counter` is the public wrapper
    whose launch counts this call adds to.  Returns (out, scratch,
    split_len) as :func:`_launch_split`."""
    batch, win, kv_heads, group, head_dim = q.shape
    q_code, kv_code = _check_arena(
        'decode_window_attention_pooled', q, k_arena, v_arena, tables,
        layer, positions, k_scale, v_scale, kv_heads, group, head_dim)
    q = q.contiguous()
    _kernels.check(_kernels.aligned(q), 'decode_window_attention_pooled: '
                   'q must be 16-byte aligned')
    n_blocks, block_size, t_width = (k_arena.shape[1], k_arena.shape[2],
                                     tables.shape[1])
    capacity = t_width * block_size
    tc = _window_route(q_code, head_dim)
    splits, split_len = 1, capacity
    if tc:
        row_tiles = -(-win * group // _WINDOW_ROWS)
        splits, split_len = _window_splits(batch, kv_heads, row_tiles,
                                           capacity, _WINDOW_CHUNK,
                                           _sm_count(q.device))
    out = torch.empty_like(q)
    scratch = acc_ptr = ml_ptr = None
    if splits > 1:
        n = batch * kv_heads * splits * win * group
        scratch = torch.empty(n * (head_dim + 2), dtype=torch.float32,
                              device=q.device)
        acc_ptr = scratch.data_ptr()
        ml_ptr = acc_ptr + 4 * n * head_dim
    _kernels.launch('skk_paged_window', q.device, q.data_ptr(),
                    k_arena.data_ptr(), v_arena.data_ptr(),
                    *_scale_ptrs(k_scale, v_scale), tables.data_ptr(),
                    positions.data_ptr(), out.data_ptr(), acc_ptr, ml_ptr,
                    batch, win, kv_heads, group, head_dim, n_blocks,
                    block_size, t_width, int(layer), splits, split_len,
                    float(head_dim ** -0.5), q_code, kv_code)
    counter.launches += 1
    counter.launches_tc += int(tc)
    counter.launches_split += int(splits > 1)
    return out, scratch, split_len


def _window_combine_cuda(acc: torch.Tensor, ml: torch.Tensor,
                         positions: torch.Tensor, win: int, capacity: int,
                         split_len: int) -> torch.Tensor:
    """K4's combine kernel alone on the partials of a split launch
    (:func:`_split_partials`; the launch runs it itself): (B, W, KV, G,
    hd) bf16.  Checked against :func:`_combine_splits_plain` on the card;
    no main path calls it."""
    batch, kv_heads, splits, rows, head_dim = acc.shape
    group = rows // win
    out = torch.empty(batch, win, kv_heads, group, head_dim,
                      dtype=torch.bfloat16, device=acc.device)
    _kernels.launch('skk_paged_window_combine', acc.device, acc.data_ptr(),
                    ml.data_ptr(), positions.data_ptr(), out.data_ptr(),
                    batch, win, kv_heads, group, head_dim, splits, split_len,
                    capacity)
    return out


def decode_window_attention_pooled(q: torch.Tensor, k_arena: torch.Tensor,
                                   v_arena: torch.Tensor,
                                   tables: torch.Tensor, layer: int,
                                   positions: torch.Tensor,
                                   k_scale: Optional[torch.Tensor] = None,
                                   v_scale: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """W-query speculative-verify attention over the pooled arena.

    Same arena/table contract as :func:`decode_attention_pooled`, with a
    window of W queries per slot: q (B, W, KV, G, hd), window row w at
    cache row positions[b] + w (the caller has already written all W
    rows' K/V); positions (B,) int32 is the cache row of window row 0.
    Row w masks keys at index <= positions + w, so the speculative tail
    after it is invisible.  W = 1 is :func:`decode_attention_pooled`.

    A CPU tensor takes the plain version (the verify rows' JAX CPU
    numerics); a CUDA tensor takes the K4 kernel.
    Returns (B, W, KV, G, hd) in q's dtype."""
    if q.device.type == 'cpu':
        return _decode_window_attention_plain(
            q, k_arena, v_arena, tables, layer, positions, k_scale, v_scale)
    return _decode_window_attention_cuda(
        q, k_arena, v_arena, tables, layer, positions, k_scale, v_scale,
        decode_window_attention_pooled)[0]


# Launches on the tensor-core kernel, and with more than one split.
_kernels.counter(decode_window_attention_pooled, 'launches', 'launches_tc',
                 'launches_split')


def fused_step_attention_pooled(q_dec: torch.Tensor, q_pf: torch.Tensor,
                                k_arena: torch.Tensor, v_arena: torch.Tensor,
                                tables: torch.Tensor,
                                pf_table_row: torch.Tensor, layer: int,
                                positions: torch.Tensor, pf_start: int,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention for the fused prefill+decode step: the decode slots'
    single-token queries q_dec (B, KV, G, hd) through K1, and F
    piggybacked prefill queries q_pf (F, KV, G, hd) of one prompt at rows
    pf_start .. pf_start + F - 1 through its table row pf_table_row (T,)
    as one K4 batch row of window F.  Adds no kernel math.

    On the CPU the prefill lane takes the plain version with the JAX
    window prefill's int8 numerics (dequantize, then the products).  The
    lane's K4 launches count on this function's ``launches``.
    Returns (o_dec (B, KV, G, hd), o_pf (F, KV, G, hd))."""
    o_dec = decode_attention_pooled(q_dec, k_arena, v_arena, tables, layer,
                                    positions, k_scale, v_scale)
    tbl = pf_table_row[None].to(torch.int32)
    start = torch.full((1,), int(pf_start), dtype=torch.int32,
                       device=q_pf.device)
    if q_pf.device.type == 'cpu':
        o_pf = _decode_window_attention_plain(
            q_pf[None], k_arena, v_arena, tbl, layer, start, k_scale,
            v_scale, dequantize_first=True)
    else:
        o_pf = _decode_window_attention_cuda(
            q_pf[None], k_arena, v_arena, tbl.contiguous(), layer, start,
            k_scale, v_scale, fused_step_attention_pooled)[0]
    return o_dec, o_pf[0]


_kernels.counter(fused_step_attention_pooled, 'launches', 'launches_tc',
                 'launches_split')
