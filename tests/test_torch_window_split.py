"""Split-KV window attention (K4's tensor-core route, skypilot_tpu_torch/
ops/decode_attention.py) on the CPU: the split policy, a plain emulation
of a split launch combined row by row against the plain version and the
JAX kernel, and the launch the wrapper makes (the kernel itself runs
only on the card: tests/test_torch_kernels.py).

Inputs are numpy draws from fixed seeds.  Tolerance: f32's, atol = rtol
= 2e-5 (every side computes in f32; the splits, the 64-key tiles and the
Pallas kernel's blocks sum in different orders).  An int8 arena is
dequantized in f32 before each product in the emulation and in the JAX
kernel; the plain version scales after each contraction, in f32.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.ops import decode_attention as j_da  # noqa: E402
from skypilot_tpu_torch.ops import _kernels  # noqa: E402
from skypilot_tpu_torch.ops import decode_attention as da  # noqa: E402
from tests.test_torch_decode_split import H100_SMS, _NoHostRead  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=2e-5)


# ---- the split policy ------------------------------------------------------

@pytest.mark.parametrize('batch,kv_heads,row_tiles,capacity,sms', [
    (8, 8, 1, 2048, H100_SMS),       # verify: B 8, W 13, G 4 (52 rows)
    (1, 8, 17, 2048, H100_SMS),      # the fused lane: W 264, G 4
    (1, 8, 1, 2048, H100_SMS),       # a fused chunk of 16 tokens
    (32, 8, 1, 2048, H100_SMS),      # 256 blocks, under 4 an SM
    (64, 8, 2, 4096, H100_SMS),      # past 4 an SM: one split
    (4, 2, 1, 80, H100_SMS),         # capacity not a multiple of the chunk
    (2, 1, 1, 17, 4),                # capacity below one chunk
    (3, 5, 3, 1000, 7),
])
def test_window_splits_cover_the_capacity(batch, kv_heads, row_tiles,
                                          capacity, sms):
    chunk = da._WINDOW_CHUNK
    splits, split_len = da._window_splits(batch, kv_heads, row_tiles,
                                          capacity, chunk, sms)
    assert splits >= 1 and split_len >= chunk and split_len % chunk == 0
    assert splits * split_len >= capacity           # every key has a block
    assert (splits - 1) * split_len < capacity      # no split starts past it
    if batch * kv_heads * row_tiles >= da._WINDOW_BLOCKS_PER_SM * sms:
        assert splits == 1
    elif capacity > chunk:
        # Fewer blocks than four an SM: split.
        assert splits >= 2


def test_window_splits_on_the_serving_shapes():
    """chip_smoke.py's phase 3 and 6 launches on 132 SMs: the verify
    window (B 8, one 64-row tile of 52 rows) in eight splits of 256 keys,
    the fused lane (B 1, 17 tiles of 1,056 rows) in four of 512."""
    assert da._window_splits(8, 8, 1, 2048, da._WINDOW_CHUNK, H100_SMS) == \
        (8, 256)
    assert da._window_splits(1, 8, 17, 2048, da._WINDOW_CHUNK,
                             H100_SMS) == (4, 512)


def test_window_live_splits_count_each_row():
    """Row r = w G + g reads splits 0 .. min(pos + w, capacity - 1) //
    split_len: the shallow rows of a window that crosses a split
    boundary read fewer splits than its deep rows."""
    positions = torch.tensor([0, 60, 250], dtype=torch.int32)
    live = da._window_live_splits(positions, 13, 2, 256, 64)
    assert live.shape == (3, 26)
    assert live[0].tolist() == [1] * 26
    assert live[1].tolist() == [1] * 8 + [2] * 18    # keys 60..63, 64..72
    assert live[2].tolist() == [4] * 26              # clamped at 255


# ---- partials and the combine ----------------------------------------------

def _block_partials(q, k, v, positions, splits, split_len, row_tile, chunk):
    """What each block of a K4 split launch leaves in scratch, in f32
    numpy: block (tile, s) of (slot b, KV head) takes keys [s L, min((s +
    1) L, n_keys)), n_keys one past the tile's deepest row's last visible
    key, in chunks, folding each into every row's running max m, sum l
    and accumulator acc under the row's mask key <= min(pos + w,
    capacity - 1) (the online softmax of csrc/paged_window.cu).  q (B, W,
    KV, G, hd); k, v (B, S, KV, hd) f32.  Returns m, l (B, KV, splits, W
    G) and acc (..., hd); a block that never runs, and a row of a block
    that holds none of the row's keys, leave NaN: the combine must read
    neither."""
    batch, win, kv_heads, group, hd = q.shape
    rows, capacity = win * group, k.shape[1]
    qr = q.transpose(0, 2, 1, 3, 4).reshape(batch, kv_heads, rows, hd)
    m = np.full((batch, kv_heads, splits, rows), np.nan, np.float32)
    l = np.full_like(m, np.nan)
    acc = np.full(m.shape + (hd,), np.nan, np.float32)
    scale = np.float32(hd ** -0.5)
    for b in range(batch):
        lim = np.minimum(positions[b] + np.arange(rows) // group,
                         capacity - 1)
        for t0 in range(0, rows, row_tile):
            rs = slice(t0, min(t0 + row_tile, rows))
            n_keys = int(lim[rs].max()) + 1
            for s in range(splits):
                start, end = s * split_len, min((s + 1) * split_len, n_keys)
                if start >= n_keys:
                    continue
                nr = rs.stop - rs.start
                m_run = np.full((kv_heads, nr), -1e30, np.float32)
                l_run = np.zeros((kv_heads, nr), np.float32)
                a_run = np.zeros((kv_heads, nr, hd), np.float32)
                for c0 in range(start, end, chunk):
                    keys = np.arange(c0, min(c0 + chunk, end))
                    vis = keys[None, :] <= lim[rs][:, None]      # (nr, n)
                    sc = np.einsum('krd,nkd->krn', qr[b, :, rs],
                                   k[b, keys]) * scale
                    sc = np.where(vis[None], sc, np.float32(-1e30))
                    m_new = np.maximum(m_run, sc.max(-1))
                    e = np.where(vis[None], np.exp(sc - m_new[..., None]), 0)
                    corr = np.exp(m_run - m_new)
                    l_run = l_run * corr + e.sum(-1)
                    a_run = a_run * corr[..., None] + np.einsum(
                        'krn,nkd->krd', e, v[b, keys])
                    m_run = m_new
                has = start <= lim[rs]
                m[b, :, s, rs] = np.where(has, m_run, np.nan)
                l[b, :, s, rs] = np.where(has, l_run, np.nan)
                acc[b, :, s, rs] = np.where(has[:, None], a_run, np.nan)
    return m, l, acc


def _arena_case(label, batch, win, kv_heads, group, hd, bs, t_width, pos,
                seed):
    """q, a 2-layer arena (int8 with f32 scales for 'int8'), scattered
    tables covering each slot's window, and the f32 gathered K/V of
    layer 1."""
    rng = np.random.RandomState(seed)
    nb = 1 + batch * t_width
    q = rng.randn(batch, win, kv_heads, group, hd).astype(np.float32)
    k = rng.randn(2, nb, bs, kv_heads, hd).astype(np.float32)
    v = rng.randn(2, nb, bs, kv_heads, hd).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((batch, t_width), np.int32)
    for b in range(batch):
        live = min((pos[b] + win - 1) // bs + 1, t_width)
        tables[b, :live] = perm[b * t_width:b * t_width + live]
    ks = vs = None
    if label == 'int8':
        ks = (np.abs(k).max(-1) / 127.0).astype(np.float32)
        vs = (np.abs(v).max(-1) / 127.0).astype(np.float32)
        k = np.round(k / ks[..., None]).astype(np.int8)
        v = np.round(v / vs[..., None]).astype(np.int8)
        k_f = k.astype(np.float32) * ks[..., None]
        v_f = v.astype(np.float32) * vs[..., None]
    else:
        k_f, v_f = k, v
    gathered = tuple(x[1][tables].reshape(batch, t_width * bs, kv_heads, hd)
                     for x in (k_f, v_f))
    return q, k, v, ks, vs, tables, gathered


@pytest.mark.parametrize('label', ['f32', 'int8'])
@pytest.mark.parametrize('win,group,pos,sms', [
    # The verify window (W 13, G 4: one 64-row tile); four 64-key splits.
    # Slot 1's window crosses key 64: its rows 0-3 see no key of split
    # 1, which the tile reads; slot 2's runs past the table.
    (13, 4, [0, 60, 250], 12),
    # A longer window (W 40, G 2: two tiles); slot 1's first tile reads
    # keys to 131, split 2, which only its rows w >= 28 see.
    (40, 2, [5, 100], 20),
])
def test_combined_window_splits_match_plain_and_jax(label, win, group, pos,
                                                    sms):
    """Each block's partials of a split launch, combined by
    _combine_splits_plain with per-row live counts, against K4's plain
    version and the JAX decode_window_attention_pooled in interpret
    mode."""
    batch, kv_heads, hd, bs, t_width, layer = len(pos), 2, 128, 16, 16, 1
    capacity = t_width * bs
    row_tiles = -(-win * group // da._WINDOW_ROWS)
    splits, split_len = da._window_splits(batch, kv_heads, row_tiles,
                                          capacity, da._WINDOW_CHUNK, sms)
    assert (splits, split_len) == (4, 64)
    positions = np.asarray(pos, np.int32)
    q, k, v, ks, vs, tables, (k_g, v_g) = _arena_case(
        label, batch, win, kv_heads, group, hd, bs, t_width, pos, 7 + win)
    m, l, acc = _block_partials(q, k_g, v_g, positions, splits, split_len,
                                da._WINDOW_ROWS, da._WINDOW_CHUNK)
    live = da._window_live_splits(torch.from_numpy(positions), win, group,
                                  capacity, split_len)
    got = da._combine_splits_plain(torch.from_numpy(m), torch.from_numpy(l),
                                   torch.from_numpy(acc), live)
    got = got.reshape(batch, kv_heads, win, group, hd).permute(0, 2, 1, 3, 4)
    assert got.shape == q.shape and torch.isfinite(got).all()

    def t(x):
        return None if x is None else torch.from_numpy(x)

    plain = da._decode_window_attention_plain(
        t(q), t(k), t(v), t(tables), layer, t(positions), t(ks), t(vs))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)

    def j(x):
        return None if x is None else jnp.asarray(x)

    want = j_da.decode_window_attention_pooled(
        j(q), j(k), j(v), j(tables), layer, j(positions), j(ks), j(vs),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ---- the launch -------------------------------------------------------------

@pytest.mark.parametrize('lane,dtype,batch,win,splits,split_len', [
    ('verify', torch.bfloat16, 8, 13, 8, 256),
    ('fused', torch.bfloat16, 1, 264, 4, 512),
    ('verify', torch.float32, 8, 13, 1, 2048),       # the FMA route
])
def test_window_launch_arguments(monkeypatch, lane, dtype, batch, win,
                                 splits, split_len):
    """K4's launch, with the library call recorded: q's own pointer (the
    caller's (B, W, KV, G, hd) layout, no permuted copy) and a
    contiguous output of q's shape, the split policy's (splits,
    split_len) on the tensor-core route and one split on the FMA route,
    f32 scratch only with more than one split, launches, launches_tc
    and launches_split counted on the caller's wrapper, and positions
    never read on the host."""
    calls = []
    monkeypatch.setattr(_kernels, 'launch',
                        lambda name, device, *args: calls.append(
                            (name, args)))
    monkeypatch.setattr(_kernels, 'sm_count', lambda device: H100_SMS)
    monkeypatch.setattr(da, '_window_route',
                        lambda code, hd: code == 1 and hd in (64, 128))
    kv_heads, group, hd, bs, t_width = 8, 4, 128, 64, 32
    q = torch.zeros(batch, win, kv_heads, group, hd, dtype=dtype)
    k = torch.zeros(2, 3, bs, kv_heads, hd, dtype=dtype)
    tables = torch.zeros(batch, t_width, dtype=torch.int32)
    positions = torch.zeros(batch, dtype=torch.int32).as_subclass(
        _NoHostRead)
    counter = (da.decode_window_attention_pooled if lane == 'verify'
               else da.fused_step_attention_pooled)
    other = (da.fused_step_attention_pooled if lane == 'verify'
             else da.decode_window_attention_pooled)
    attrs = ('launches', 'launches_tc', 'launches_split')
    before = [getattr(counter, a) for a in attrs]
    before_other = [getattr(other, a) for a in attrs]
    out, scratch, got_len = da._decode_window_attention_cuda(
        q, k, k, tables, 1, positions, None, None, counter)
    name, args = calls[-1]
    assert name == 'skk_paged_window'
    assert args[0] == q.data_ptr()
    assert args[7] == out.data_ptr()
    assert out.shape == q.shape and out.dtype == dtype and \
        out.is_contiguous()
    assert args[10:15] == (batch, win, kv_heads, group, hd)
    assert args[15:19] == (3, bs, t_width, 1)
    assert args[19:21] == (splits, split_len) and got_len == split_len
    tc = dtype == torch.bfloat16
    assert [getattr(counter, a) for a in attrs] == [
        before[0] + 1, before[1] + int(tc), before[2] + int(splits > 1)]
    assert [getattr(other, a) for a in attrs] == before_other
    if splits == 1:
        assert scratch is None and args[8:10] == (None, None)
    else:
        acc, ml = da._split_partials(q, scratch)
        assert acc.shape == (batch, kv_heads, splits, win * group, hd)
        assert ml.shape == (batch, kv_heads, splits, win * group, 2)
        assert acc.dtype == ml.dtype == torch.float32
        assert args[8:10] == (acc.data_ptr(), ml.data_ptr())
