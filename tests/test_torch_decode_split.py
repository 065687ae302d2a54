"""Split-KV decode attention (K1 and K7, skypilot_tpu_torch/ops/
decode_attention.py) on the CPU: the split policy, the combine's plain
version against the plain decode and the JAX kernel, and the launch the
wrappers make (the kernel itself runs only on the card:
tests/test_torch_kernels.py).

Inputs are numpy draws from fixed seeds.  Tolerance: f32's, atol = rtol
= 2e-5 (every side computes in f32; the splits, the 32-key chunks and
the Pallas kernel's 64-row blocks sum in different orders).  An int8
cache is dequantized in f32 before each product on every side.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.ops import decode_attention as j_da  # noqa: E402
from skypilot_tpu_torch.ops import _kernels  # noqa: E402
from skypilot_tpu_torch.ops import decode_attention as da  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=2e-5)
H100_SMS = 132


# ---- the split policy --------------------------------------------------------

@pytest.mark.parametrize('batch,kv_heads,capacity,chunk,sms', [
    (8, 8, 2048, 32, H100_SMS),      # K1 on the 8B serving path
    (8, 8, 64, 32, H100_SMS),        # K7's smallest bucket
    (1, 8, 8192, 32, H100_SMS),      # one slot at the 8B max_seq_len
    (1, 1, 8192, 32, H100_SMS),      # capped at one chunk a split
    (33, 8, 2048, 32, H100_SMS),     # B KV = 264 = 2 SMs: one split
    (64, 8, 4096, 32, H100_SMS),     # past 2 SMs
    (4, 2, 80, 32, H100_SMS),        # capacity not a multiple of the chunk
    (2, 1, 17, 32, 4),               # capacity below one chunk
    (3, 5, 1000, 16, 7),
    (1, 1, 1, 32, 1),
])
def test_decode_splits_cover_the_capacity(batch, kv_heads, capacity, chunk,
                                          sms):
    splits, split_len = da._decode_splits(batch, kv_heads, capacity, chunk,
                                          sms)
    assert splits >= 1 and split_len >= 1 and split_len % chunk == 0
    assert splits * split_len >= capacity           # every key has a block
    assert (splits - 1) * split_len < capacity      # no split starts past it
    assert splits <= max(1, -(-capacity // chunk))
    if batch * kv_heads >= 2 * sms:
        assert splits == 1
    elif capacity > chunk:
        # Fewer (slot, KV head) pairs than two blocks an SM: split.
        assert splits >= 2


def test_decode_splits_on_the_serving_shapes():
    """The launches of chip_smoke.py's phase 3 and phases 5-7 (B KV 64 <
    2 x 132): five splits over the pooled 2048 keys, two over K7's
    64-row bucket, 32 over 8192 keys of one slot."""
    assert da._decode_splits(8, 8, 2048, da._DECODE_CHUNK, H100_SMS) == \
        (5, 416)
    assert da._decode_splits(8, 8, 64, da._DECODE_CHUNK, H100_SMS) == (2, 32)
    assert da._decode_splits(1, 8, 8192, da._DECODE_CHUNK, H100_SMS) == \
        (32, 256)


# ---- partials and the combine ------------------------------------------------

def _block_partials(q, k, v, positions, splits, split_len, chunk):
    """What each block of a split launch leaves in scratch, in f32 numpy:
    block s of slot b walks keys [s L, min((s + 1) L, n_keys)) in chunks,
    folding each into a running max m, sum l and accumulator acc (the
    online softmax of csrc/paged_decode.cu).  Splits a slot never
    reaches hold NaN, as uninitialised scratch may."""
    batch, kv_heads, group, hd = q.shape
    m = np.full((batch, kv_heads, splits, group), np.nan, np.float32)
    l = np.full_like(m, np.nan)
    acc = np.full((batch, kv_heads, splits, group, hd), np.nan, np.float32)
    scale = np.float32(hd ** -0.5)
    for b in range(batch):
        n_keys = min(int(positions[b]) + 1, k.shape[1])
        for s in range(splits):
            start, end = s * split_len, min((s + 1) * split_len, n_keys)
            if start >= n_keys:
                continue
            m_run = np.full((kv_heads, group), -1e30, np.float32)
            l_run = np.zeros((kv_heads, group), np.float32)
            a_run = np.zeros((kv_heads, group, hd), np.float32)
            for c0 in range(start, end, chunk):
                kc = k[b, c0:min(c0 + chunk, end)]          # (n, KV, hd)
                vc = v[b, c0:min(c0 + chunk, end)]
                sc = np.einsum('kgd,nkd->kgn', q[b], kc) * scale
                m_new = np.maximum(m_run, sc.max(-1))
                e = np.exp(sc - m_new[..., None])
                corr = np.exp(m_run - m_new)
                l_run = l_run * corr + e.sum(-1)
                a_run = a_run * corr[..., None] + np.einsum(
                    'kgn,nkd->kgd', e, vc)
                m_run = m_new
            m[b, :, s], l[b, :, s], acc[b, :, s] = m_run, l_run, a_run
    return m, l, acc


@pytest.mark.parametrize('group', [1, 4])
@pytest.mark.parametrize('label', ['f32', 'int8'])
def test_combined_splits_match_plain_and_jax_decode(label, group):
    """Keys cut at the split policy's boundaries (positions 0, L - 1, L,
    L + 1 and capacity - 1), each block's partials combined by
    _combine_splits_plain, against K7's plain version and the JAX
    decode_attention kernel in interpret mode."""
    batch, kv_heads, hd, s_len, layer = 5, 2, 128, 256, 1
    # 20 SMs: four splits of 64 keys over the 256-row cache.
    splits, split_len = da._decode_splits(batch, kv_heads, s_len,
                                          da._DECODE_CHUNK, 20)
    assert (splits, split_len) == (4, 64)
    positions = np.asarray([0, split_len - 1, split_len, split_len + 1,
                            s_len - 1], np.int32)
    rng = np.random.RandomState(7 + group)
    q = rng.randn(batch, kv_heads, group, hd).astype(np.float32)
    k = rng.randn(2, batch, s_len, kv_heads, hd).astype(np.float32)
    v = rng.randn(2, batch, s_len, kv_heads, hd).astype(np.float32)
    ks = vs = None
    if label == 'int8':
        ks = (np.abs(k).max(-1) / 127.0).astype(np.float32)
        vs = (np.abs(v).max(-1) / 127.0).astype(np.float32)
        k = np.round(k / ks[..., None]).astype(np.int8)
        v = np.round(v / vs[..., None]).astype(np.int8)
        k_f = k[layer].astype(np.float32) * ks[layer][..., None]
        v_f = v[layer].astype(np.float32) * vs[layer][..., None]
    else:
        k_f, v_f = k[layer], v[layer]

    m, l, acc = _block_partials(q, k_f, v_f, positions, splits, split_len,
                                da._DECODE_CHUNK)
    live = da._live_splits(torch.from_numpy(positions), s_len, split_len)
    assert live.tolist() == [1, 1, 2, 2, 4]
    got = da._combine_splits_plain(torch.from_numpy(m), torch.from_numpy(l),
                                   torch.from_numpy(acc), live)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(got).all()

    def t(x):
        return None if x is None else torch.from_numpy(x)

    plain = da._decode_attention_contig_plain(
        t(q), t(k), t(v), layer, t(positions), t(ks), t(vs))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)

    def j(x):
        return None if x is None else jnp.asarray(x)

    want = j_da.decode_attention(j(q), j(k), j(v), layer, j(positions),
                                 j(ks), j(vs), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_combine_reads_only_live_splits():
    """Garbage (inf, NaN) past a slot's live splits changes nothing, and
    one live split is that split's acc / l."""
    rng = np.random.RandomState(3)
    m = torch.from_numpy(rng.randn(2, 1, 3, 2).astype(np.float32))
    l = torch.from_numpy(rng.rand(2, 1, 3, 2).astype(np.float32) + 1)
    acc = torch.from_numpy(rng.randn(2, 1, 3, 2, 8).astype(np.float32))
    live = torch.tensor([1, 3])
    clean = da._combine_splits_plain(m, l, acc, live)
    m2, l2, acc2 = m.clone(), l.clone(), acc.clone()
    m2[0, :, 1:], l2[0, :, 1:], acc2[0, :, 1:] = float('inf'), 0.0, float(
        'nan')
    assert torch.equal(da._combine_splits_plain(m2, l2, acc2, live), clean)
    torch.testing.assert_close(clean[0], acc[0, :, 0] / l[0, :, 0, ..., None],
                               **F32_TOL)


# ---- the launch ----------------------------------------------------------------

class _NoHostRead(torch.Tensor):
    """positions that fail if the host reads their values."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, '__name__', '')
        if name in ('item', 'tolist', 'numpy', '__int__', '__index__',
                    '__bool__', '__float__', 'cpu', 'to', '__getitem__',
                    '__iter__', '__array__'):
            raise AssertionError(f'the launch read positions on the host '
                                 f'({name})')
        return super().__torch_function__(func, types, args, kwargs or {})


def _record_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, 'launch',
                        lambda name, device, *args: calls.append(
                            (name, args)))
    monkeypatch.setattr(_kernels, 'sm_count', lambda device: H100_SMS)
    return calls


@pytest.mark.parametrize('kernel,batch,capacity,splits,split_len', [
    ('K1', 8, 2048, 5, 416),
    ('K1', 40, 2048, 1, 2048),
    ('K7', 8, 64, 2, 32),
    ('K7', 8, 1024, 5, 224),
])
def test_split_launch_arguments(monkeypatch, kernel, batch, capacity, splits,
                                split_len):
    """The wrappers' launch, with the library call recorded: the split
    policy's (splits, split_len), f32 scratch only with more than one
    split, launches and launches_split counted, and positions never read
    on the host."""
    calls = _record_launches(monkeypatch)
    kv_heads, group, hd = 8, 4, 128
    q = torch.zeros(batch, kv_heads, group, hd)
    positions = torch.zeros(batch, dtype=torch.int32).as_subclass(
        _NoHostRead)
    if kernel == 'K1':
        bs = 64
        k = torch.zeros(2, 3, bs, kv_heads, hd)
        tables = torch.zeros(batch, capacity // bs, dtype=torch.int32)
        counter = da.decode_attention_pooled
        before = counter.launches, counter.launches_split
        out, scratch, got_len = da._decode_attention_cuda(
            q, k, k, tables, 1, positions, None, None)
        name, args = calls[-1]
        assert name == 'skk_paged_decode'
        assert args[14:17] == (3, bs, capacity // bs)
        launch_splits = args[18:20]
    else:
        k = torch.zeros(2, batch, capacity, kv_heads, hd)
        counter = da.decode_attention
        before = counter.launches, counter.launches_split
        out, scratch, got_len = da._decode_attention_contig_cuda(
            q, k, k, 1, positions, None, None)
        name, args = calls[-1]
        assert name == 'skk_contig_decode'
        assert args[13] == capacity
        launch_splits = args[15:17]
    assert launch_splits == (splits, split_len) and got_len == split_len
    assert out.shape == q.shape and out.dtype == q.dtype
    assert counter.launches == before[0] + 1
    assert counter.launches_split == before[1] + (splits > 1)
    pointers = args[7:9] if kernel == 'K7' else args[8:10]
    if splits == 1:
        assert scratch is None and pointers == (None, None)
    else:
        acc, ml = da._split_partials(q, scratch)
        assert acc.shape == (batch, kv_heads, splits, group, hd)
        assert ml.shape == (batch, kv_heads, splits, group, 2)
        assert acc.dtype == ml.dtype == torch.float32
        assert pointers == (acc.data_ptr(), ml.data_ptr())
