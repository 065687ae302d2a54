"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (these tests skip without an NVIDIA card and nvcc).

Run on a machine with a card:
    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerances (kernel vs plain, same inputs): f32 atol 2e-5 (summation
order); bf16 atol 3e-2 + rtol 2e-2 (the plain versions round scores or
probabilities to bf16 where the kernels keep f32, and outputs are
rounded to bf16); the flash backward's bf16 dq, dk and dv, K7's bf16
and int8-cache outputs, the tensor-core K2's o against
`_flash_fwd_plain` (K2's own numerics, at head_dim 64, 128 and 256) and
K3's bf16 output, whose plain versions compute in f32 as the kernels do,
are held relative to the scale of each row (`_assert_row_close`).  An int8 arena of K1 or K4 is held to its q
dtype's tolerance: the kernels dequantize before each product in f32,
the plain versions scale after it, which is the same math up to
rounding.  K1 and K7 split a slot's keys across blocks when there are
fewer (slot, KV head) pairs than two blocks an SM, and so does K4's
tensor-core route; the split route's combine pass is held to
`_combine_splits_plain` per row.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=2e-2)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'false)')
    from skypilot_tpu_torch.ops import _kernels
    try:
        _kernels._nvcc()
    except RuntimeError:
        pytest.skip('needs nvcc to build the kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,d', [(7, 256), (64, 4096)] + [
    (rows, d) for rows in (1, 8, 104, 264, 2048, 4097)
    for d in (8, 264, 1536, 3072, 4096, 8192)])
def test_rms_norm_kernel(cuda, dtype, rows, d):
    """K3 at the row counts of decode (8), verify (104), the fused lane
    (264), a prefill chunk (2048) and one past a grid cap, over the debug
    and the presets' widths, on every configuration the launch policy
    picks there (a warp a row to 1,024 threads a row, 1 to 16 vectors a
    thread): bf16 per row (both sides compute in f32 and round once),
    f32 at TOL."""
    from skypilot_tpu_torch.ops import rmsnorm
    x = torch.randn(rows, d, generator=cuda, device='cuda').to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=cuda, device='cuda')).to(dtype)
    before = rmsnorm.rms_norm.launches
    out = rmsnorm.rms_norm(x, w)
    assert rmsnorm.rms_norm.launches == before + 1
    _assert_row_close(out, rmsnorm._rms_norm_plain(x, w, 1e-5))
    with pytest.raises(ValueError, match='multiple of 8'):
        rmsnorm.rms_norm(torch.zeros(rows, 12, device='cuda', dtype=dtype),
                         torch.ones(12, device='cuda', dtype=dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('d', [1536, 3072, 4096])
def test_rms_norm_kernel_in_a_cuda_graph(cuda, dtype, d):
    """K3 at decode's 8 rows captured in a CUDA graph (as the decode
    chunks run it) and replayed on new values of x: each replay equals an
    eager launch bitwise (the launch policy decides from shapes alone, so
    capture and eager take one configuration), and the capture counts
    one launch."""
    from skypilot_tpu_torch.ops import rmsnorm
    x = torch.randn(8, d, generator=cuda, device='cuda').to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=cuda, device='cuda')).to(dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rmsnorm.rms_norm(x, w, 1e-6)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = rmsnorm.rms_norm.launches
    with torch.cuda.graph(graph):
        y = rmsnorm.rms_norm(x, w, 1e-6)
    assert rmsnorm.rms_norm.launches == before + 1
    for _ in range(3):
        x.copy_(torch.randn(8, d, generator=cuda, device='cuda').to(dtype))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, rmsnorm.rms_norm(x, w, 1e-6))
        _assert_row_close(y, rmsnorm._rms_norm_plain(x, w, 1e-6))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('seq,heads,kv,hd,causal', [
    (1, 4, 4, 64, True), (77, 8, 2, 128, True), (130, 4, 1, 256, False),
    (64, 32, 8, 128, True), (200, 12, 2, 128, True), (96, 6, 1, 256, True)])
def test_flash_attention_kernel(cuda, dtype, seq, heads, kv, hd, causal):
    from skypilot_tpu_torch.ops import attention
    q = torch.randn(2, seq, heads, hd, generator=cuda, device='cuda').to(dtype)
    k = torch.randn(2, seq, kv, hd, generator=cuda, device='cuda').to(dtype)
    v = torch.randn(2, seq, kv, hd, generator=cuda, device='cuda').to(dtype)
    out = attention.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(
        out, attention._attention_plain(q, k, v, causal=causal),
        **TOL[dtype])
    with pytest.raises(ValueError, match='head_dim'):
        attention.flash_attention(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hd,group,bs', [(64, 1, 16), (128, 4, 64),
                                         (256, 8, 32), (128, 6, 64),
                                         (256, 1, 64)])
def test_paged_decode_kernel(cuda, dtype, hd, group, bs):
    from skypilot_tpu_torch.ops import decode_attention
    batch, kv, t_width, layers = 4, 2, 5, 2
    nb = 1 + batch * t_width
    rng = np.random.RandomState(hd)
    positions = torch.tensor([0, bs - 1, bs, t_width * bs - 1],
                             dtype=torch.int32, device='cuda')
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((batch, t_width), np.int32)
    for b in range(batch):
        live = int(positions[b]) // bs + 1
        tables[b, :live] = perm[b * t_width:b * t_width + live]
    tables = torch.as_tensor(tables, device='cuda')
    q = torch.randn(batch, kv, group, hd, generator=cuda,
                    device='cuda').to(dtype)
    k = torch.randn(layers, nb, bs, kv, hd, generator=cuda,
                    device='cuda').to(dtype)
    v = torch.randn(layers, nb, bs, kv, hd, generator=cuda,
                    device='cuda').to(dtype)
    out = decode_attention.decode_attention_pooled(q, k, v, tables, 1,
                                                   positions)
    torch.testing.assert_close(
        out, decode_attention._decode_attention_plain(q, k, v, tables, 1,
                                                      positions),
        **TOL[dtype])
    with pytest.raises(ValueError, match='int32'):
        decode_attention.decode_attention_pooled(q, k, v, tables.long(), 1,
                                                 positions)


def _arena(cuda, dtype, batch, kv, hd, bs, t_width, positions, int8):
    """Scattered tables covering each slot's keys up to its position,
    and a 2-layer arena of `dtype` (int8 rows with f32 scales when
    int8)."""
    from skypilot_tpu_torch.infer import llama_infer
    nb = 1 + batch * t_width
    rng = np.random.RandomState(hd + bs)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((batch, t_width), np.int32)
    for b in range(batch):
        live = min(int(positions[b]) // bs + 1, t_width)
        tables[b, :live] = perm[b * t_width:b * t_width + live]
    tables = torch.as_tensor(tables, device='cuda')
    shape = (2, nb, bs, kv, hd)
    k = torch.randn(shape, generator=cuda, device='cuda').to(dtype)
    v = torch.randn(shape, generator=cuda, device='cuda').to(dtype)
    if not int8:
        return tables, k, v, None, None
    (k8, ks), (v8, vs) = (llama_infer._quantize_kv(x) for x in (k, v))
    return tables, k8, v8, ks, vs


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hd,group,bs', [(64, 1, 16), (128, 4, 64),
                                         (256, 8, 32), (128, 6, 64)])
def test_paged_decode_kernel_int8(cuda, dtype, hd, group, bs):
    from skypilot_tpu_torch.ops import decode_attention
    batch, kv, t_width = 4, 2, 5
    positions = torch.tensor([0, bs - 1, bs, t_width * bs - 1],
                             dtype=torch.int32, device='cuda')
    tables, k, v, ks, vs = _arena(cuda, dtype, batch, kv, hd, bs, t_width,
                                  positions, True)
    q = torch.randn(batch, kv, group, hd, generator=cuda,
                    device='cuda').to(dtype)
    before = decode_attention.decode_attention_pooled.launches
    out = decode_attention.decode_attention_pooled(q, k, v, tables, 1,
                                                   positions, ks, vs)
    assert decode_attention.decode_attention_pooled.launches == before + 1
    torch.testing.assert_close(
        out, decode_attention._decode_attention_plain(
            q, k, v, tables, 1, positions, ks, vs), **TOL[dtype])
    with pytest.raises(ValueError, match='k_scale'):
        decode_attention.decode_attention_pooled(q, k, v, tables, 1,
                                                 positions)


@pytest.mark.parametrize('kind', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('hd,group,bs,win,t_width,pos', [
    pytest.param(64, 1, 16, 4, 5, None, id='64-1-16-4'),
    pytest.param(128, 4, 64, 13, 5, None, id='128-4-64-13'),
    pytest.param(256, 8, 32, 5, 5, None, id='256-8-32-5'),
    pytest.param(128, 4, 16, 40, 5, None, id='128-4-16-40'),
    # Split boundaries (64-key splits) inside the windows at 60 and 100.
    pytest.param(128, 4, 16, 24, 16, [40, 60, 100, 255],
                 id='128-4-16-24-split-in-window'),
    # The fused lane's width (fuse_budget 264).
    pytest.param(128, 4, 64, 264, 5, None, id='128-4-64-264-fused-width')])
def test_paged_window_kernel(cuda, kind, hd, group, bs, win, t_width, pos):
    """K4 against its plain version, twice (bitwise); keys past each
    slot's window and blocks no table maps are poisoned and must not
    change the output; each window row equals K1 at that row's position.
    bf16 and int8 at hd 64/128 take the tensor-core route (counted in
    launches_tc) and its split policy (launches_split when it splits,
    the combine kernel then equal to the output and per row to
    _combine_splits_plain); f32, and bf16 at hd 256, the FMA route."""
    from skypilot_tpu_torch.ops import decode_attention as da
    dtype = torch.bfloat16 if kind == 'int8' else getattr(torch, kind)
    batch, kv = 4, 2
    # Window starts at 0, block edges and the table's last row (its
    # later rows run past the table).
    if pos is None:
        pos = [0, bs - 1, bs, t_width * bs - 1]
    positions = torch.tensor(pos, dtype=torch.int32, device='cuda')
    tables, k, v, ks, vs = _arena(cuda, dtype, batch, kv, hd, bs, t_width,
                                  positions + win - 1, kind == 'int8')
    q = torch.randn(batch, win, kv, group, hd, generator=cuda,
                    device='cuda').to(dtype)
    capacity = t_width * bs
    tc = dtype == torch.bfloat16 and hd in (64, 128)
    splits, split_len = 1, capacity
    if tc:
        splits, split_len = da._window_splits(
            batch, kv, -(-win * group // da._WINDOW_ROWS), capacity,
            da._WINDOW_CHUNK,
            torch.cuda.get_device_properties(0).multi_processor_count)
    fn = da.decode_window_attention_pooled
    before = (fn.launches, fn.launches_tc, fn.launches_split)
    out = fn(q, k, v, tables, 1, positions, ks, vs)
    assert (fn.launches, fn.launches_tc, fn.launches_split) == (
        before[0] + 1, before[1] + int(tc), before[2] + int(splits > 1))
    assert out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(
        out, da._decode_window_attention_plain(q, k, v, tables, 1,
                                               positions, ks, vs),
        **TOL[dtype])
    assert torch.equal(fn(q, k, v, tables, 1, positions, ks, vs), out)
    k2, v2 = k.clone(), v.clone()
    poison = 127 if kind == 'int8' else 1e4
    mapped = set(tables.flatten().tolist()) - {0}
    for blk in range(k.shape[1]):
        if blk not in mapped:
            k2[:, blk] = poison
            v2[:, blk] = -poison
    for b in range(batch):
        last = int(positions[b]) + win - 1
        if last < t_width * bs - 1:
            blk = int(tables[b, last // bs])
            k2[1, blk, last % bs + 1:] = poison
            v2[1, blk, last % bs + 1:] = -poison
    assert torch.equal(fn(q, k2, v2, tables, 1, positions, ks, vs), out)
    for w in range(win):
        rows = torch.clamp_max(positions + w, t_width * bs - 1)
        single = da.decode_attention_pooled(q[:, w].contiguous(), k, v,
                                            tables, 1, rows, ks, vs)
        torch.testing.assert_close(out[:, w], single, **TOL[dtype])
    if splits > 1:
        _, scratch, got_len = da._decode_window_attention_cuda(
            q, k, v, tables, 1, positions, ks, vs, fn)
        acc, ml = da._split_partials(q, scratch)
        assert got_len == split_len and acc.shape[2] == splits
        combined = da._window_combine_cuda(acc, ml, positions, win,
                                           capacity, split_len)
        assert torch.equal(combined, out)
        live = da._window_live_splits(positions, win, group, capacity,
                                      split_len)
        want = da._combine_splits_plain(ml[..., 0], ml[..., 1], acc, live)
        _assert_row_close(combined, want.reshape(
            batch, kv, win, group, hd).permute(0, 2, 1, 3, 4).to(dtype))


@pytest.mark.parametrize('kind', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('s_len,group', [
    (64, 4), (128, 4), (256, 4), (512, 4), (1024, 4), (2048, 4), (192, 7),
    (192, 6)])
def test_contig_decode_kernel(cuda, kind, s_len, group):
    """K7 against its plain version at every cache bucket 64..2048 (and
    G 7); rows past each slot's position are poisoned and must not change
    the output."""
    from skypilot_tpu_torch.infer import llama_infer
    from skypilot_tpu_torch.ops import decode_attention as da
    dtype = torch.bfloat16 if kind == 'int8' else getattr(torch, kind)
    layers, batch, kv, hd = 2, 4, 2, 128
    positions = torch.tensor([0, s_len // 2 - 1, s_len // 2, s_len - 1],
                             dtype=torch.int32, device='cuda')
    shape = (layers, batch, s_len, kv, hd)
    k = torch.randn(shape, generator=cuda, device='cuda').to(dtype)
    v = torch.randn(shape, generator=cuda, device='cuda').to(dtype)
    ks = vs = None
    if kind == 'int8':
        (k, ks), (v, vs) = (llama_infer._quantize_kv(x) for x in (k, v))
    q = torch.randn(batch, kv, group, hd, generator=cuda,
                    device='cuda').to(dtype)
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, 1, positions, ks, vs)
    assert da.decode_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _assert_row_close(out, da._decode_attention_contig_plain(
        q, k, v, 1, positions, ks, vs))
    k2, v2 = k.clone(), v.clone()
    poison = 127 if kind == 'int8' else 1e4
    for b in range(batch):
        k2[1, b, int(positions[b]) + 1:] = poison
        v2[1, b, int(positions[b]) + 1:] = -poison
    assert torch.equal(da.decode_attention(q, k2, v2, 1, positions, ks, vs),
                       out)
    if s_len >= 128:
        # A truncating slice is a view, not a contiguous cache.
        with pytest.raises(ValueError, match='contiguous'):
            da.decode_attention(q, k[:, :, :64], v[:, :, :64], 1, positions,
                                None if ks is None else ks[:, :, :64],
                                None if vs is None else vs[:, :, :64])


def test_contig_decode_kernel_refuses_group_above_eight(cuda):
    from skypilot_tpu_torch.ops import decode_attention as da
    q = torch.zeros(2, 1, 9, 128, device='cuda')
    k = torch.zeros(1, 2, 64, 1, 128, device='cuda')
    with pytest.raises(ValueError, match='group 9 not in 1..8'):
        da.decode_attention(q, k, k, 0, torch.zeros(2, dtype=torch.int32,
                                                    device='cuda'))


# K1 at every head_dim, K7 at the head_dims its JAX kernel takes.
_SPLIT_CASES = [(kernel, hd) for kernel in ('K1', 'K7')
                for hd in (64, 128, 256) if kernel == 'K1' or hd % 128 == 0]


@pytest.mark.parametrize('group', [1, 4, 6, 7, 8])
@pytest.mark.parametrize('kind', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('kernel,hd', _SPLIT_CASES)
@pytest.mark.parametrize('batch,capacity', [(1, 8192), (5, 1024)])
def test_split_decode_kernel(cuda, batch, capacity, kernel, hd, kind, group):
    """K1 and K7 on their split route (one slot at position 8191 of 8192;
    five slots at 0, L - 1, L, L + 1 and capacity - 1 for the split
    length L): against their plain versions, launches_split counted, two
    calls bitwise equal, the same output from a cache poisoned past each
    position (and, for K1, in every block no table maps), and the
    combine kernel against _combine_splits_plain on the launch's
    partials."""
    from skypilot_tpu_torch.infer import llama_infer
    from skypilot_tpu_torch.ops import decode_attention as da
    dtype = torch.bfloat16 if kind == 'int8' else getattr(torch, kind)
    kv, bs, layer = 2, 64, 1
    splits, split_len = da._decode_splits(
        batch, kv, capacity, da._DECODE_CHUNK,
        torch.cuda.get_device_properties(0).multi_processor_count)
    assert splits > 1
    pos = ([capacity - 1] if batch == 1 else
           [0, split_len - 1, split_len, split_len + 1, capacity - 1])
    positions = torch.tensor(pos, dtype=torch.int32, device='cuda')
    q = torch.randn(batch, kv, group, hd, generator=cuda,
                    device='cuda').to(dtype)
    poison = 127 if kind == 'int8' else 1e4
    if kernel == 'K1':
        t_width = capacity // bs
        tables, k, v, ks, vs = _arena(cuda, dtype, batch, kv, hd, bs,
                                      t_width, positions, kind == 'int8')
        counter = da.decode_attention_pooled

        def run(k, v):
            return da.decode_attention_pooled(q, k, v, tables, layer,
                                              positions, ks, vs)

        want = da._decode_attention_plain(q, k, v, tables, layer, positions,
                                          ks, vs)
        k2, v2 = k.clone(), v.clone()
        mapped = set(tables.flatten().tolist()) - {0}
        for blk in range(k.shape[1]):
            if blk not in mapped:
                k2[:, blk], v2[:, blk] = poison, -poison
        for b, p in enumerate(pos):
            blk = int(tables[b, p // bs])
            k2[layer, blk, p % bs + 1:] = poison
            v2[layer, blk, p % bs + 1:] = -poison
        _, scratch, got_len = da._decode_attention_cuda(
            q, k, v, tables, layer, positions, ks, vs)
    else:
        shape = (2, batch, capacity, kv, hd)
        k = torch.randn(shape, generator=cuda, device='cuda').to(dtype)
        v = torch.randn(shape, generator=cuda, device='cuda').to(dtype)
        ks = vs = None
        if kind == 'int8':
            (k, ks), (v, vs) = (llama_infer._quantize_kv(x) for x in (k, v))
        counter = da.decode_attention

        def run(k, v):
            return da.decode_attention(q, k, v, layer, positions, ks, vs)

        want = da._decode_attention_contig_plain(q, k, v, layer, positions,
                                                 ks, vs)
        k2, v2 = k.clone(), v.clone()
        for b, p in enumerate(pos):
            k2[layer, b, p + 1:] = poison
            v2[layer, b, p + 1:] = -poison
        _, scratch, got_len = da._decode_attention_contig_cuda(
            q, k, v, layer, positions, ks, vs)
    before = counter.launches, counter.launches_split
    out = run(k, v)
    assert (counter.launches, counter.launches_split) == (
        before[0] + 1, before[1] + 1)
    assert out.shape == q.shape and out.dtype == dtype
    if kernel == 'K1':
        torch.testing.assert_close(out, want, **TOL[dtype])
    else:
        _assert_row_close(out, want)
    assert torch.equal(run(k, v), out)
    assert torch.equal(run(k2, v2), out)
    acc, ml = da._split_partials(q, scratch)
    assert got_len == split_len and acc.shape[2] == splits
    live = da._live_splits(positions, capacity, split_len)
    combined = da._decode_combine_cuda(acc, ml, positions, capacity,
                                       split_len, dtype)
    assert torch.equal(combined, out)
    _assert_row_close(combined, da._combine_splits_plain(
        ml[..., 0], ml[..., 1], acc, live).to(dtype))


@pytest.mark.parametrize('extra', [
    dict(decode_impl='paged'), dict(decode_impl='inplace'),
    dict(decode_impl='paged', kv_cache_dtype='int8')])
def test_legacy_planes_on_card_match_host(cuda, extra):
    """The 'paged' plane (K7) and 'inplace' through the batcher and the
    Generator at LLAMA_DEBUG f32 give the host's greedy tokens, and the
    pooled batcher's."""
    import warnings
    from skypilot_tpu_torch.infer.engine import Generator, GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import decode_attention as da
    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 512, size=n).tolist() for n in (5, 70, 9, 40)]
    kw = dict(max_seq_len=128, batch_size=4, prompt_buckets=[16, 64, 96],
              prefill_chunk=24)

    def run(device, **plane):
        p = _to(params, device)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', DeprecationWarning)
            b = ContinuousBatcher(p, cfg, GeneratorConfig(**kw, **plane),
                                  decode_chunk=4, device=device)
            rids = [b.submit(q, max_new_tokens=10) for q in prompts]
            b.run_until_idle()
            gen = Generator(p, cfg, GeneratorConfig(**kw, **plane),
                            device=device)
            return ([b.result(r) for r in rids],
                    gen.generate(prompts, max_new_tokens=10))

    before = da.decode_attention.launches
    card = run('cuda', **extra)
    assert card == run('cpu', **extra)
    assert (da.decode_attention.launches > before) == \
        (extra['decode_impl'] == 'paged')
    if 'kv_cache_dtype' not in extra:
        pooled, _ = run('cuda')
        assert card == (pooled, pooled)


def test_batcher_on_card_matches_host(cuda):
    """LLAMA_DEBUG f32 served through the kernels gives the host's
    greedy tokens."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')

    def run(device):
        p = _to(params, device)
        b = ContinuousBatcher(p, cfg, GeneratorConfig(
            max_seq_len=128, batch_size=2, prompt_buckets=[16, 32],
            prefill_chunk=24, kv_block_size=16), decode_chunk=4,
            device=device)
        rids = [b.submit(list(range(1, n + 1)), max_new_tokens=8)
                for n in (5, 30, 9)]
        b.run_until_idle()
        return [b.result(r) for r in rids]

    assert run('cuda') == run('cpu')


@pytest.mark.parametrize('extra', [
    dict(spec_k=3), dict(fuse_budget=8),
    dict(kv_cache_dtype='int8', weights_dtype='int8', spec_k=3,
         fuse_budget=8)])
def test_spec_fused_int8_batcher_on_card_matches_host(cuda, extra):
    """Speculative verify (K4), fused steps (K1 + K4) and int8 KV and
    weights at LLAMA_DEBUG f32 give the host's greedy tokens."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import decode_attention as da
    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, size=n).tolist() for n in (5, 30, 9, 40)]

    def run(device):
        b = ContinuousBatcher(_to(params, device), cfg, GeneratorConfig(
            max_seq_len=128, batch_size=3, prompt_buckets=[16, 32, 64],
            prefill_chunk=24, kv_block_size=16, **extra), decode_chunk=4,
            device=device)
        rids = [b.submit(p, max_new_tokens=10) for p in prompts]
        b.run_until_idle()
        b.pool.check_invariant()
        return [b.result(r) for r in rids]

    before = (da.decode_window_attention_pooled.launches
              + da.fused_step_attention_pooled.launches)
    assert run('cuda') == run('cpu')
    assert (da.decode_window_attention_pooled.launches
            + da.fused_step_attention_pooled.launches) > before


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---- training: K2's lse, K5 (dq), K6 (dk, dv), autograd ---------------------

# lse is f32 from the same inputs on both sides: summation order only.
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


def _assert_row_close(got, want):
    """bf16 outputs that both sides compute in f32 (dq, dk, dv; K7)
    elementwise: atol one bf16 ulp (2^-7) of the
    largest element of the same row (the row's elements share their sums'
    terms), never below TOL's f32 atol (rows that cancel to ~0), and rtol
    two ulps (2^-6) for outputs that round on either side of a boundary.
    f32: TOL."""
    if want.dtype != torch.bfloat16:
        torch.testing.assert_close(got, want, **TOL[want.dtype])
        return
    g, w = got.float(), want.float()
    atol = torch.clamp_min(2 ** -7 * w.abs().amax(-1, keepdim=True),
                           TOL[torch.float32]['atol'])
    excess = (g - w).abs() - (atol + 2 ** -6 * w.abs())
    assert float(excess.max()) <= 0, (
        f'max abs error {float((g - w).abs().max()):.3e} past the bound by '
        f'{float(excess.max()):.3e}')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('seq,heads,kv,hd,causal', [
    (1, 4, 4, 64, True), (77, 8, 2, 128, True), (130, 4, 2, 256, False),
    (64, 8, 8, 128, False), (200, 16, 4, 64, True), (96, 4, 1, 256, True),
    # The tensor-core kernels' 64-row tiles (bf16, hd 64 and 128), a group
    # of 8: one row, a full 16-row warp tile, one past it, one short of
    # and one past a 64-row tile, one past two, and an S with no full
    # last tile.
    (1, 32, 4, 128, False), (16, 32, 4, 64, True), (17, 32, 4, 128, True),
    (63, 32, 4, 64, False), (65, 32, 4, 128, True), (129, 32, 4, 64, True),
    (129, 32, 4, 128, False), (1000, 32, 4, 128, True),
    (1000, 32, 4, 64, False),
    # A group of 6 (Qwen2.5-1.5B: 12 query heads over 2 KV heads).
    (700, 12, 2, 128, True), (65, 6, 1, 64, False), (130, 6, 1, 256, True)])
def test_flash_backward_kernels(cuda, dtype, seq, heads, kv, hd, causal):
    """K2 with its lse, K5 and K6 against their plain versions, on the
    same inputs (o and lse from the kernel: the tensor-core K2's in bf16,
    which K5 and K6 must take at their per-row bounds, on their
    tensor-core kernels at hd 64 and 128 and their FMA kernels at 256),
    over head_dims 64/128/256, groups 1/2/4/6/8, ragged S, causal and
    not."""
    from skypilot_tpu_torch.ops import attention as at
    q = torch.randn(2, seq, heads, hd, generator=cuda, device='cuda').to(dtype)
    k = torch.randn(2, seq, kv, hd, generator=cuda, device='cuda').to(dtype)
    v = torch.randn(2, seq, kv, hd, generator=cuda, device='cuda').to(dtype)
    do = torch.randn(2, seq, heads, hd, generator=cuda,
                     device='cuda').to(dtype)
    before = (at.flash_attention.launches, at.flash_attention_dq.launches,
              at.flash_attention_dkv.launches)
    o, lse = at.flash_attention_fwd(q, k, v, causal, need_lse=True)
    assert lse.shape == (2, heads, seq) and lse.dtype == torch.float32
    torch.testing.assert_close(o, at._attention_plain(q, k, v, causal),
                               **TOL[dtype])
    torch.testing.assert_close(lse, at._attention_lse_plain(q, k, causal),
                               **LSE_TOL)
    delta = at._delta(o, do).contiguous()
    dq = at.flash_attention_dq(q, k, v, do, lse, delta, causal)
    dk, dv = at.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    assert (at.flash_attention.launches, at.flash_attention_dq.launches,
            at.flash_attention_dkv.launches) == tuple(n + 1 for n in before)
    _assert_row_close(
        dq, at._flash_attention_dq_plain(q, k, v, do, lse, delta, causal))
    for got, want in zip((dk, dv), at._flash_attention_dkv_plain(
            q, k, v, do, lse, delta, causal)):
        assert got.shape == k.shape and got.dtype == dtype
        _assert_row_close(got, want)


def _bwd_operands(cuda, dtype, seq, heads, kv, hd, causal):
    """q, k, v, do and the forward's lse and delta (from K2)."""
    from skypilot_tpu_torch.ops import attention as at
    q, k, v, do = (torch.randn(2, seq, h, hd, generator=cuda,
                               device='cuda').to(dtype)
                   for h in (heads, kv, kv, heads))
    o, lse = at.flash_attention_fwd(q, k, v, causal, need_lse=True)
    return q, k, v, do, lse, at._delta(o, do).contiguous()


@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('seq', [1, 63, 65, 129, 700, 1024])
@pytest.mark.parametrize('group', [1, 4, 6, 8])
@pytest.mark.parametrize('causal', [True, False])
def test_flash_forward_tensor_core_kernel(cuda, hd, seq, group, causal):
    """The tensor-core K2 (bf16, hd 64 and 128) with and without its lse:
    o per row against _flash_fwd_plain (p rounded to bf16 against the
    running max of a 64-key tile here, the row's final max there) and at
    TOL against _attention_plain; the lse against both plain lse at
    LSE_TOL; without the lse, the same o.  Ragged S (one row, one short
    of and one past a 64-key tile, one past a 128-row q-tile, no full
    last tile), GQA groups 1/4/6/8, causal and full."""
    from skypilot_tpu_torch.ops import attention as at
    heads = 12 if group == 6 else 8
    q, k, v = (torch.randn(2, seq, h, hd, generator=cuda,
                           device='cuda').bfloat16()
               for h in (heads, heads // group, heads // group))
    fa = at.flash_attention
    before = (fa.launches, fa.launches_tc, fa.launches_lse)
    o, lse = at.flash_attention_fwd(q, k, v, causal, need_lse=True)
    o_only, none = at.flash_attention_fwd(q, k, v, causal, need_lse=False)
    assert none is None and torch.equal(o_only, o)
    assert (fa.launches, fa.launches_tc, fa.launches_lse) == (
        before[0] + 2, before[1] + 2, before[2] + 1)
    assert lse.shape == (2, heads, seq) and lse.is_contiguous()
    want, want_lse = at._flash_fwd_plain(q, k, v, causal)
    _assert_row_close(o, want)
    torch.testing.assert_close(o, at._attention_plain(q, k, v, causal),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    torch.testing.assert_close(lse, at._attention_lse_plain(q, k, causal),
                               **LSE_TOL)


@pytest.mark.parametrize('seq', [1, 65, 130, 513])
@pytest.mark.parametrize('group', [1, 2])
@pytest.mark.parametrize('causal', [True, False])
def test_flash_forward_tensor_core_kernel_hd256(cuda, seq, group, causal):
    """The tensor-core K2 at bf16 head_dim 256 (Gemma; one m16 tile a
    warp, 32-key tiles) with and without its lse, as the hd-128 test
    holds it: o per row against _flash_fwd_plain and at TOL against
    _attention_plain, the lse at LSE_TOL, both launches on the
    tensor-core route.  Ragged S (one row, one past a 64-row q-tile and a
    32-key tile, one past two q-tiles, one past eight), MHA and a GQA
    group of 2, causal and full."""
    from skypilot_tpu_torch.ops import attention as at
    heads = 8
    q, k, v = (torch.randn(2, seq, h, 256, generator=cuda,
                           device='cuda').bfloat16()
               for h in (heads, heads // group, heads // group))
    fa = at.flash_attention
    before = (fa.launches, fa.launches_tc, fa.launches_lse)
    o, lse = at.flash_attention_fwd(q, k, v, causal, need_lse=True)
    o_only, none = at.flash_attention_fwd(q, k, v, causal, need_lse=False)
    assert none is None and torch.equal(o_only, o)
    assert (fa.launches, fa.launches_tc, fa.launches_lse) == (
        before[0] + 2, before[1] + 2, before[2] + 1)
    want, want_lse = at._flash_fwd_plain(q, k, v, causal)
    _assert_row_close(o, want)
    torch.testing.assert_close(o, at._attention_plain(q, k, v, causal),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    torch.testing.assert_close(lse, at._attention_lse_plain(q, k, causal),
                               **LSE_TOL)


@pytest.mark.parametrize('hd', [64, 128, 256])
def test_flash_forward_kernel_on_packed_qkv(cuda, hd):
    """q, k and v as strided views of one packed (B, S, H + 2 KV, D)
    tensor, as a fused qkv projection gives them: K2 reads the strides
    it is given, so o and lse equal those of contiguous copies."""
    from skypilot_tpu_torch.ops import attention as at
    heads, kv, seq = 8, 2, 200
    qkv = torch.randn(2, seq, heads + 2 * kv, hd, generator=cuda,
                      device='cuda').bfloat16()
    q, k, v = qkv.split([heads, kv, kv], dim=2)
    assert not q.is_contiguous() and not k.is_contiguous()
    o, lse = at.flash_attention_fwd(q, k, v, True, need_lse=True)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    o_c, lse_c = at.flash_attention_fwd(qc, kc, vc, True, need_lse=True)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    _assert_row_close(o, at._flash_fwd_plain(qc, kc, vc, True)[0])


@pytest.mark.parametrize('dtype,hd,tensor_cores,bwd_tensor_cores', [
    (torch.bfloat16, 64, True, True), (torch.bfloat16, 128, True, True),
    (torch.bfloat16, 256, True, False), (torch.float32, 64, False, False),
    (torch.float32, 128, False, False), (torch.float32, 256, False, False)])
def test_flash_forward_route(cuda, dtype, hd, tensor_cores,
                             bwd_tensor_cores):
    """bf16 at hd 64, 128 and 256 takes the tensor-core K2; f32 the FMA
    kernel: `launches_tc` counts the former only.  Both routes agree
    with the plain versions.  K5 and K6 on the same inputs keep bf16 at
    hd 256 on their FMA kernels (their `launches_tc` does not move)."""
    from skypilot_tpu_torch.ops import attention as at
    q, k, v = (torch.randn(2, 65, h, hd, generator=cuda,
                           device='cuda').to(dtype) for h in (4, 2, 2))
    fn = at.flash_attention
    before = (fn.launches, fn.launches_tc)
    o, lse = at.flash_attention_fwd(q, k, v, True, need_lse=True)
    assert (fn.launches, fn.launches_tc) == (before[0] + 1,
                                             before[1] + int(tensor_cores))
    want, want_lse = at._flash_fwd_plain(q, k, v, True)
    _assert_row_close(o, want)
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)
    do = torch.randn(o.shape, generator=cuda, device='cuda').to(dtype)
    delta = at._delta(o, do).contiguous()
    wrappers = (at.flash_attention_dq, at.flash_attention_dkv)
    before = [(w.launches, w.launches_tc) for w in wrappers]
    at.flash_attention_dq(q, k, v, do, lse, delta)
    at.flash_attention_dkv(q, k, v, do, lse, delta)
    for w, (n, n_tc) in zip(wrappers, before):
        assert (w.launches, w.launches_tc) == (n + 1,
                                               n_tc + int(bwd_tensor_cores))


@pytest.mark.parametrize('hd', [64, 128])
def test_flash_backward_kernels_on_packed_qkv(cuda, hd):
    """q, k and v as strided views of one packed (B, S, H + 2 KV, D)
    tensor, as a fused qkv projection gives them: K5 and K6 read the
    strides they are given."""
    from skypilot_tpu_torch.ops import attention as at
    heads, kv, seq = 8, 2, 200
    qkv = torch.randn(2, seq, heads + 2 * kv, hd, generator=cuda,
                      device='cuda').bfloat16()
    q, k, v = qkv.split([heads, kv, kv], dim=2)
    assert not q.is_contiguous() and not k.is_contiguous()
    do = torch.randn(2, seq, heads, hd, generator=cuda,
                     device='cuda').bfloat16()
    o, lse = at.flash_attention_fwd(q, k, v, True, need_lse=True)
    delta = at._delta(o, do).contiguous()
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    _assert_row_close(at.flash_attention_dq(q, k, v, do, lse, delta),
                      at._flash_attention_dq_plain(qc, kc, vc, do, lse,
                                                   delta))
    for got, want in zip(at.flash_attention_dkv(q, k, v, do, lse, delta),
                         at._flash_attention_dkv_plain(qc, kc, vc, do, lse,
                                                       delta)):
        _assert_row_close(got, want)


@pytest.mark.parametrize('dtype,hd', [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 128)])
def test_flash_backward_kernels_are_deterministic(cuda, dtype, hd):
    """No atomics and one block per output tile: two launches on the same
    inputs give bitwise-equal dq, dk and dv."""
    from skypilot_tpu_torch.ops import attention as at
    args = _bwd_operands(cuda, dtype, 333, 16, 4, hd, True)
    first = (at.flash_attention_dq(*args), *at.flash_attention_dkv(*args))
    second = (at.flash_attention_dq(*args), *at.flash_attention_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize('dtype,hd,tensor_cores', [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 256, False), (torch.float32, 64, False),
    (torch.float32, 128, False)])
def test_flash_backward_route(cuda, dtype, hd, tensor_cores):
    """bf16 at hd 64 and 128 takes the tensor-core kernels; f32, and bf16
    at hd 256, the FMA kernels: `launches_tc` counts the former only."""
    from skypilot_tpu_torch.ops import attention as at
    args = _bwd_operands(cuda, dtype, 65, 4, 2, hd, True)
    wrappers = (at.flash_attention_dq, at.flash_attention_dkv)
    before = [(w.launches, w.launches_tc) for w in wrappers]
    at.flash_attention_dq(*args)
    at.flash_attention_dkv(*args)
    for w, (n, n_tc) in zip(wrappers, before):
        assert (w.launches, w.launches_tc) == (n + 1,
                                               n_tc + int(tensor_cores))


@pytest.mark.parametrize('group', [1, 4])
def test_attention_and_norm_gradients_on_card_match_host(cuda, group):
    """flash_attention and rms_norm on CUDA tensors that require grad:
    gradients exist (the kernels are inside autograd Functions) and
    equal the host's plain backwards (f32, sums in another order)."""
    from skypilot_tpu_torch.ops import attention as at
    from skypilot_tpu_torch.ops import rmsnorm
    shapes = [(2, 77, 8, 128), (2, 77, 8 // group, 128),
              (2, 77, 8 // group, 128)]
    base = [torch.randn(s, generator=cuda, device='cuda') for s in shapes]
    x = torch.randn(2, 77, 256, generator=cuda, device='cuda')
    w = 1 + 0.1 * torch.randn(256, generator=cuda, device='cuda')
    grads = {}
    for dev in ('cuda', 'cpu'):
        qkv = [t.detach().to(dev).requires_grad_() for t in base]
        xw = [t.detach().to(dev).requires_grad_() for t in (x, w)]
        out = at.flash_attention(*qkv)
        # A strided incoming gradient, as after the layer's reshape.
        (out * out.transpose(1, 2).contiguous().transpose(1, 2)).sum() \
            .backward()
        (rmsnorm.rms_norm(*xw) ** 2).sum().backward()
        grads[dev] = [t.grad for t in qkv + xw]
    for got, want in zip(grads['cuda'], grads['cpu']):
        assert got is not None and float(got.abs().max()) > 0
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_serving_kernels_refuse_inputs_that_require_grad(cuda):
    """K1 and K4 have no backward: an input that requires grad raises
    instead of losing its gradient."""
    from skypilot_tpu_torch.ops import decode_attention as da
    positions = torch.tensor([3, 20], dtype=torch.int32, device='cuda')
    tables, k, v, _, _ = _arena(cuda, torch.float32, 2, 2, 64, 16, 3,
                                positions + 1, False)
    q = torch.randn(2, 2, 2, 64, device='cuda', requires_grad=True)
    with pytest.raises(ValueError, match='requires grad'):
        da.decode_attention_pooled(q, k, v, tables, 1, positions)
    with pytest.raises(ValueError, match='requires grad'):
        da.decode_window_attention_pooled(q[:, None], k, v, tables, 1,
                                          positions)
    with torch.no_grad():
        da.decode_attention_pooled(q, k, v, tables, 1, positions)


@pytest.mark.parametrize('remat,policy', [(False, None), (True, None),
                                          (True, 'dots')])
def test_llama_gradients_on_card_match_host(cuda, remat, policy):
    """LLAMA_DEBUG f32 (ragged 47 tokens): every parameter's gradient on
    the card exists, is non-zero and equals the host's."""
    import dataclasses
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(llama.LLAMA_DEBUG, remat=remat,
                              remat_policy=policy)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    tokens = next(trainer.synthetic_batches(2, 47, cfg.vocab_size))['tokens']
    grads = {}
    for dev in ('cuda', 'cpu'):
        p = trainer.tree_map(lambda t: t.to(dev).requires_grad_(), params)
        loss = llama.loss_fn(p, {'tokens': torch.from_numpy(tokens).to(dev)},
                             cfg)
        grads[dev] = torch.autograd.grad(loss, trainer.tree_leaves(p))
    for got, want in zip(grads['cuda'], grads['cpu']):
        assert float(got.abs().max()) > 0
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def test_trainer_on_card_matches_host(cuda):
    """Two Trainer steps at LLAMA_DEBUG f32: loss and grad_norm as the
    host's; parameters within 2 x the summed learning rates (Adam moves
    a ~0-gradient element by up to lr either way), nearly all within
    1e-6."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import attention as at
    from skypilot_tpu_torch.train import trainer
    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=4)
    runs = {}
    before = at.flash_attention_dkv.launches
    for dev in ('cuda', 'cpu'):
        tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg),
                             trainer.tree_map(torch.clone, params), tc,
                             device=dev)
        batches = trainer.synthetic_batches(4, 63, cfg.vocab_size)
        metrics = [tr.run_step(next(batches)) for _ in range(2)]
        runs[dev] = ([(float(m['loss']), float(m['grad_norm']))
                      for m in metrics], trainer.tree_leaves(tr.params))
    assert at.flash_attention_dkv.launches == before + 2 * cfg.n_layers
    np.testing.assert_allclose(runs['cuda'][0], runs['cpu'][0], rtol=1e-5)
    lrs = tc.learning_rate
    for got, want in zip(runs['cuda'][1], runs['cpu'][1]):
        diff = (got.detach().cpu() - want.detach()).abs()
        assert float(diff.max()) <= 2 * lrs
        assert float((diff <= 1e-6).float().mean()) > 0.99
