"""The port's legacy decode planes (decode_impl 'paged', 'inplace',
'scan', 'unroll'), K7's plain version and the lockstep Generator
(skypilot_tpu_torch: ops/decode_attention, infer/llama_infer,
infer/engine, infer/serving) against the JAX package, on the CPU.

The JAX side of K7 is its Pallas kernel in interpret mode, which is
what the JAX 'paged' plane runs off the TPU; the port's CPU tensors take
K7's plain version, which follows that kernel's numerics.  Inputs are
numpy draws from fixed seeds, at LLAMA_DEBUG widths (2 layers, hd 128,
G 2) and max_seq_len <= 128.  Tolerances:
- K7 in f32 and on an int8 cache: atol = rtol = 2e-5 (both sides compute
  in f32 and differ in summation order: the Pallas kernel's online
  softmax goes block by block); in bf16 one output ulp, atol = rtol =
  2^-8 (both round the same f32 result to bf16, from sums taken in
  another order);
- logits in f32: LOGITS_TOL (atol 2e-4, rtol 1e-4; summation order over
  2 layers); through an int8 cache atol 5e-3 (a K/V value that the two
  sides round to neighbouring int8 steps moves a logit by ~1e-3, as in
  tests/test_torch_int8.py, and window hiddens read through it the
  same); cache rows and f32 hiddens atol 5e-5, int8 rows within one
  step;
- tokens: identical (greedy, f32).

The module compiles its own JAX programs: the persistent compilation
cache that tests/conftest.py shares between xdist workers is off while
it runs (_own_jax_compiles).  In one tier-1 run with 6 workers, this
module ran first on its worker, its JAX side loaded every program from
executables another worker had just written, and every f32 prefill
comparison failed (5.5e-4 in the window hiddens, 2.5e-4 in the cache),
with the port's side off a float64 recompute and the JAX side on it.
That the cache caused it is a guess: no mechanism links the JAX cache
to the port's torch numerics, and no run has reproduced the failure,
with the cache or without it.  The window test reports both sides'
distance from float64 when it fails, so a recurrence names its side.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import llama_infer as j_infer  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.ops import decode_attention as j_da  # noqa: E402
from skypilot_tpu_torch.infer import engine, llama_infer  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.ops import decode_attention as da  # noqa: E402

K7_TOL = {'f32': 2e-5, 'int8': 2e-5, 'bf16': 2 ** -8}
LOGITS_TOL = dict(atol=2e-4, rtol=1e-4)
INT8_LOGITS_ATOL = 5e-3
ROW_ATOL = 5e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope='module', autouse=True)
def _own_jax_compiles():
    """The persistent compilation cache off for this module (and reset,
    since JAX decides once whether it uses the cache), restored after.
    A precaution against the one failed run described above, with no
    observed effect: the module passes with the cache on as well."""
    from jax.experimental.compilation_cache import compilation_cache
    was = jax.config.jax_enable_compilation_cache
    jax.config.update('jax_enable_compilation_cache', False)
    compilation_cache.reset_cache()
    yield
    jax.config.update('jax_enable_compilation_cache', was)
    compilation_cache.reset_cache()


@pytest.fixture(scope='module')
def models():
    """LLAMA_DEBUG f32 weights from one JAX draw, on both sides."""
    jp = j_llama.init_params(j_llama.LLAMA_DEBUG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, llama.params_from_numpy(tree, llama.LLAMA_DEBUG, 'cpu')


def _f64_window_hiddens(tp, prompt, starts):
    """The window hiddens through the port's plain path in float64, from
    the same f32 weights: which side a mismatch moved."""
    cfg = dataclasses.replace(llama.LLAMA_DEBUG, dtype=torch.float64)
    params = _tree64(tp)
    cache = llama_infer.init_cache(cfg, 2, 64, device='cpu')
    out = []
    for start in starts:
        window = np.zeros((24,), np.int32)
        chunk = prompt[start:start + 24]
        window[:len(chunk)] = chunk
        h, _ = llama_infer.prefill_window(params, _t(window), cfg, cache, 1,
                                          start)
        out.append(h.numpy())
    return out


def _tree64(tree):
    if isinstance(tree, dict):
        return {k: _tree64(v) for k, v in tree.items()}
    return tree.double()


# ---- K7 --------------------------------------------------------------------

def _k7_inputs(label, batch=4, s_len=128, layers=3, kv=2, group=2, hd=128,
               seed=0):
    """q (B, KV, G, hd) and an (L, B, S, KV, hd) cache as numpy f32 (the
    int8 cache quantized per (row, KV head), the llama_infer scheme)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(batch, kv, group, hd).astype(np.float32)
    k = rng.randn(layers, batch, s_len, kv, hd).astype(np.float32)
    v = rng.randn(layers, batch, s_len, kv, hd).astype(np.float32)
    if label != 'int8':
        return q, k, v, None, None
    ks = np.maximum(np.abs(k).max(-1), 1e-8) / 127.0
    vs = np.maximum(np.abs(v).max(-1), 1e-8) / 127.0
    return (q, np.round(k / ks[..., None]).astype(np.int8),
            np.round(v / vs[..., None]).astype(np.int8),
            ks.astype(np.float32), vs.astype(np.float32))


def _poison(x, positions, value):
    """A copy with every row past each slot's position set to `value`."""
    x = x.copy()
    for b, p in enumerate(positions):
        x[:, b, p + 1:] = value
    return x


def _both_k7(label, q, k, v, ks, vs, layer, pos):
    """(port plain version, JAX interpret-mode kernel) on the same
    inputs; bf16 rounds q and the cache to bf16 on both sides."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if label == 'bf16'
                else (jnp.float32, torch.float32))
    kv_j = [jnp.asarray(x) if x.dtype == np.int8 else jnp.asarray(x, jdt)
            for x in (k, v)]
    want = j_da.decode_attention(
        jnp.asarray(q, jdt), *kv_j, layer, jnp.asarray(pos),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), interpret=True)
    kv_t = [_t(x) if x.dtype == np.int8 else _t(x, tdt) for x in (k, v)]
    got = da.decode_attention(
        _t(q, tdt), *kv_t, layer, _t(pos),
        None if ks is None else _t(ks), None if vs is None else _t(vs))
    assert got.dtype == tdt and got.shape == q.shape
    return got, want


@pytest.mark.parametrize('positions', [
    [0, 5, 63, 127],        # block edges and a 1-token context
    [64, 64, 64, 64],       # one full block and the next block's first row
    [127, 3, 80, 31],
])
@pytest.mark.parametrize('label', ['f32', 'bf16', 'int8'])
def test_k7_plain_matches_jax_kernel(label, positions):
    """Layers 0 and 2 of a 3-layer cache, rows past each position
    poisoned (1e4 / -1e4, or +-127 in int8) on both sides."""
    q, k, v, ks, vs = _k7_inputs(label)
    pos = np.asarray(positions, np.int32)
    big = 127 if label == 'int8' else 1e4
    k, v = _poison(k, positions, big), _poison(v, positions, -big)
    tol = K7_TOL[label]
    for layer in (0, 2):
        got, want = _both_k7(label, q, k, v, ks, vs, layer, pos)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_k7_one_kv_head_group_three():
    """KV 1 x G 3: rows = KV * G not a multiple of 8."""
    q, k, v, _, _ = _k7_inputs('f32', batch=2, kv=1, group=3)
    pos = np.asarray([17, 90], np.int32)
    got, want = _both_k7('f32', q, k, v, None, None, 1, pos)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('s_len,hd,match', [
    (100, 128, 'not a multiple of the decode block 64'),
    (128, 64, 'head_dim 64 must be a multiple of 128'),
])
def test_k7_rejects_what_the_jax_kernel_rejects(s_len, hd, match):
    q, k, v, _, _ = _k7_inputs('f32', batch=2, s_len=s_len, layers=1, hd=hd)
    pos = np.zeros((2,), np.int32)
    with pytest.raises(ValueError, match=match):
        j_da.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              0, jnp.asarray(pos), interpret=True)
    with pytest.raises(ValueError, match=match):
        da.decode_attention(_t(q), _t(k), _t(v), 0, _t(pos))


# ---- resize_cache and the contiguous window prefill ------------------------

@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
def test_resize_cache_grow_and_truncate(kv_dtype):
    rng = np.random.RandomState(1)
    cache = llama_infer.init_cache(llama.LLAMA_DEBUG, 2, 64,
                                   kv_dtype=kv_dtype, device='cpu')
    for key, arr in cache.items():
        arr.copy_(_t(rng.randint(-100, 100, size=arr.shape)).to(arr.dtype))
    j_cache = {key: jnp.asarray(arr.numpy()) for key, arr in cache.items()}
    for new_len in (128, 32):
        got = llama_infer.resize_cache(cache, new_len)
        want = j_infer.resize_cache(j_cache, new_len)
        assert got is not cache and set(got) == set(cache)
        for key in cache:
            assert got[key].is_contiguous()
            assert got[key].dtype == cache[key].dtype
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    assert llama_infer.resize_cache(cache, 64) is cache


@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
def test_prefill_window_matches_jax(models, kv_dtype):
    """A 70-token prompt in 24-token windows through a 64-row slot
    cache: the last window runs past the cache's end (rows dropped on
    both sides).  Hiddens of every window and the rows written agree."""
    jp, tp = models
    jcfg, tcfg = j_llama.LLAMA_DEBUG, llama.LLAMA_DEBUG
    prompt = np.random.RandomState(2).randint(1, 512, size=70)
    j_cache = j_infer.init_cache(jcfg, 2, 64, kv_dtype=kv_dtype)
    t_cache = llama_infer.init_cache(tcfg, 2, 64, kv_dtype=kv_dtype,
                                     device='cpu')
    starts = (0, 24, 48)
    f64 = _f64_window_hiddens(tp, prompt, starts)
    for start, ref in zip(starts, f64):
        window = np.zeros((24,), np.int32)
        chunk = prompt[start:start + 24]
        window[:len(chunk)] = chunk
        j_h, j_cache = j_infer.prefill_window(
            jp, jnp.asarray(window), jcfg, j_cache, jnp.int32(1),
            jnp.int32(start))
        t_h, _ = llama_infer.prefill_window(tp, _t(window), tcfg, t_cache,
                                            1, start)
        rows = min(24, 64 - start)
        got, want = _np(t_h)[:rows], _np(j_h)[:rows]
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=ROW_ATOL if kv_dtype is None else INT8_LOGITS_ATOL,
            err_msg=f'window at {start}: max |port - float64| '
                    f'{np.abs(got - ref[:rows]).max():.3e}, max |JAX - '
                    f'float64| {np.abs(want - ref[:rows]).max():.3e}')
    for key in t_cache:
        got, want = _np(t_cache[key]), _np(j_cache[key])
        if key in ('k', 'v') and kv_dtype == 'int8':
            np.testing.assert_allclose(got, want, atol=1, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=ROW_ATOL, rtol=0)
        assert not got[:, 0].any()           # slot 0 untouched


# ---- the legacy decode steps ------------------------------------------------

JAX_STEPS = {'paged': j_infer.decode_step_paged,
             'inplace': j_infer.decode_step_inplace,
             'scan': j_infer.decode_step,
             'unroll': j_infer.decode_step_unrolled}


@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
@pytest.mark.parametrize('impl', ['paged', 'inplace', 'scan', 'unroll'])
def test_decode_steps_match_jax(models, impl, kv_dtype):
    """Prefill two prompts into a 64-row cache, then four steps of each
    plane, both sides fed JAX's greedy token: logits and the cache agree
    after every step, and greedy tokens are identical."""
    jp, tp = models
    jcfg, tcfg = j_llama.LLAMA_DEBUG, llama.LLAMA_DEBUG
    rng = np.random.RandomState(3)
    tokens = rng.randint(1, 512, size=(2, 32)).astype(np.int32)
    lengths = np.asarray([30, 11], np.int32)
    j_cache = j_infer.init_cache(jcfg, 2, 64, kv_dtype=kv_dtype)
    j_logits, j_cache = j_infer.prefill(jp, jnp.asarray(tokens), jcfg,
                                        j_cache, jnp.asarray(lengths))
    t_cache = llama_infer.init_cache(tcfg, 2, 64, kv_dtype=kv_dtype,
                                     device='cpu')
    llama_infer.prefill(tp, _t(tokens), tcfg, t_cache, _t(lengths))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        step = llama_infer.get_decode_fn(impl)
    positions = lengths.copy()
    token = np.asarray(jnp.argmax(j_logits, -1), np.int32)
    for _ in range(4):
        j_logits, j_cache = JAX_STEPS[impl](jp, jnp.asarray(token), jcfg,
                                            j_cache, jnp.asarray(positions))
        t_logits, _ = step(tp, _t(token), tcfg, t_cache, _t(positions))
        if kv_dtype is None:
            np.testing.assert_allclose(_np(t_logits), _np(j_logits),
                                       **LOGITS_TOL)
        else:
            np.testing.assert_allclose(_np(t_logits), _np(j_logits),
                                       atol=INT8_LOGITS_ATOL, rtol=0)
        np.testing.assert_array_equal(_np(t_logits).argmax(-1),
                                      _np(j_logits).argmax(-1))
        for key in t_cache:
            atol = 1 if t_cache[key].dtype == torch.int8 else ROW_ATOL
            np.testing.assert_allclose(_np(t_cache[key]), _np(j_cache[key]),
                                       atol=atol, rtol=0)
        token = np.asarray(jnp.argmax(j_logits, -1), np.int32)
        positions = positions + 1


def test_get_decode_fn_names_and_warnings():
    for impl, fn, warns in (('inplace', llama_infer.decode_step_inplace,
                             False),
                            ('unroll', llama_infer.decode_step_inplace,
                             False),
                            ('scan', llama_infer.decode_step_inplace, True),
                            ('paged', llama_infer.decode_step_paged, True),
                            ('pooled', llama_infer.decode_step_pooled,
                             False)):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter('always')
            assert llama_infer.get_decode_fn(impl) is fn
        assert any(issubclass(w.category, DeprecationWarning)
                   for w in seen) == warns, impl
    for mod in (j_infer, llama_infer):
        with pytest.raises(ValueError, match="decode_impl must be 'pooled', "
                           "'inplace', 'scan', 'unroll' or 'paged', got "
                           "'fast'"):
            mod.get_decode_fn('fast')


# ---- GeneratorConfig ---------------------------------------------------------

@pytest.mark.parametrize('kw', [
    dict(), dict(max_seq_len=100), dict(max_seq_len=64),
    dict(cache_buckets=[256, 64, 64], max_seq_len=512),
    dict(cache_buckets=[512], max_seq_len=512),
])
def test_derive_cache_buckets_matches_jax(kw):
    assert engine.derive_cache_buckets(GeneratorConfig(**kw)) == \
        j_engine.derive_cache_buckets(j_engine.GeneratorConfig(**kw))


@pytest.mark.parametrize('kwargs,match', [
    (dict(decode_impl='paged', fuse_budget=8, prefill_chunk=8),
     "requires the pooled data plane"),
    (dict(decode_impl='inplace', host_tier_mb=1.0, prefix_cache_mb=1.0),
     'has no block arena to spill from'),
    (dict(decode_impl='scan', overlap_collectives=True),
     'has no manual-region layer stack'),
    (dict(decode_impl='paged', spec_k=2), 'has no verify-window path'),
    (dict(decode_impl='paged', max_seq_len=100),
     r'offending: \[100\]'),
    (dict(decode_impl='paged', cache_buckets=[96], max_seq_len=256),
     r'offending: \[96\]'),
    (dict(cache_buckets=[0, 64], max_seq_len=64, decode_impl='paged'),
     'cache_buckets must be positive'),
    (dict(cache_buckets=[4096], decode_impl='paged'),
     'Largest cache bucket 4096 exceeds'),
])
def test_legacy_config_errors_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        j_engine.GeneratorConfig(**kwargs)
    with pytest.raises(ValueError, match=match):
        GeneratorConfig(**kwargs)


# ---- ContinuousBatcher on the legacy planes -------------------------------

def _record_migrations(batcher):
    """Wrap the batcher's _migrate to log the cache length it moves to."""
    seen = []
    migrate = batcher._migrate

    def wrapped(target):
        seen.append(target)
        return migrate(target)

    batcher._migrate = wrapped
    return seen


def _serve_mixed(batcher, prompts, budgets, cancel_at):
    """Submit all, step until idle, cancel request `cancel_at[1]` after
    `cancel_at[0]` ticks; returns the other requests' tokens."""
    rids = [batcher.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, budgets)]
    tick, victim = cancel_at
    for i in range(200):
        if i == tick:
            assert 1 < len(batcher.partial(rids[victim])) < budgets[victim]
            batcher.cancel(rids[victim])
        if not (batcher.num_active or batcher.num_queued):
            break
        batcher.step()
    return [batcher.result(r) for j, r in enumerate(rids) if j != victim]


@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
@pytest.mark.parametrize('impl', ['paged', 'inplace'])
def test_batcher_legacy_planes_match_jax(models, impl, kv_dtype):
    """Batch 3, decode_chunk 4, max_seq_len 128 (cache buckets 64, 128):
    two grouped short prompts, a 70-token prompt prefilled in 24-token
    windows (grows the cache to 128), a request that ends on its first
    token, a long-running short request, and one cancelled mid-decode.
    Greedy tokens and the sequence of cache migrations equal the JAX
    batcher's; the cache grows and shrinks."""
    jp, tp = models
    kw = dict(max_seq_len=128, batch_size=3, prompt_buckets=[16, 32, 96],
              prefill_chunk=24, decode_impl=impl, kv_cache_dtype=kv_dtype)
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(1, 512, size=n)]
               for n in (5, 12, 70, 9, 3, 7)]
    budgets = [6, 1, 6, 12, 40, 10]
    cancel_at = (4, 5)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jb = j_serving.ContinuousBatcher(jp, j_llama.LLAMA_DEBUG,
                                         j_engine.GeneratorConfig(**kw),
                                         decode_chunk=4)
        tb = ContinuousBatcher(tp, llama.LLAMA_DEBUG, GeneratorConfig(**kw),
                               decode_chunk=4, device='cpu')
        j_seen, t_seen = _record_migrations(jb), _record_migrations(tb)
        want = _serve_mixed(jb, prompts, budgets, cancel_at)
        got = _serve_mixed(tb, prompts, budgets, cancel_at)
    assert got == want
    assert [len(o) for o in got] == [6, 1, 6, 12, 40]
    assert t_seen == j_seen
    assert 128 in t_seen and 64 in t_seen, t_seen        # grow and shrink
    assert tb.migrations == {'grow': t_seen.count(128),
                             'shrink': t_seen.count(64)}
    assert tb.pool is None and sorted(tb._free) == [0, 1, 2]
    assert bool(tb._done.all())


# ---- Generator ---------------------------------------------------------------

@pytest.mark.parametrize('label,kw', [
    ('pooled', dict()),
    ('pooled spec_k=3', dict(spec_k=3)),
    ('paged', dict(decode_impl='paged')),
    ('inplace', dict(decode_impl='inplace')),
    ('paged int8 KV', dict(decode_impl='paged', kv_cache_dtype='int8')),
])
def test_generator_matches_jax(models, label, kw):
    """Three prompts of 5, 40 and 60 tokens, 30 new tokens each, decode
    chunks of 8: greedy tokens identical to the JAX Generator's.  The
    legacy planes start at the 64-row bucket and grow to 128."""
    jp, tp = models
    gkw = dict(max_seq_len=128, batch_size=4, prompt_buckets=[16, 64],
               decode_chunk=8, kv_block_size=16, **kw)
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(1, 512, size=n)]
               for n in (5, 40, 60)]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        want = j_engine.Generator(jp, j_llama.LLAMA_DEBUG,
                                  j_engine.GeneratorConfig(**gkw)).generate(
                                      prompts, max_new_tokens=30)
        gen = engine.Generator(tp, llama.LLAMA_DEBUG, GeneratorConfig(**gkw),
                               device='cpu')
        got = gen.generate(prompts, max_new_tokens=30)
    assert got == want
    assert [len(o) for o in got] == [30, 30, 30]
    stats = gen.last_stats
    assert stats['generated_tokens'] == 90 and stats['host_fetches'] >= 2
    if gen.pooled:
        gen.pool.check_invariant()
        assert gen.pool.stats()['blocks_live'] == 0
    else:
        assert gen.migrations == {'grow': 1, 'shrink': 0}
        assert stats['cache_len'] == 128


def test_generator_guards():
    cfg = dataclasses.replace(llama.LLAMA_DEBUG, n_layers=1)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    gen = engine.Generator(params, cfg, GeneratorConfig(
        max_seq_len=64, batch_size=2, decode_impl='inplace'), device='cpu')
    with pytest.raises(ValueError, match='3 prompts > batch 2'):
        gen.generate([[1], [2], [3]])
    with pytest.raises(ValueError, match='Empty prompt'):
        gen.generate([[]])
    assert gen.generate([[1] * 64], max_new_tokens=4) == [[]]
    with pytest.raises(NotImplementedError, match='item 10'):
        engine.Generator(params, cfg, GeneratorConfig(), mesh=object(),
                         device='cpu')
    with pytest.raises(ValueError, match='decode_chunk must be >= 1'):
        engine.Generator(params, cfg, GeneratorConfig(
            max_seq_len=64, decode_chunk=0), device='cpu')


def test_generator_eos_and_sampling_match_jax(models):
    """An eos token seen in a greedy run stops each row at its first
    occurrence, as in the JAX Generator; sampled rows (temperature > 0)
    stay in the vocabulary and within their budget."""
    jp, tp = models
    gkw = dict(max_seq_len=128, batch_size=2, prompt_buckets=[16],
               decode_chunk=4, decode_impl='paged')
    prompts = [[7, 8, 9], [3, 1, 4, 1, 5]]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        plain = engine.Generator(tp, llama.LLAMA_DEBUG, GeneratorConfig(
            **gkw), device='cpu').generate(prompts, max_new_tokens=12)
        eos = plain[0][5]
        want = j_engine.Generator(jp, j_llama.LLAMA_DEBUG,
                                  j_engine.GeneratorConfig(
                                      **gkw, eos_token=eos)).generate(
                                          prompts, max_new_tokens=12)
        got = engine.Generator(tp, llama.LLAMA_DEBUG, GeneratorConfig(
            **gkw, eos_token=eos), device='cpu').generate(
                prompts, max_new_tokens=12)
        sampled = engine.Generator(tp, llama.LLAMA_DEBUG, GeneratorConfig(
            **gkw, temperature=0.9, top_p=0.8), device='cpu').generate(
                prompts, max_new_tokens=12, seed=3)
    assert got == want
    assert got[0] == plain[0][:plain[0].index(eos) + 1]
    assert all(len(row) == 12 and all(0 <= t < llama.LLAMA_DEBUG.vocab_size
                                       for t in row) for row in sampled)


@pytest.mark.parametrize('impl', ['paged', 'inplace'])
def test_generator_eos_row_past_a_shrunk_cache(models, impl):
    """A 70-token prompt starts the cache at 128 rows; its row ends on
    eos at about row 73, while a 5-token row runs on and its chunks fit
    the 64-row bucket, so the cache shrinks under the frozen long row.
    Tokens equal the JAX Generator's, and the shrink happens."""
    jp, tp = models
    gkw = dict(max_seq_len=128, batch_size=2, prompt_buckets=[16, 96],
               decode_chunk=4, decode_impl=impl)
    rng = np.random.RandomState(6)
    prompts = [[int(t) for t in rng.randint(1, 512, size=n)]
               for n in (70, 5)]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        plain = engine.Generator(tp, llama.LLAMA_DEBUG, GeneratorConfig(
            **gkw), device='cpu').generate(prompts, max_new_tokens=20)
        # The long row's first token at step >= 1 that the short row
        # never emits: only the long row stops on it.
        k = next(k for k in range(1, 20) if plain[0][k] not in plain[1]
                 and plain[0][k] not in plain[0][:k])
        eos = plain[0][k]
        want = j_engine.Generator(jp, j_llama.LLAMA_DEBUG,
                                  j_engine.GeneratorConfig(
                                      **gkw, eos_token=eos)).generate(
                                          prompts, max_new_tokens=20)
        gen = engine.Generator(tp, llama.LLAMA_DEBUG, GeneratorConfig(
            **gkw, eos_token=eos), device='cpu')
        got = gen.generate(prompts, max_new_tokens=20)
    assert got == want
    assert got == [plain[0][:k + 1], plain[1]]
    assert gen.migrations == {'grow': 0, 'shrink': 1}
    assert gen.last_stats['cache_len'] == 64
