"""int8 KV and int8 weights in the port (skypilot_tpu_torch: infer/quant,
infer/block_pool, infer/llama_infer, infer/engine, infer/serving) against
the JAX package, on the CPU.

Tolerances, per test:
- quantization of the same f32 values: int8 values exact, scales within
  1e-7 relative op by op and one f32 ulp (2.4e-7) under the JAX jit,
  which turns the division by 127 into a product with its reciprocal;
- int8 products and model steps at LLAMA_DEBUG: f32 atol 5e-5 on
  matmuls; logits read through an int8 KV arena atol 5e-3 (f32) / 0.1
  (bf16), because a K/V value that the two sides round to neighbouring
  int8 steps (their f32 values differ in the last bits) moves a logit by
  ~1e-3; arena rows compared dequantized, within one quantization step;
- the batcher: greedy tokens identical to the JAX batcher's at
  LLAMA_DEBUG f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import block_pool as j_block_pool  # noqa: E402
from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import llama_infer as j_infer  # noqa: E402
from skypilot_tpu.infer import quant as j_quant  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu_torch.infer import block_pool, engine  # noqa: E402
from skypilot_tpu_torch.infer import llama_infer, quant  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402

INT8_KV_ATOL = {'float32': 5e-3, 'bfloat16': 0.1}
ROW_ATOL = {'float32': 5e-5, 'bfloat16': 0.1}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _models(dtype: str):
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG, dtype=jnp.dtype(dtype))
    tcfg = dataclasses.replace(llama.LLAMA_DEBUG,
                               dtype=getattr(torch, dtype))
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jcfg, tcfg, jp, llama.params_from_numpy(tree, tcfg, 'cpu')


@pytest.fixture(scope='module', params=['float32', 'bfloat16'])
def models(request):
    return (request.param,) + _models(request.param)


# ---- quantization ------------------------------------------------------------

@pytest.mark.parametrize('shape', [(16, 8), (3, 16, 8), (64, 256)])
def test_quantize_array_matches_jax(shape):
    w = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    w[..., 3] = 0.0                       # an all-zero output channel
    got = quant.quantize_array(torch.from_numpy(w))
    want = j_quant.quantize_array(jnp.asarray(w))
    assert got['q'].dtype == torch.int8 and got['s'].dtype == torch.float32
    np.testing.assert_array_equal(got['q'].numpy(), np.asarray(want['q']))
    np.testing.assert_allclose(got['s'].numpy(), np.asarray(want['s']),
                               rtol=1e-7)


def test_quantize_weights_matches_jax():
    """Every linear weight (and only those) is quantized, to the JAX
    package's values; the caller's tree is left as it was."""
    jcfg, tcfg, jp, tp = _models('float32')
    before = tp['layers']['attn']['wq'].clone()
    got = engine.prepare_params(tp, GeneratorConfig(weights_dtype='int8'))
    want = j_quant.quantize_weights(jp)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        if leaf.dtype == jnp.int8:
            assert node.dtype == torch.int8
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        else:
            np.testing.assert_allclose(_np(node), _np(leaf), rtol=2.4e-7)
    assert quant.is_quantized(got['lm_head'])
    assert not quant.is_quantized(got['embed'])
    assert torch.equal(tp['layers']['attn']['wq'], before)
    assert engine.prepare_params(tp, GeneratorConfig()) is tp


@pytest.mark.parametrize('dtype,atol,rtol', [('float32', 5e-5, 0),
                                             ('bfloat16', 5e-5, 0)])
def test_int8_matmul_matches_jax(dtype, atol, rtol):
    """(x @ q) * s against the JAX int8 product.  Both sides keep x @ q
    in f32 (every bf16 x int8 term is exact in f32) and round once,
    after the f32 rescale, so bf16 takes f32's bound: the sums differ in
    order only (~1e-7 relative at |y| ~ 24), and the bf16 outputs are
    equal."""
    rng = np.random.RandomState(2)
    x = rng.randn(5, 64).astype(np.float32)
    w = j_quant.quantize_array(jnp.asarray(rng.randn(64, 32), jnp.float32))
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = torch.from_numpy(_np(xj)).to(getattr(torch, dtype))
    wt = {'q': torch.from_numpy(np.asarray(w['q'])),
          's': torch.from_numpy(np.asarray(w['s']))}
    got = quant.matmul(xt, wt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(j_quant.matmul(xj, w)),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(
        _np(quant.matmul(xt, wt, out_dtype=torch.float32)),
        _np(j_quant.matmul(xj, w, out_dtype=jnp.float32)), atol=atol,
        rtol=rtol)


def test_int8_matmul_keeps_the_product_in_f32():
    """bf16 x (8, 4096) times an int8 (4096, 1024), f32 logits as
    lm_head takes them: within 1e-5 of max|y| of the exact (f64) product,
    as the reference's f32 accumulation is (2.6e-7).  A product rounded
    to bf16 before the scale is off by ~2e-3 of max|y|."""
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(8, 4096).astype(np.float32)).bfloat16()
    w = quant.quantize_array(
        torch.from_numpy(rng.randn(4096, 1024).astype(np.float32)))
    exact = (x.double() @ w['q'].double()) * w['s'].double()
    got = quant.matmul(x, w, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    err = float((got.double() - exact).abs().max() / exact.abs().max())
    assert err < 1e-5, err
    wj = {'q': jnp.asarray(w['q'].numpy()), 's': jnp.asarray(w['s'].numpy())}
    ref = np.asarray(j_quant.matmul(jnp.asarray(_np(x)).astype(jnp.bfloat16),
                                    wj, out_dtype=jnp.float32))
    ref_err = float(np.abs(ref - exact.numpy()).max()
                    / exact.abs().max())
    assert ref_err < 1e-5, ref_err


def test_quantize_kv_matches_jax():
    x = np.random.RandomState(4).randn(3, 5, 2, 128).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 1e-8
    q, s = llama_infer._quantize_kv(torch.from_numpy(x))
    qj, sj = j_infer._quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-7)


def test_int8_options_validate_like_jax():
    """The int8 options, spec_k and fuse_budget build; an unknown dtype
    is a ValueError in both packages."""
    for kw in (dict(kv_cache_dtype='int8', weights_dtype='int8'),
               dict(spec_k=2), dict(fuse_budget=8, prefill_chunk=16)):
        GeneratorConfig(**kw)
        j_engine.GeneratorConfig(**kw)
    jcfg, tcfg, jp, tp = _models('float32')
    for kw in (dict(max_seq_len=128, kv_cache_dtype='fp8'),
               dict(max_seq_len=128, weights_dtype='fp8')):
        with pytest.raises(ValueError, match='None or'):
            j_serving.ContinuousBatcher(jp, jcfg,
                                        j_engine.GeneratorConfig(**kw))
        with pytest.raises(ValueError, match='None or'):
            GeneratorConfig(**kw)


# ---- model level ---------------------------------------------------------------

def _arena_close(t_arena, j_arena, atol):
    """Non-garbage blocks agree dequantized, within atol plus one int8
    step."""
    for key in ('k', 'v'):
        s_t = _np(t_arena[f'{key}_scale'])[:, 1:]
        s_j = _np(j_arena[f'{key}_scale'])[:, 1:]
        np.testing.assert_allclose(s_t, s_j, atol=atol / 127, rtol=1e-3)
        d_t = _np(t_arena[key])[:, 1:] * s_t[..., None]
        d_j = _np(j_arena[key])[:, 1:] * s_j[..., None]
        assert np.all(np.abs(d_t - d_j) <= atol + 1.01 * s_j[..., None])


def test_int8_prefill_scatter_and_decode_match_jax(models):
    """Prefill into an int8 scratch cache, scatter into the int8 arena,
    then three decode steps through the int8 arena (K1's plain version:
    scales applied after each contraction, as the JAX decode off the
    TPU)."""
    dtype, jcfg, tcfg, jp, tp = models
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    lengths = np.asarray([30, 11], np.int32)
    tables_scatter = np.asarray([[3, 7], [5, 0]], np.int32)
    j_small = j_infer.init_cache(jcfg, 2, 32, kv_dtype='int8')
    j_logits, j_small = j_infer.prefill(jp, jnp.asarray(tokens), jcfg,
                                        j_small, jnp.asarray(lengths))
    j_arena = j_infer.scatter_prefill_pooled(
        j_small, j_block_pool.init_arena(jcfg, 9, 16, kv_dtype='int8'),
        jnp.asarray(tables_scatter))
    t_small = llama_infer.init_cache(tcfg, 2, 32, kv_dtype='int8',
                                     device='cpu')
    t_logits, _ = llama_infer.prefill(tp, torch.from_numpy(tokens), tcfg,
                                      t_small, torch.from_numpy(lengths))
    t_arena = block_pool.init_arena(tcfg, 9, 16, kv_dtype='int8',
                                    device='cpu')
    llama_infer.scatter_prefill_pooled(t_small, t_arena,
                                       torch.from_numpy(tables_scatter))
    np.testing.assert_allclose(_np(t_logits), _np(j_logits),
                               atol=ROW_ATOL[dtype])
    _arena_close(t_arena, j_arena, ROW_ATOL[dtype])
    tables = np.asarray([[3, 7, 2, 0], [5, 4, 0, 0]], np.int32)
    positions = lengths.copy()
    token = np.array(jnp.argmax(j_logits, -1), np.int32)
    for _ in range(3):
        j_logits, j_arena = j_infer.decode_step_pooled(
            jp, jnp.asarray(token), jcfg, j_arena, jnp.asarray(positions),
            jnp.asarray(tables))
        t_logits, _ = llama_infer.decode_step_pooled(
            tp, torch.from_numpy(token), tcfg, t_arena,
            torch.from_numpy(positions), torch.from_numpy(tables))
        np.testing.assert_allclose(_np(t_logits), _np(j_logits),
                                   atol=INT8_KV_ATOL[dtype])
        _arena_close(t_arena, j_arena, ROW_ATOL[dtype])
        token = np.array(jnp.argmax(j_logits, -1), np.int32)
        positions = positions + 1


def test_int8_window_prefill_matches_jax(models):
    """A chunked-prefill window over an int8 arena (dequantize, then the
    products, as the JAX window prefill)."""
    dtype, jcfg, tcfg, jp, tp = models
    window = np.random.RandomState(6).randint(
        1, jcfg.vocab_size, size=16).astype(np.int32)
    table_row = np.asarray([6, 2, 8, 0], np.int32)
    j_arena = j_block_pool.init_arena(jcfg, 9, 16, kv_dtype='int8')
    t_arena = block_pool.init_arena(tcfg, 9, 16, kv_dtype='int8',
                                    device='cpu')
    for start in (0, 16):
        j_h, j_arena = j_infer.prefill_window_pooled(
            jp, jnp.asarray(window), jcfg, j_arena, jnp.asarray(table_row),
            jnp.int32(start))
        t_h, _ = llama_infer.prefill_window_pooled(
            tp, torch.from_numpy(window), tcfg, t_arena,
            torch.from_numpy(table_row), start)
        np.testing.assert_allclose(_np(t_h), _np(j_h),
                                   atol=INT8_KV_ATOL[dtype])
        _arena_close(t_arena, j_arena, ROW_ATOL[dtype])


# ---- batcher level ---------------------------------------------------------------

@pytest.mark.parametrize('extra', [
    dict(kv_cache_dtype='int8'), dict(weights_dtype='int8'),
    dict(kv_cache_dtype='int8', weights_dtype='int8', spec_k=3,
         fuse_budget=8)], ids=['int8-kv', 'int8-weights', 'int8-all'])
def test_int8_batcher_tokens_match_jax(extra):
    """Greedy tokens identical to the JAX ContinuousBatcher's at
    LLAMA_DEBUG f32 (mixed lengths, two chunked prompts, more requests
    than slots), pool invariant after every step."""
    jp = j_llama.init_params(j_llama.LLAMA_DEBUG, jax.random.PRNGKey(0))
    tp = llama.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
        llama.LLAMA_DEBUG, 'cpu')
    kw = dict(max_seq_len=128, batch_size=4, prompt_buckets=[16, 32, 64],
              prefill_chunk=24, kv_block_size=16, **extra)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, 512, size=n)]
               for n in (5, 12, 30, 3, 9, 40)]
    budgets = [10, 6, 8, 12, 5, 9]
    jb = j_serving.ContinuousBatcher(jp, j_llama.LLAMA_DEBUG,
                                     j_engine.GeneratorConfig(**kw),
                                     decode_chunk=4)
    j_rids = [jb.submit(p, max_new_tokens=n)
              for p, n in zip(prompts, budgets)]
    jb.run_until_idle()
    want = [jb.result(r) for r in j_rids]
    tb = ContinuousBatcher(tp, llama.LLAMA_DEBUG, GeneratorConfig(**kw),
                           decode_chunk=4, device='cpu')
    if 'kv_cache_dtype' in extra:
        assert tb.pool.arena['k'].dtype == torch.int8
    if 'weights_dtype' in extra:
        assert quant.is_quantized(tb.params['layers']['mlp']['w_up'])
    rids = [tb.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    for _ in range(500):
        if not (tb.num_active or tb.num_queued):
            break
        tb.step()
        tb.pool.check_invariant()
    assert [tb.result(r) for r in rids] == want
    st = tb.pool.stats()
    assert st['blocks_live'] == 0 and st['reserved'] == 0
