"""Speculative verify, the fused prefill+decode step and the window
attention kernel's plain version (skypilot_tpu_torch: ops/decode_attention,
infer/{sampling,spec_decode,fuse,llama_infer,serving}) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs its Pallas kernels in interpret mode.  Tolerances, per test:
- attention outputs in f32: atol 1e-5 (summation order); bf16: two bf16
  ulps at |o| < 2 (the JAX kernel keeps p in f32, the port's plain
  version casts it to bf16 as the JAX decode off the TPU does);
- model steps at LLAMA_DEBUG: logits and arena rows atol 5e-5 in f32,
  0.1 in bf16 (the bf16 products of every matmul round at other places);
  int8 arena rows may differ by one quantization step where the two
  sides' f32 values straddle a rounding boundary, which moves a logit by
  ~1e-3 (int8 KV logits: atol 5e-3 in f32);
- host logic (drafter, policies, accept rules): exact;
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
from skypilot_tpu.infer import fuse as j_fuse  # noqa: E402
from skypilot_tpu.infer import llama_infer as j_infer  # noqa: E402
from skypilot_tpu.infer import sampling as j_sampling  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.infer import spec_decode as j_spec  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.ops import decode_attention as j_decode  # noqa: E402
from skypilot_tpu_torch.infer import block_pool  # noqa: E402
from skypilot_tpu_torch.infer import engine  # noqa: E402
from skypilot_tpu_torch.infer import fuse, llama_infer  # noqa: E402
from skypilot_tpu_torch.infer import sampling, spec_decode  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.ops import decode_attention as da  # noqa: E402

F32_ATOL = 1e-5
BF16_ATOL = 2 * 2 ** -7
MODEL_ATOL = {'float32': 5e-5, 'bfloat16': 0.1}
# An int8 KV row that the two sides round to neighbouring int8 values
# (their f32 K/V differ in the last bits) moves a logit by ~1e-3.
INT8_KV_ATOL = {'float32': 5e-3, 'bfloat16': 0.1}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _int8_rows(x: np.ndarray):
    s = np.maximum(np.abs(x).max(-1), 1e-8).astype(np.float32) / 127.0
    return np.round(x / s[..., None]).astype(np.int8), s


# ---- window attention (K4's plain version) ---------------------------------

BS, T_WIDTH, KV, GROUP, HD, BATCH = 16, 4, 2, 2, 128, 4


def _window_case(win, seed):
    """Scattered tables covering each slot's window; window starts at 0,
    the block edges BS-1 and BS, and the table's last row (the later
    rows of that window run past the table)."""
    rng = np.random.RandomState(seed)
    nb = 1 + BATCH * T_WIDTH
    q = rng.randn(BATCH, win, KV, GROUP, HD).astype(np.float32)
    k = rng.randn(2, nb, BS, KV, HD).astype(np.float32)
    v = rng.randn(2, nb, BS, KV, HD).astype(np.float32)
    positions = np.asarray([0, BS - 1, BS, T_WIDTH * BS - 1], np.int32)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((BATCH, T_WIDTH), np.int32)
    for b in range(BATCH):
        live = min((positions[b] + win - 1) // BS + 1, T_WIDTH)
        tables[b, :live] = perm[b * T_WIDTH:b * T_WIDTH + live]
    return q, k, v, tables, positions


def _inputs(kind, q, k, v):
    """(q, k, v, k_scale, v_scale) as numpy for `kind`: f32, bf16
    (values rounded once, in JAX) or an int8 arena with f32 q."""
    if kind == 'int8':
        k8, ks = _int8_rows(k)
        v8, vs = _int8_rows(v)
        return q, k8, v8, ks, vs
    if kind == 'bfloat16':
        q, k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32)) for a in (q, k, v))
    return q, k, v, None, None


def _to_torch(kind, arrs):
    dt = torch.bfloat16 if kind == 'bfloat16' else None
    out = []
    for a in arrs:
        if a is None:
            out.append(None)
            continue
        t = _t(a)
        out.append(t.to(dt) if dt is not None and t.is_floating_point()
                   and a.ndim >= 4 else t)
    return out


def _to_jax(kind, arrs):
    return [None if a is None else
            (jnp.asarray(a).astype(jnp.bfloat16)
             if kind == 'bfloat16' and a.ndim >= 4 else jnp.asarray(a))
            for a in arrs]


@pytest.mark.parametrize('kind', ['float32', 'bfloat16', 'int8'])
@pytest.mark.parametrize('win', [1, 4, 13])
def test_window_attention_matches_jax(kind, win):
    """decode_window_attention_pooled against the JAX kernel (interpret
    mode) and the JAX oracle; each window row equals single-token decode
    at its own position."""
    q, k, v, tables, positions = _window_case(win, seed=win)
    qn, kn, vn, ks, vs = _inputs(kind, q, k, v)
    qt, kt, vt, kst, vst = _to_torch(kind, (qn, kn, vn, ks, vs))
    layer = 1
    out = da.decode_window_attention_pooled(
        qt, kt, vt, _t(tables), layer, _t(positions), kst, vst)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    qj, kj, vj, ksj, vsj = _to_jax(kind, (qn, kn, vn, ks, vs))
    ref = j_decode.decode_window_attention_pooled(
        qj, kj, vj, jnp.asarray(tables), layer, jnp.asarray(positions),
        ksj, vsj, interpret=True)
    atol = BF16_ATOL if kind == 'bfloat16' else F32_ATOL
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=0)

    # The all-f32 oracles over the gathered (dequantized) layer view.
    k_f = kn.astype(np.float32) * (ks[..., None] if ks is not None else 1)
    v_f = vn.astype(np.float32) * (vs[..., None] if vs is not None else 1)
    k_g = k_f[layer][tables].reshape(BATCH, -1, KV, HD)
    v_g = v_f[layer][tables].reshape(BATCH, -1, KV, HD)
    oracle = da.reference_decode_window_attention(
        _t(qn), _t(k_g), _t(v_g), _t(positions))
    j_oracle = j_decode.reference_decode_window_attention(
        jnp.asarray(qn), jnp.asarray(k_g), jnp.asarray(v_g),
        jnp.asarray(positions))
    np.testing.assert_allclose(oracle.numpy(), _np(j_oracle), atol=F32_ATOL)
    np.testing.assert_allclose(_np(out), oracle.numpy(), atol=atol)

    for w in range(win):
        rows = np.minimum(positions + w, T_WIDTH * BS - 1).astype(np.int32)
        single = da.decode_attention_pooled(
            qt[:, w], kt, vt, _t(tables), layer, _t(rows), kst, vst)
        np.testing.assert_allclose(_np(out[:, w]), _np(single), atol=1e-6)


@pytest.mark.parametrize('kind', ['float32', 'int8'])
def test_window_attention_ignores_keys_past_the_window(kind):
    """Keys past each slot's last window row, and blocks no table maps
    (the garbage block included), must not change any output row."""
    win = 4
    q, k, v, tables, positions = _window_case(win, seed=11)
    qn, kn, vn, ks, vs = _inputs(kind, q, k, v)
    layer = 0
    poison = 127 if kind == 'int8' else 1e4
    k2, v2 = kn.copy(), vn.copy()
    mapped = set(tables.flatten().tolist()) - {0}
    unmapped = [b for b in range(kn.shape[1]) if b not in mapped]
    k2[:, unmapped] = poison
    v2[:, unmapped] = -poison
    for b, pos in enumerate(positions):
        last = pos + win - 1
        if last < T_WIDTH * BS - 1:
            blk = tables[b, last // BS]
            k2[layer, blk, last % BS + 1:] = poison
            v2[layer, blk, last % BS + 1:] = -poison
    args = (_t(tables), layer, _t(positions),
            None if ks is None else _t(ks), None if vs is None else _t(vs))
    out1 = da.decode_window_attention_pooled(_t(qn), _t(kn), _t(vn), *args)
    out2 = da.decode_window_attention_pooled(_t(qn), _t(k2), _t(v2), *args)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


@pytest.mark.parametrize('quantized', [False, True])
def test_fused_attention_matches_jax(quantized):
    """Both lanes of fused_step_attention_pooled (decode rows through
    scattered tables, the prefill window through its own table row)
    against the JAX op in interpret mode and the oracles; mirrors the
    JAX package's test_fused_attention_matches_reference."""
    rng = np.random.RandomState(1)
    lay, nb, bs, kv, group, hd, batch, width = 2, 8, 64, 2, 2, 128, 2, 4
    q = rng.randn(batch, kv, group, hd).astype(np.float32)
    q_pf = rng.randn(width, kv, group, hd).astype(np.float32)
    k = rng.randn(lay, nb, bs, kv, hd).astype(np.float32)
    v = rng.randn(lay, nb, bs, kv, hd).astype(np.float32)
    ks = vs = None
    if quantized:
        k, ks = _int8_rows(k)
        v, vs = _int8_rows(v)
    tables = np.asarray([[3, 6, 1], [5, 0, 0]], np.int32)
    pf_row = np.asarray([2, 4, 7], np.int32)
    positions = np.asarray([150, 40], np.int32)
    pf_start, layer = 70, 1
    opt = lambda a: None if a is None else _t(a)  # noqa: E731
    o_dec, o_pf = da.fused_step_attention_pooled(
        _t(q), _t(q_pf), _t(k), _t(v), _t(tables), _t(pf_row), layer,
        _t(positions), pf_start, opt(ks), opt(vs))
    jopt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    r_dec, r_pf = j_decode.fused_step_attention_pooled(
        jnp.asarray(q), jnp.asarray(q_pf), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(pf_row), layer,
        jnp.asarray(positions), jnp.int32(pf_start), jopt(ks), jopt(vs),
        interpret=True)
    np.testing.assert_allclose(o_dec.numpy(), _np(r_dec), atol=2e-5)
    np.testing.assert_allclose(o_pf.numpy(), _np(r_pf), atol=2e-5)
    k_f = k.astype(np.float32) * (ks[..., None] if quantized else 1)
    v_f = v.astype(np.float32) * (vs[..., None] if quantized else 1)
    s_len = tables.shape[1] * bs
    o1, o2 = da.reference_fused_step_attention(
        _t(q), _t(k_f[layer][tables].reshape(batch, s_len, kv, hd)),
        _t(v_f[layer][tables].reshape(batch, s_len, kv, hd)),
        _t(positions), _t(q_pf), _t(k_f[layer][pf_row].reshape(s_len, kv, hd)),
        _t(v_f[layer][pf_row].reshape(s_len, kv, hd)), pf_start)
    np.testing.assert_allclose(o1.numpy(), o_dec.numpy(), atol=2e-5)
    np.testing.assert_allclose(o2.numpy(), o_pf.numpy(), atol=2e-5)


# ---- host logic: accept rules, drafter, policies ---------------------------

def test_accept_rules_match_jax():
    rng = np.random.RandomState(3)
    batch, k, vocab = 6, 4, 5
    logits = rng.randn(batch, k + 1, vocab).astype(np.float32)
    targets = np.argmax(logits, -1).astype(np.int32)
    draft = targets[:, :-1].copy()
    for b, cut in enumerate([0, 1, 2, 4, 3, 0]):
        if cut < k:                      # first mismatch at `cut`
            draft[b, cut] = (draft[b, cut] + 1) % vocab
    draft[5] = rng.randint(0, vocab, size=k)
    got_t, got_a = sampling.spec_accept_greedy(_t(logits), _t(draft))
    want_t, want_a = j_sampling.spec_accept_greedy(jnp.asarray(logits),
                                                   jnp.asarray(draft))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert got_a.dtype == torch.int32 and list(got_a[:4]) == [0, 1, 2, 4]
    np.testing.assert_array_equal(
        sampling._accept_prefix_len(_t(targets), _t(draft)).numpy(),
        np.asarray(j_sampling._accept_prefix_len(jnp.asarray(targets),
                                                 jnp.asarray(draft))))


@pytest.mark.parametrize('eos', [None, 20, 7])
def test_accept_window_matches_jax(eos):
    rng = np.random.RandomState(0 if eos is None else eos)
    batch, win = 8, 4
    targets = rng.randint(5, 25, size=(batch, win)).astype(np.int32)
    accepts = rng.randint(0, win, size=batch).astype(np.int32)
    done = rng.rand(batch) < 0.25
    limit = rng.randint(1, 6, size=batch).astype(np.int32)
    positions = rng.randint(0, 50, size=batch).astype(np.int32)
    token = rng.randint(0, 30, size=batch).astype(np.int32)
    fill = eos if eos is not None else 0
    got = spec_decode.accept_window(
        _t(targets), _t(accepts), _t(done), _t(limit), _t(positions),
        _t(token), eos=eos, fill=fill)
    want = j_spec.accept_window(
        jnp.asarray(targets), jnp.asarray(accepts), jnp.asarray(done),
        jnp.asarray(limit), jnp.asarray(positions), jnp.asarray(token),
        eos=eos, fill=jnp.int32(fill))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ngram_drafter_matches_jax():
    """A seeded call sequence (resets with and without a continuation,
    observes, proposals of single slots and of the batch) gives the JAX
    drafter's proposals exactly."""
    rng = np.random.RandomState(5)
    mine, ref = spec_decode.NgramDrafter(3, 4), j_spec.NgramDrafter(3, 4)
    for step in range(60):
        slot = int(rng.randint(0, 3))
        op = step % 5
        if op == 0:
            prompt = rng.randint(0, 6, size=rng.randint(1, 9)).tolist()
            cont = (rng.randint(0, 6, size=5).tolist()
                    if rng.rand() < 0.5 else ())
            mine.reset(slot, prompt, cont)
            ref.reset(slot, prompt, cont)
        elif op in (1, 2):
            toks = rng.randint(0, 6, size=rng.randint(1, 4)).tolist()
            mine.observe(slot, toks)
            ref.observe(slot, toks)
        else:
            assert mine.propose(slot) == ref.propose(slot)
            live = sorted(set(rng.randint(0, 3, size=2).tolist()))
            np.testing.assert_array_equal(mine.propose_batch(live, 3),
                                          ref.propose_batch(live, 3))
    with pytest.raises(ValueError, match='k >= 1'):
        spec_decode.NgramDrafter(1, 0)


def test_spec_policy_matches_jax():
    rng = np.random.RandomState(7)
    mine, ref = spec_decode.SpecPolicy(), j_spec.SpecPolicy()
    for _ in range(80):
        assert mine.should_speculate() == ref.should_speculate()
        proposed = int(rng.randint(0, 13))
        accepted = int(rng.randint(0, proposed + 1)) if rng.rand() < 0.3 \
            else 0
        mine.record(accepted, proposed)
        ref.record(accepted, proposed)
        assert mine.ema == ref.ema


def test_fuse_policy_matches_jax():
    mine, ref = fuse.FusePolicy(8), j_fuse.FusePolicy(8)
    for remaining, active in ((100, 3), (2, 3), (100, 8), (100, 0), (0, 2),
                              (7, 1)):
        assert mine.chunk(remaining, active) == ref.chunk(remaining, active)
        c = mine.chunk(remaining, active)
        assert mine.utilization(c) == ref.utilization(c)
        mine.record_fused(c)
        ref.record_fused(c)
    mine.record_dedicated()
    ref.record_dedicated()
    assert dataclasses.asdict(mine.stats) == dataclasses.asdict(ref.stats)
    with pytest.raises(ValueError, match='fuse_budget'):
        fuse.FusePolicy(0)


def test_spec_accept_sampled_preserves_target_distribution():
    """Monte Carlo, as the JAX package's test: the first committed token
    of a sampled verify window is distributed as the target softmax, and
    the draft gates only how many tokens commit, never their values."""
    vocab, n = 8, 4000
    logits = torch.from_numpy(
        np.random.RandomState(3).randn(1, 2, vocab).astype(np.float32))
    ones = torch.ones((n,))
    gen = torch.Generator().manual_seed(11)
    targets, accepts = sampling.spec_accept_sampled(
        logits.expand(n, 2, vocab), torch.zeros((n, 1), dtype=torch.int32),
        gen, ones, ones)
    emp = np.bincount(targets[:, 0].numpy(), minlength=vocab) / n
    want = torch.softmax(logits[0, 0], -1).numpy()
    assert np.abs(emp - want).sum() < 0.1
    assert torch.equal(accepts, (targets[:, 0] == 0).to(torch.int32))
    t_a, _ = sampling.spec_accept_sampled(
        logits.expand(4, 2, vocab), torch.zeros((4, 1), dtype=torch.int32),
        torch.Generator().manual_seed(2), ones[:4], ones[:4])
    t_b, _ = sampling.spec_accept_sampled(
        logits.expand(4, 2, vocab), torch.full((4, 1), 5, dtype=torch.int32),
        torch.Generator().manual_seed(2), ones[:4], ones[:4])
    assert torch.equal(t_a, t_b)


# ---- model level: verify and fused steps at LLAMA_DEBUG --------------------

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


def _arena_close(t_arena, j_arena, atol):
    """Every non-garbage block agrees; int8 rows are compared
    dequantized, within atol plus one quantization step."""
    if 'k_scale' not in j_arena:
        for key in ('k', 'v'):
            np.testing.assert_allclose(_np(t_arena[key])[:, 1:],
                                       _np(j_arena[key])[:, 1:], atol=atol)
        return
    for key in ('k', 'v'):
        s_t = _np(t_arena[f'{key}_scale'])[:, 1:]
        s_j = _np(j_arena[f'{key}_scale'])[:, 1:]
        np.testing.assert_allclose(s_t, s_j, atol=atol / 127, rtol=1e-3)
        d_t = _np(t_arena[key])[:, 1:] * s_t[..., None]
        d_j = _np(j_arena[key])[:, 1:] * s_j[..., None]
        assert np.all(np.abs(d_t - d_j) <= atol + 1.01 * s_j[..., None])


def _seeded_arenas(jcfg, tcfg, jp, tp, kv_dtype):
    """Both packages' arenas with two decoding slots (10-token contexts)
    and a prefill slot's first 8-token chunk, as the JAX package's
    test_model_fused_step_matches_dedicated seeds them."""
    j_arena = j_block_pool.init_arena(jcfg, 10, 8, kv_dtype=kv_dtype)
    t_arena = block_pool.init_arena(tcfg, 10, 8, kv_dtype=kv_dtype,
                                    device='cpu')
    rng = np.random.RandomState(3)
    rows = ([1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 7, 0])
    for row, n in zip(rows, (10, 10, 8)):
        toks = rng.randint(1, 97, size=n).astype(np.int32)
        row = np.asarray(row, np.int32)
        _, j_arena = j_infer.prefill_window_pooled(
            jp, jnp.asarray(toks), jcfg, j_arena, jnp.asarray(row),
            jnp.int32(0))
        llama_infer.prefill_window_pooled(tp, _t(toks), tcfg, t_arena,
                                          _t(row), 0)
    return j_arena, t_arena


@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
def test_decode_verify_matches_jax(models, kv_dtype):
    """One verify window of W = 4 per slot: logits at every window
    position and the arena rows written agree with the JAX step; one
    slot's window runs past its table (the parked-slot case)."""
    dtype, jcfg, tcfg, jp, tp = models
    j_arena, t_arena = _seeded_arenas(jcfg, tcfg, jp, tp, kv_dtype)
    tables = np.asarray([[1, 2, 0, 0], [3, 4, 8, 9]], np.int32)
    positions = np.asarray([10, 30], np.int32)
    tokens = np.asarray([[11, 22, 33, 44], [55, 66, 77, 88]], np.int32)
    j_logits, j_arena = j_infer.decode_verify_pooled(
        jp, jnp.asarray(tokens), jcfg, j_arena, jnp.asarray(positions),
        jnp.asarray(tables))
    t_logits, _ = llama_infer.decode_verify_pooled(
        tp, _t(tokens), tcfg, t_arena, _t(positions), _t(tables))
    assert t_logits.shape == (2, 4, tcfg.vocab_size)
    atol = (INT8_KV_ATOL if kv_dtype else MODEL_ATOL)[dtype]
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), atol=atol)
    if dtype == 'float32':
        np.testing.assert_array_equal(t_logits.argmax(-1).numpy(),
                                      np.asarray(j_logits).argmax(-1))
    _arena_close(t_arena, j_arena, MODEL_ATOL[dtype])


@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
def test_fused_step_matches_jax_and_dedicated(models, kv_dtype):
    """fused_step_pooled against the JAX fused step (decode logits, chunk
    hiddens, arena), and against the port's own dedicated two-step
    schedule (decode_step_pooled then prefill_window_pooled)."""
    dtype, jcfg, tcfg, jp, tp = models
    j_arena, t_arena = _seeded_arenas(jcfg, tcfg, jp, tp, kv_dtype)
    ded = {k: v.clone() for k, v in t_arena.items()}
    tables = np.asarray([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    pf_row = np.asarray([5, 6, 7, 0], np.int32)
    token = np.asarray([11, 22], np.int32)
    positions = np.asarray([10, 10], np.int32)
    chunk = np.zeros((6,), np.int32)        # 4 real tokens, 6-wide lane
    chunk[:4] = np.random.RandomState(4).randint(1, 97, size=4)
    j_logits, j_h, j_arena = j_infer.fused_step_pooled(
        jp, jnp.asarray(token), jcfg, j_arena, jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(chunk), jnp.asarray(pf_row),
        jnp.int32(8))
    t_logits, t_h, _ = llama_infer.fused_step_pooled(
        tp, _t(token), tcfg, t_arena, _t(positions), _t(tables), _t(chunk),
        _t(pf_row), 8)
    atol = (INT8_KV_ATOL if kv_dtype else MODEL_ATOL)[dtype]
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), atol=atol)
    np.testing.assert_allclose(_np(t_h), _np(j_h), atol=atol)
    _arena_close(t_arena, j_arena, MODEL_ATOL[dtype])
    atol = MODEL_ATOL[dtype]

    d_logits, _ = llama_infer.decode_step_pooled(
        tp, _t(token), tcfg, ded, _t(positions), _t(tables))
    d_h, _ = llama_infer.prefill_window_pooled(tp, _t(chunk), tcfg, ded,
                                               _t(pf_row), 8)
    np.testing.assert_allclose(_np(t_logits), _np(d_logits), atol=atol)
    np.testing.assert_allclose(_np(t_h), _np(d_h), atol=atol)
    _arena_close(t_arena, ded, atol)
    if dtype == 'float32':
        np.testing.assert_array_equal(t_logits.argmax(-1).numpy(),
                                      d_logits.argmax(-1).numpy())


# ---- batcher level ----------------------------------------------------------

KW = dict(max_seq_len=128, batch_size=4, prompt_buckets=[16, 32, 64],
          prefill_chunk=24, kv_block_size=16)
BUDGETS = [10, 6, 8, 12, 5, 9]


def _prompts():
    """Four short prompts and two chunked ones (30 and 40 tokens over a
    24-token prefill window), more requests than slots."""
    rng = np.random.RandomState(0)
    return [[int(t) for t in rng.randint(1, 512, size=n)]
            for n in (5, 12, 30, 3, 9, 40)]


@pytest.fixture(scope='module')
def debug_params():
    jp = j_llama.init_params(j_llama.LLAMA_DEBUG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, llama.params_from_numpy(tree, llama.LLAMA_DEBUG, 'cpu')


def _drain(batcher, max_ticks=500, each=None):
    """Step to idle with the pool invariant checked after every step."""
    for _ in range(max_ticks):
        if not (batcher.num_active or batcher.num_queued):
            return
        batcher.step()
        batcher.pool.check_invariant()
        if each is not None:
            each()
    raise AssertionError('batcher did not go idle')


def _port_run(tp, prompts=None, budgets=BUDGETS, **extra):
    b = ContinuousBatcher(tp, llama.LLAMA_DEBUG, GeneratorConfig(**KW,
                                                                 **extra),
                          decode_chunk=4, device='cpu')
    rids = [b.submit(p, max_new_tokens=n)
            for p, n in zip(prompts or _prompts(), budgets)]
    _drain(b)
    return b, [b.result(r) for r in rids]


@pytest.mark.parametrize('extra', [
    dict(spec_k=3), dict(fuse_budget=8), dict(spec_k=3, fuse_budget=8)],
    ids=['spec', 'fused', 'spec+fused'])
def test_batcher_tokens_match_jax(debug_params, extra):
    """Greedy tokens identical to the JAX ContinuousBatcher's at
    LLAMA_DEBUG f32, with the same fuse accounting and speculation
    policy state."""
    jp, tp = debug_params
    jb = j_serving.ContinuousBatcher(
        jp, j_llama.LLAMA_DEBUG, j_engine.GeneratorConfig(**KW, **extra),
        decode_chunk=4)
    j_rids = [jb.submit(p, max_new_tokens=n)
              for p, n in zip(_prompts(), BUDGETS)]
    jb.run_until_idle()
    want = [jb.result(r) for r in j_rids]
    b, got = _port_run(tp, **extra)
    assert got == want
    assert [len(o) for o in got] == BUDGETS
    if 'fuse_budget' in extra:
        assert b._fuse_policy.stats.steps > 0
        assert dataclasses.asdict(b._fuse_policy.stats) == \
            dataclasses.asdict(jb._fuse_policy.stats)
    if 'spec_k' in extra:
        assert b.spec_proposed > 0
        assert b._spec_policy.ema == jb._spec_policy.ema
    st = b.pool.stats()
    assert st['blocks_live'] == 0 and st['reserved'] == 0


def _golden(b, futures):
    """Seed each admitted slot's drafter with a known continuation of its
    prompt, first token included (what the prefix cache will supply), so
    verify chunks accept drafts."""
    def reset(req):
        b._drafter.reset(req.slot, req.prompt, futures[tuple(req.prompt)])
        b._drafter.observe(req.slot, req.out[-1:])
    b._reset_drafter = reset


def test_spec_rollback_is_cursor_only(debug_params):
    """With drafts that are right for a while and then wrong, spec-on
    gives spec-off's tokens, accepts and rejects drafts, keeps the pool
    invariant after every step, and ends with spec-off's free list and
    refcounts: rejected rows cost no block."""
    _, tp = debug_params
    prompts = _prompts()
    b0, ref = _port_run(tp, prompts)
    futures = {}
    for p, out in zip(prompts, ref):
        future = list(out)
        if len(future) > 5:
            future[5] = (future[5] + 1) % 512        # a wrong draft
        futures[tuple(p)] = future
    b = ContinuousBatcher(tp, llama.LLAMA_DEBUG,
                          GeneratorConfig(**KW, spec_k=3), decode_chunk=4,
                          device='cpu')
    _golden(b, futures)
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)]
    _drain(b)
    assert [b.result(r) for r in rids] == ref
    assert 0 < b.spec_accepted < b.spec_proposed
    assert len(b.pool._free) == len(b0.pool._free)
    assert sorted(b.pool._refs.tolist()) == sorted(b0.pool._refs.tolist())


def test_spec_and_fused_give_the_plain_schedules_tokens(debug_params):
    _, tp = debug_params
    _, ref = _port_run(tp)
    b, spec = _port_run(tp, spec_k=3)
    assert spec == ref and b.spec_proposed > 0
    b, fused = _port_run(tp, fuse_budget=8)
    assert fused == ref and b._fuse_policy.stats.steps > 0
    assert _port_run(tp, spec_k=2, fuse_budget=5)[1] == ref


def test_one_host_fetch_per_spec_and_fused_chunk(debug_params,
                                                 monkeypatch):
    """With nothing left to admit, a verify chunk and a fused chunk each
    make exactly one host fetch (the fused chunk that lands a prompt's
    last piece adds that prompt's first-token fetch), and nothing else
    syncs inside them."""
    _, tp = debug_params
    prompts = _prompts()
    budgets = [20, 16, 18, 24, 14, 20]
    _, ref = _port_run(tp, prompts, budgets)
    b = ContinuousBatcher(tp, llama.LLAMA_DEBUG, GeneratorConfig(
        **KW, spec_k=3, fuse_budget=8), decode_chunk=4, device='cpu')
    _golden(b, {tuple(p): list(o) for p, o in zip(prompts, ref)})
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]

    def no_sync(*args, **kwargs):
        raise AssertionError('host sync inside a chunk')

    for name in ('item', 'tolist', 'cpu'):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    kinds = set()
    while b.num_active or b.num_queued:
        calls0 = engine.host_fetch.calls
        fused0 = b._fuse_policy.stats.steps
        proposed0 = b.spec_proposed
        nothing_queued = not b._queue
        lane = b._incremental
        b.step()
        b.pool.check_invariant()
        fetched = engine.host_fetch.calls - calls0
        if not nothing_queued:
            continue
        if b._fuse_policy.stats.steps > fused0:
            kinds.add('fused')
            assert fetched == 1 + int(b._incremental is not lane)
        elif b.spec_proposed > proposed0 and lane is None:
            kinds.add('spec')
            assert fetched == 1
    monkeypatch.undo()
    assert kinds == {'fused', 'spec'}
    assert [b.result(r) for r in rids] == ref
