"""The port's training path (skypilot_tpu_torch: the attention backward,
rms_norm's and rope's gradients, ops/losses.py, the Llama training
forward and loss, train/trainer.py) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  On CPU
tensors the kernel wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode and its plain references, as the
JAX package's own tests do.  Tolerances, all f32 unless said:
- kernels' math (attention backward, lse, norm, rope, chunked CE): atol
  1e-5 (summation order only) on values of magnitude ~1-10;
- LLAMA_DEBUG loss and gradients: rtol 1e-4 on the loss, and per leaf
  atol 1e-4 * max|grad| (the port's norm and attention backwards are the
  JAX package's hand-written formulas, its reference differentiates the
  plain forward, so the two sum in other orders through 2 layers);
- optimizer steps: loss and grad_norm at rtol 1e-5; parameters within
  2 x the summed learning rates, because Adam moves an element whose
  gradient is ~0 by up to lr whichever way rounding tips it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.ops import attention as j_attention  # noqa: E402
from skypilot_tpu.ops import losses as j_losses  # noqa: E402
from skypilot_tpu.ops import rmsnorm as j_rmsnorm  # noqa: E402
from skypilot_tpu.ops import rope as j_rope  # noqa: E402
from skypilot_tpu.parallel import MeshConfig, make_mesh  # noqa: E402
from skypilot_tpu.parallel import sharding as j_sharding  # noqa: E402
from skypilot_tpu.train import trainer as j_trainer  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.ops import attention  # noqa: E402
from skypilot_tpu_torch.ops import losses  # noqa: E402
from skypilot_tpu_torch.ops import rmsnorm  # noqa: E402
from skypilot_tpu_torch.ops import rope  # noqa: E402
from skypilot_tpu_torch.train import trainer  # noqa: E402

ATOL = 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arr: np.ndarray, dtype: str = 'float32'):
    j = jnp.asarray(arr).astype(jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)


# ---- attention: lse and backward --------------------------------------------

def _attn_inputs(seed, batch, seq, heads, kv, hd):
    rng = np.random.RandomState(seed)
    shapes = [(batch, seq, heads, hd), (batch, seq, kv, hd),
              (batch, seq, kv, hd), (batch, seq, heads, hd)]
    return [_pair(rng.randn(*s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('kv_heads', [4, 2])
def test_flash_backward_plain_matches_jax(causal, kv_heads):
    """The plain backward from the lse, against the JAX interpret-mode
    _flash_bwd (fed its own _flash_fwd lse), _xla_attention_bwd and
    jax.vjp of reference_attention; and the lse against _flash_fwd's."""
    (q_j, q), (k_j, k), (v_j, v), (g_j, g) = _attn_inputs(
        kv_heads + causal, 1, 256, 4, kv_heads, 128)
    sw = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
    o_jt, lse_j = j_attention._flash_fwd(sw(q_j), sw(k_j), sw(v_j), causal,
                                         128, interpret=True, need_lse=True)
    o, lse = attention.flash_attention_fwd(q, k, v, causal, need_lse=True)
    assert lse.shape == (1, 4, 256) and lse.dtype == torch.float32
    _close(lse, lse_j[..., 0])
    _close(o, sw(o_jt))

    dq, dk, dv = attention._flash_attention_bwd_plain(q, k, v, o, lse, g,
                                                      causal)
    kern = j_attention._flash_bwd(sw(q_j), sw(k_j), sw(v_j), o_jt, lse_j,
                                  sw(g_j), causal, 128, interpret=True)
    xla = j_attention._xla_attention_bwd(causal, (q_j, k_j, v_j), g_j)
    _, vjp = jax.vjp(lambda a, b, c: j_attention.reference_attention(
        a, b, c, causal=causal), q_j, k_j, v_j)
    for ref in ([sw(x) for x in kern], xla, vjp(g_j)):
        for got, want in zip((dq, dk, dv), ref):
            _close(got, want)


@pytest.mark.parametrize('hd,group,seq', [
    (64, 2, 128),
    # The training configuration's head_dim and group (LLAMA_1B, 8B):
    # the shapes the tensor-core K5/K6 take on the card.
    (128, 4, 256),
    # Gemma's head_dim: MHA (Gemma-7B) and a group of 8 (Gemma-2B's 8
    # query heads over 1 KV head), the warp-pair K6 on the card.
    (256, 1, 256), (256, 8, 256)])
def test_flash_backward_bf16_matches_jax_kernel(hd, group, seq):
    """bf16: p and ds rounded to bf16 before their products on both
    sides (the rounding points the card's K5/K6 reproduce); the JAX
    kernel rounds each query head's dk/dv partial to bf16 before the
    group sum, the port sums in f32 and rounds once, so the bound is a
    few bf16 ulps (2^-8 relative) at |dk| < 4."""
    (q_j, q), (k_j, k), (v_j, v), (g_j, g) = [
        _pair(_np(t), 'bfloat16') for _, t in _attn_inputs(
            9, 1, seq, 2 * group, 2, hd)]
    sw = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
    o_jt, lse_j = j_attention._flash_fwd(sw(q_j), sw(k_j), sw(v_j), True,
                                         128, interpret=True, need_lse=True)
    o = torch.from_numpy(np.array(_np(sw(o_jt)))).bfloat16()
    lse = torch.from_numpy(np.array(_np(lse_j[..., 0])))
    got = attention._flash_attention_bwd_plain(q, k, v, o, lse, g, True)
    kern = j_attention._flash_bwd(sw(q_j), sw(k_j), sw(v_j), o_jt, lse_j,
                                  sw(g_j), True, 128, interpret=True)
    for t, ref in zip(got, kern):
        assert t.dtype == torch.bfloat16
        _close(t, sw(ref), atol=4 * 2 ** -8, rtol=2 ** -7)


@pytest.mark.parametrize('group', [1, 2])
def test_flash_attention_autograd_on_cpu(group):
    """flash_attention with requires_grad is the autograd Function: its
    gradient is the plain backward's, its K5/K6 counters stay put, and
    without requires_grad it writes no lse."""
    (q_j, q), (k_j, k), (v_j, v), (g_j, g) = _attn_inputs(
        group, 2, 77, 4, 4 // group, 64)
    before = (attention.flash_attention_dq.launches,
              attention.flash_attention_dkv.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention.flash_attention(*leaves)
    assert out.grad_fn is not None
    # A non-contiguous incoming gradient (as after a reshape).
    out.backward(g.transpose(1, 2).contiguous().transpose(1, 2))
    _, vjp = jax.vjp(lambda a, b, c: j_attention.reference_attention(
        a, b, c, causal=True), q_j, k_j, v_j)
    for leaf, want in zip(leaves, vjp(g_j)):
        _close(leaf.grad, want)
    assert before == (attention.flash_attention_dq.launches,
                      attention.flash_attention_dkv.launches)
    assert attention.flash_attention(q, k, v).grad_fn is None


# ---- rms_norm and rope gradients --------------------------------------------

@pytest.mark.parametrize('dtype,atol', [
    ('float32', ATOL),
    # bf16 dx, dw: rounded once from f32 on both sides; one bf16 ulp at
    # |dx| < 8 where the f32 sums' last bits differ.
    ('bfloat16', 2 ** -4)])
def test_rms_norm_gradient_matches_jax(dtype, atol):
    rng = np.random.RandomState(3)
    x_j, x = _pair(rng.randn(2, 5, 256).astype(np.float32), dtype)
    w_j, w = _pair((1 + 0.1 * rng.randn(256)).astype(np.float32), dtype)
    g_j, g = _pair(rng.randn(2, 5, 256).astype(np.float32), dtype)
    x, w = x.requires_grad_(), w.requires_grad_()
    out = rmsnorm.rms_norm(x, w, eps=1e-5)
    out.backward(g)
    ref_bwd = j_rmsnorm._rms_norm_bwd(1e-5, (x_j, w_j), g_j)
    _, vjp = jax.vjp(lambda a, b: j_rmsnorm._rms_norm_xla(a, b, 1e-5),
                     x_j, w_j)
    assert x.grad.dtype == x.dtype and w.grad.dtype == w.dtype
    # dw sums 10 rows: scale its bound by its magnitude.
    for ref in (ref_bwd, vjp(g_j)):
        _close(x.grad, ref[0], atol=atol)
        _close(w.grad, ref[1], atol=atol, rtol=2 ** -7 if atol > ATOL
               else 0)


def test_rope_gradient_matches_jax():
    rng = np.random.RandomState(4)
    cos_j, sin_j = j_rope.rope_frequencies(32, 16, 500000.0)
    cos, sin = rope.rope_frequencies(32, 16, 500000.0)
    x_j, x = _pair(rng.randn(2, 16, 3, 32).astype(np.float32))
    g_j, g = _pair(rng.randn(2, 16, 3, 32).astype(np.float32))
    x.requires_grad_()
    rope.apply_rope(x, cos, sin).backward(g)
    _, vjp = jax.vjp(lambda a: j_rope.apply_rope(a, cos_j, sin_j), x_j)
    _close(x.grad, vjp(g_j)[0])


# ---- chunked cross entropy ----------------------------------------------------

@pytest.mark.parametrize('chunk', [16, 64])
def test_chunked_softmax_xent_matches_jax(chunk):
    """37 tokens: chunk 16 is two checkpointed chunks and a ragged tail
    of 5; chunk 64 is the direct block."""
    rng = np.random.RandomState(5)
    h_j, h = _pair(rng.randn(2, 37, 64).astype(np.float32))
    w_j, w = _pair((0.2 * rng.randn(64, 100)).astype(np.float32))
    t = rng.randint(0, 100, size=(2, 37)).astype(np.int32)
    h, w = h.requires_grad_(), w.requires_grad_()
    loss = losses.chunked_softmax_xent(h, w, torch.from_numpy(t),
                                       chunk_size=chunk)
    loss.backward()
    ref, (dh, dw) = jax.value_and_grad(
        lambda a, b: j_losses.chunked_softmax_xent(
            a, b, jnp.asarray(t), chunk_size=chunk), argnums=(0, 1))(h_j, w_j)
    _close(loss, ref)
    _close(h.grad, dh)
    _close(w.grad, dw)
    full = -losses.token_logprobs(h.detach() @ w.detach(),
                                  torch.from_numpy(t)).mean()
    _close(loss, full)
    with pytest.raises(ValueError, match='positive'):
        losses.chunked_softmax_xent(h, w, torch.from_numpy(t), chunk_size=0)


# ---- the Llama training forward and loss ------------------------------------

def _debug_models(**overrides):
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG, **overrides)
    tcfg = dataclasses.replace(llama.LLAMA_DEBUG, **overrides)
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jcfg, tcfg, jp, tree


def _tokens(batch, seq, vocab, seed=0):
    return next(trainer.synthetic_batches(batch, seq, vocab, seed))[
        'tokens']


@pytest.mark.parametrize('loss_chunk', [None, 16])
@pytest.mark.parametrize('remat,policy', [(False, None), (True, None),
                                          (True, 'dots')])
def test_llama_loss_and_gradients_match_jax(remat, policy, loss_chunk):
    """LLAMA_DEBUG f32, 2 x 40 input tokens (loss_chunk 16: two chunks
    and a ragged tail): the loss and every parameter's gradient equal
    jax.value_and_grad(llama.loss_fn), and every gradient is non-zero."""
    jcfg, tcfg, jp, tree = _debug_models(remat=remat, remat_policy=policy,
                                         loss_chunk=loss_chunk)
    tokens = _tokens(2, 40, jcfg.vocab_size)
    ref, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: j_llama.loss_fn(p, {'tokens': jnp.asarray(tokens)},
                                  jcfg)))(jp)
    params = trainer.tree_map(lambda t: t.requires_grad_(),
                              llama.params_from_numpy(tree, tcfg, 'cpu'))
    loss = llama.loss_fn(params, {'tokens': torch.from_numpy(tokens)}, tcfg)
    leaves = trainer.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-4)
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(ref_leaves) == len(grads) == 12
    for got, want in zip(grads, ref_leaves):
        want = _np(want)
        assert got.shape == want.shape
        assert float(got.abs().max()) > 0
        np.testing.assert_allclose(_np(got), want,
                                   atol=1e-4 * np.abs(want).max())


def test_remat_policy_rejects_unknown_like_jax():
    jcfg, tcfg, _, _ = _debug_models(remat_policy='bogus')
    with pytest.raises(ValueError) as j_err:
        j_llama._remat_policy(jcfg)
    with pytest.raises(ValueError) as t_err:
        llama._remat_policy(tcfg)
    assert str(t_err.value) == str(j_err.value)


# ---- optimizer -----------------------------------------------------------------

@pytest.mark.parametrize('warmup,total', [(2, 12), (1, 4), (0, 5), (3, 3)])
def test_schedule_matches_optax(warmup, total):
    cfg = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=warmup,
                              total_steps=total)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1),
        end_value=cfg.learning_rate * 0.1)
    sched = trainer.Optimizer(cfg).schedule
    got = [sched(i) for i in range(total + 3)]
    np.testing.assert_allclose(got, [float(ref(i)) for i in range(total + 3)],
                               rtol=1e-6, atol=1e-12)
    assert got[0] == (0.0 if warmup else cfg.learning_rate)


def _opt_trees(seed, scale, dtype='float32'):
    rng = np.random.RandomState(seed)
    shapes = {'a': (3, 5), 'b': {'c': (7,), 'd': (2, 2, 4)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.randn(*s).astype(np.float32)
    p, g = draw(shapes), draw(shapes)
    g = jax.tree.map(lambda x: x * scale / np.sqrt(
        sum(np.sum(y * y) for y in jax.tree.leaves(g))), g)
    dt = jnp.dtype(dtype)
    to_j = lambda t: jax.tree.map(lambda x: jnp.asarray(x, dt), t)  # noqa
    to_t = lambda t: trainer.tree_map(  # noqa: E731
        lambda x: torch.from_numpy(np.array(jnp.asarray(x, dt).astype(
            jnp.float32))).to(getattr(torch, dtype)), t)
    return to_j(p), to_j(g), to_t(p), to_t(g)


@pytest.mark.parametrize('norm', [0.5, 3.0])
def test_optimizer_steps_match_optax(norm):
    """Three updates of the clipped AdamW on f32 leaves, gradients below
    and above max_grad_norm 1.0: parameters and moments as optax's."""
    cfg = trainer.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                              total_steps=4)
    pj, gj, pt, gt = _opt_trees(int(norm), norm)
    tx_j = j_trainer.make_optimizer(cfg)
    state_j = tx_j.init(pj)
    tx = trainer.Optimizer(cfg)
    leaves, grads = trainer.tree_leaves(pt), trainer.tree_leaves(gt)
    state = tx.init(leaves)
    for _ in range(3):
        updates, state_j = tx_j.update(gj, state_j, pj)
        pj = optax.apply_updates(pj, updates)
        gnorm = tx.update(grads, state, leaves)
        np.testing.assert_allclose(float(gnorm), norm, rtol=1e-6)
    for got, want in zip(leaves, jax.tree.leaves(pj)):
        _close(got, want, atol=1e-7)
    mu_j = optax.tree_utils.tree_get(state_j, 'mu')
    for got, want in zip(state['mu'], jax.tree.leaves(mu_j)):
        _close(got, want, atol=1e-7)


@pytest.mark.parametrize('param_dtype,mu_dtype', [
    ('float32', None), ('float32', 'bfloat16'), ('bfloat16', None),
    ('bfloat16', 'bfloat16')])
def test_optimizer_state_dtypes_match_optax(param_dtype, mu_dtype):
    """mu takes mu_dtype (default the leaf's), nu the leaf's: bf16 params
    keep a bf16 nu under optax, whatever the JAX config comment says.
    One step on bf16 leaves lands within one bf16 ulp of optax's."""
    cfg = trainer.TrainConfig(learning_rate=1e-2, warmup_steps=0,
                              total_steps=4, mu_dtype=mu_dtype)
    pj, gj, pt, gt = _opt_trees(7, 3.0, param_dtype)
    state_j = j_trainer.make_optimizer(cfg).init(pj)
    tx = trainer.Optimizer(cfg)
    leaves = trainer.tree_leaves(pt)
    state = tx.init(leaves)
    for key, got in (('mu', state['mu']), ('nu', state['nu'])):
        want = jax.tree.leaves(optax.tree_utils.tree_get(state_j, key))
        assert [str(t.dtype).split('.')[1] for t in got] == \
            [str(x.dtype) for x in want]
    updates, state_j = j_trainer.make_optimizer(cfg).update(gj, state_j, pj)
    pj = optax.apply_updates(pj, updates)
    tx.update(trainer.tree_leaves(gt), state, leaves)
    for got, want in zip(leaves, jax.tree.leaves(pj)):
        assert got.dtype == getattr(torch, param_dtype)
        ulp = 2 ** -7 if param_dtype == 'bfloat16' else 1e-6
        _close(got, want, atol=1e-7, rtol=ulp)


# ---- the trainer -------------------------------------------------------------

def test_trainer_trajectory_matches_jax_trainer():
    """Three steps of the port's Trainer against the JAX Trainer on the
    8-device CPU mesh, LLAMA_DEBUG f32, the same params and batches."""
    jcfg, tcfg, jp, tree = _debug_models()
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=4)
    j_tc = j_trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                 total_steps=4)
    j_tr = j_trainer.Trainer(
        lambda p, b: j_llama.loss_fn(p, b, jcfg), jp,
        make_mesh(MeshConfig(dp=jax.device_count())),
        j_sharding.LLAMA_RULES, j_tc)
    tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, tcfg),
                         llama.params_from_numpy(tree, tcfg, 'cpu'), tc,
                         device='cpu')
    j_batches = j_trainer.synthetic_batches(8, 32, jcfg.vocab_size)
    batches = trainer.synthetic_batches(8, 32, tcfg.vocab_size)
    lrs = 0.0
    for step in range(3):
        want = j_tr.run_step(next(j_batches))
        got = tr.run_step(next(batches))
        lrs += tr.tx.schedule(step)
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5)
    assert tr.step == 3 and tr.opt_state['count'] == 3
    for got, want in zip(trainer.tree_leaves(tr.params),
                         jax.tree.leaves(j_tr.params)):
        _close(got, want, atol=2 * lrs)
        close = np.abs(_np(got) - _np(want)) <= 1e-6
        assert close.mean() > 0.99


# Gemma's attention at debug size: 2 heads of 256 (d_model 512, so
# head_dim = d_model / heads is Gemma-7B's 256), MHA as Gemma-7B, its
# gelu-tanh MLP and sqrt(d) embedding scale.
GEMMA_LIKE = dict(d_model=512, n_heads=2, n_kv_heads=2, d_ff=1024,
                  mlp_act='gelu_tanh', embed_scale=512 ** 0.5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gemma_like_trainer_matches_jax_trainer(dtype):
    """A Gemma-like head_dim-256 config: the first-step loss and every
    gradient against jax.value_and_grad, then 3 steps of the port's
    Trainer against the JAX Trainer on the 8-device CPU mesh (loss and
    grad_norm of each), from the same params and batches.  f32 at the
    LLAMA_DEBUG tolerances above (loss rtol 1e-4, gradients atol 1e-4 x
    the leaf's largest, steps rtol 1e-5).  bf16: the two sides round
    activations, probabilities and gradients to bf16 at other points
    through 2 layers, so the gradients are held to 2^-5 of the leaf's
    largest (8 bf16 ulps of it), the losses to rtol 1e-3 and the bf16
    grad norms to one ulp (rtol 2^-7)."""
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG,
                               dtype=getattr(jnp, dtype), **GEMMA_LIKE)
    tcfg = dataclasses.replace(llama.LLAMA_DEBUG,
                               dtype=getattr(torch, dtype), **GEMMA_LIKE)
    assert jcfg.head_dim == tcfg.head_dim == 256
    f32 = dtype == 'float32'
    loss_rtol, grad_atol, step_rtol, norm_rtol = (
        (1e-4, 1e-4, 1e-5, 1e-5) if f32 else (1e-3, 2 ** -5, 1e-3, 2 ** -7))
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    tokens = _tokens(8, 32, jcfg.vocab_size)
    ref, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: j_llama.loss_fn(p, {'tokens': jnp.asarray(tokens)},
                                  jcfg)))(jp)
    params = trainer.tree_map(lambda t: t.requires_grad_(),
                              llama.params_from_numpy(tree, tcfg, 'cpu'))
    loss = llama.loss_fn(params, {'tokens': torch.from_numpy(tokens)}, tcfg)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(ref),
                               rtol=loss_rtol)
    for got, want in zip(grads, jax.tree.leaves(ref_grads)):
        want = _np(want)
        assert got.shape == want.shape and got.dtype == tcfg.dtype
        assert float(got.abs().max()) > 0
        np.testing.assert_allclose(_np(got), want,
                                   atol=grad_atol * np.abs(want).max())
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=4)
    j_tc = j_trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                 total_steps=4)
    j_tr = j_trainer.Trainer(
        lambda p, b: j_llama.loss_fn(p, b, jcfg), jp,
        make_mesh(MeshConfig(dp=jax.device_count())),
        j_sharding.LLAMA_RULES, j_tc)
    tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, tcfg),
                         llama.params_from_numpy(tree, tcfg, 'cpu'), tc,
                         device='cpu')
    j_batches = j_trainer.synthetic_batches(8, 32, jcfg.vocab_size)
    batches = trainer.synthetic_batches(8, 32, tcfg.vocab_size)
    for _ in range(3):
        want = j_tr.run_step(next(j_batches))
        got = tr.run_step(next(batches))
        np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                                   rtol=step_rtol)
        np.testing.assert_allclose(float(got['grad_norm']),
                                   float(want['grad_norm']), rtol=norm_rtol)
    assert tr.step == 3


def test_trainer_fit_reports_throughput_on_cpu():
    _, tcfg, _, tree = _debug_models(loss_chunk=16)
    tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, tcfg),
                         llama.params_from_numpy(tree, tcfg, 'cpu'),
                         trainer.TrainConfig(warmup_steps=1, total_steps=4),
                         device='cpu')
    out = tr.fit(trainer.synthetic_batches(2, 24, tcfg.vocab_size), 4,
                 log_every=0, tokens_per_batch=48,
                 flops_per_token=6 * tcfg.num_params())
    assert tr.step == 4 and np.isfinite(out['loss'])
    assert out['tokens_per_sec'] == pytest.approx(48 / out['step_time_s'])
    assert out['mfu'] == pytest.approx(
        6 * tcfg.num_params() * out['tokens_per_sec'] / 1e12)


def test_trainer_entry_point_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        trainer.Trainer(lambda p, b: p['w'].sum(), {'w': torch.zeros(2)})
