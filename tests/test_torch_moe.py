"""The port's MoE expert bank (skypilot_tpu_torch/models/moe.py) and its
three call sites (infer/llama_infer._ffn under every serving plane,
train/sft.sft_loss_fn, train/train_moe.py) against the JAX package, on
the CPU.

Inputs are numpy draws from fixed seeds, at MOE_DEBUG widths (d 128, 2
layers, 4/2 heads of 32, ff 256, 4 experts, top 2), with the JAX
parameters carried over by ``llama.params_from_numpy``.  On CPU tensors
the kernel wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode or its plain references, as the JAX
package's own tests do.  Gates are random f32 draws whose top two
differ, so jax.lax.top_k / jnp.argmax and torch.topk / torch.argmax pick
the same experts.  Tolerances:
- gating: dispatch equal; combine and aux atol 1e-6 (softmax and a
  division in f32, summed in another order);
- the blocks, f32: atol 1e-5; bf16: atol BF16_ATOL = one bf16 ulp
  (2^-8) of the output's largest element (both sides take each product
  with f32 sums and round it to bf16 where the reference does; the
  largest difference seen is 0.49 of it, and skipping the reference's
  rounding of the router logits or of the combine weights to bf16
  exceeds it);
- loss and every gradient of hidden_states/forward/loss_fn and
  sft_loss_fn, f32: atol ATOL = 1e-5 (2 layers summed in other orders;
  the gradients are O(1e-2));
- 3 Trainer steps: loss and grad_norm at rtol 1e-5, as
  test_torch_train.py's trajectory test;
- the batchers: greedy tokens identical.
"""
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import quant as j_quant  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import moe as j_moe  # noqa: E402
from skypilot_tpu.parallel import MeshConfig, make_mesh  # noqa: E402
from skypilot_tpu.parallel import sharding as j_sharding  # noqa: E402
from skypilot_tpu.train import lora as j_lora  # noqa: E402
from skypilot_tpu.train import sft as j_sft  # noqa: E402
from skypilot_tpu.train import trainer as j_trainer  # noqa: E402
from skypilot_tpu_torch.infer import quant  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama, moe  # noqa: E402
from skypilot_tpu_torch.train import lora, sft, trainer  # noqa: E402

ATOL = 1e-5
GATE_ATOL = 1e-6
BF16_ATOL = 2.0 ** -8
ROOT = Path(__file__).resolve().parents[1]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _models(dtype='float32', **overrides):
    """(JAX config, port config, JAX params, the port's copy of them)."""
    jcfg = dataclasses.replace(j_moe.MOE_DEBUG, dtype=jnp.dtype(dtype),
                               **overrides)
    tcfg = dataclasses.replace(moe.MOE_DEBUG, dtype=getattr(torch, dtype),
                               **overrides)
    jp = j_moe.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jcfg, tcfg, jp, llama.params_from_numpy(tree, tcfg, 'cpu')


@pytest.fixture(scope='module')
def models():
    return _models()


def _tokens(batch, seq, seed=0):
    return np.random.RandomState(seed).randint(
        1, 512, size=(batch, seq)).astype(np.int32)


# ---- config and parameters --------------------------------------------------

def test_config_and_init_params_match_jax_layout():
    """Same fields and defaults, the same num_params, the JAX tree's
    paths, shapes and dtypes (no 'mlp' subtree), and the JAX scales."""
    j_fields = {f.name: f.default for f in dataclasses.fields(j_moe.MoeConfig)
                if f.name != 'dtype'}
    t_fields = {f.name: f.default for f in dataclasses.fields(moe.MoeConfig)
                if f.name != 'dtype'}
    assert t_fields == j_fields
    for name in ('n_experts', 'top_k', 'capacity_factor',
                 'router_aux_weight', 'router_impl', 'd_model', 'n_layers',
                 'd_ff', 'remat'):
        assert getattr(moe.MOE_DEBUG, name) == getattr(j_moe.MOE_DEBUG, name)
    assert moe.MOE_DEBUG.num_params() == j_moe.MOE_DEBUG.num_params()
    big = dataclasses.replace(moe.MOE_DEBUG, n_experts=8, d_ff=1024)
    assert big.num_params() == dataclasses.replace(
        j_moe.MOE_DEBUG, n_experts=8, d_ff=1024).num_params()

    jp = j_moe.init_params(j_moe.MOE_DEBUG, jax.random.PRNGKey(0))
    tp = moe.init_params(moe.MOE_DEBUG, torch.Generator().manual_seed(0),
                         'cpu')
    j_leaves = {j_lora._path_str(p): leaf for p, leaf in
                jax.tree_util.tree_flatten_with_path(jp)[0]}
    t_leaves = {'/'.join(p): leaf
                for p, leaf in lora._flatten_with_paths(tp)}
    assert sorted(t_leaves) == sorted(j_leaves)
    assert 'layers/mlp/w_up' not in t_leaves
    for path, leaf in t_leaves.items():
        assert tuple(leaf.shape) == j_leaves[path].shape, path
        assert leaf.dtype == torch.float32
    d, ff = moe.MOE_DEBUG.d_model, moe.MOE_DEBUG.d_ff
    for path, scale in (('layers/moe/router', d ** -0.5),
                        ('layers/moe/w_gate', d ** -0.5),
                        ('layers/moe/w_up', d ** -0.5),
                        ('layers/moe/w_down', ff ** -0.5)):
        std = float(t_leaves[path].std())
        assert abs(std / scale - 1) < 0.1, (path, std, scale)
        assert abs(float(np.std(j_leaves[path])) / scale - 1) < 0.1
    assert sum(t.numel() for t in t_leaves.values()) == \
        moe.MOE_DEBUG.num_params()


def test_init_params_stores_config_dtype_one_layer_at_a_time():
    cfg = dataclasses.replace(moe.MOE_DEBUG, dtype=torch.bfloat16)
    tp = moe.init_params(cfg, torch.Generator().manual_seed(3), 'cpu')
    assert all(t.dtype == torch.bfloat16 for t in trainer.tree_leaves(tp))
    bank = tp['layers']['moe']['w_up']
    assert not torch.equal(bank[0], bank[1])      # a draw per layer


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_params_from_numpy_carries_a_moe_tree(dtype):
    """Every leaf of the JAX MoE tree, 'moe' subtree included, arrives
    with its path, shape and values (bf16 -> f32 -> bf16 is lossless)."""
    jcfg, tcfg, jp, tp = _models(dtype)
    j_leaves = {j_lora._path_str(p): leaf for p, leaf in
                jax.tree_util.tree_flatten_with_path(jp)[0]}
    t_leaves = {'/'.join(p): leaf
                for p, leaf in lora._flatten_with_paths(tp)}
    assert sorted(t_leaves) == sorted(j_leaves)
    for path, leaf in t_leaves.items():
        assert leaf.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(leaf), _np(j_leaves[path]))


# ---- gating -----------------------------------------------------------------

def _logits(shape, seed):
    """Router logits whose gates have distinct top two per token."""
    logits = np.random.default_rng(seed).normal(size=shape).astype(
        np.float32)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (np.diff(top2, axis=-1) > 1e-4).all()
    return logits


def _one_hot_np(idx, n):
    return (idx[..., None] == np.arange(n)).astype(np.float32)


@pytest.mark.parametrize('top_k,capacity,drops', [
    (2, 16, False), (1, 16, False), (2, 3, True), (1, 2, True)],
    ids=['k2-ample', 'k1-ample', 'k2-tight', 'k1-tight'])
def test_top_k_gating_matches_jax(top_k, capacity, drops):
    """dispatch equal, combine and aux within GATE_ATOL, with capacity
    ample (every choice kept) and tight (tokens dropped: all-zero rows
    on both sides)."""
    logits = _logits((2, 16, 4), seed=top_k * 10 + capacity)
    jd, jc, ja = j_moe.top_k_gating(jnp.asarray(logits), top_k, capacity)
    td, tc, ta = moe.top_k_gating(torch.from_numpy(logits), top_k, capacity)
    assert td.shape == (2, 16, 4, capacity) and td.dtype == torch.float32
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_allclose(_np(tc), _np(jc), atol=GATE_ATOL, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=GATE_ATOL, rtol=0)
    kept = _np(td).sum(axis=(-2, -1))
    assert (kept < top_k).any() == drops
    assert ((kept == 0) == (_np(tc).sum(axis=(-2, -1)) == 0)).all()


def test_top_k_gating_capacity_and_weights():
    """The JAX package's own property (tests/test_pp_ep.py's gating
    test) on the port: at most top_k slots a token, combine weights
    summing to 1 over each kept token, a positive aux loss; and no
    expert slot holds two tokens."""
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 4)).astype(np.float32))
    dispatch, combine, aux = moe.top_k_gating(logits, top_k=2, capacity=8)
    assert dispatch.shape == (2, 16, 4, 8)
    per_token = dispatch.sum(dim=(-2, -1)).numpy()
    assert (per_token <= 2 + 1e-6).all()
    totals = combine.sum(dim=(-2, -1)).numpy()
    kept = per_token > 0
    np.testing.assert_allclose(totals[kept], 1.0, rtol=1e-5)
    assert float(aux) > 0
    assert float(dispatch.sum(dim=1).max()) <= 1.0


def test_one_hot_past_the_last_class_is_a_zero_row():
    idx = torch.tensor([[0, 3, 4, 7]])
    got = moe._one_hot(idx, 4)
    np.testing.assert_array_equal(got.numpy(), _one_hot_np(idx.numpy(), 4))
    assert got[0, 2:].sum() == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax.nn.one_hot(jnp.asarray(idx.numpy()), 4)))


# ---- the blocks -------------------------------------------------------------

def _block_inputs(dtype, seed=1, batch=2, seq=24):
    jcfg, tcfg, jp, tp = _models(dtype)
    x = np.random.RandomState(seed).randn(batch, seq, tcfg.d_model).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    layer = lambda tree: jax.tree.map(lambda a: a[0], tree)  # noqa: E731
    return (jcfg, tcfg, layer(jp['layers']['moe']),
            llama.layer_params(tp, 0)['moe'], jx, tx)


@pytest.mark.parametrize('dtype,atol', [('float32', ATOL),
                                        ('bfloat16', BF16_ATOL)])
@pytest.mark.parametrize('impl', ['dense', 'capacity'])
def test_moe_blocks_match_jax(impl, dtype, atol):
    """moe_block under each router_impl (moe_block_dense for 'dense'),
    y in x's dtype and aux in f32, against the JAX block; 24 tokens a
    row over capacity 15 a row, so the capacity path drops none of the
    4 experts' 48 choices only if balanced (checked on both sides)."""
    jcfg, tcfg, jm, tm, jx, tx = _block_inputs(dtype)
    jcfg = dataclasses.replace(jcfg, router_impl=impl)
    tcfg = dataclasses.replace(tcfg, router_impl=impl)
    jy, ja = j_moe.moe_block(jx, jm, jcfg)
    ty, ta = moe.moe_block(tx, tm, tcfg)
    assert ty.dtype == tx.dtype and ta.dtype == torch.float32
    scale = float(np.abs(_np(jy)).max())
    assert scale > 0.1
    np.testing.assert_allclose(_np(ty), _np(jy), atol=atol * scale, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=GATE_ATOL, rtol=0)
    if impl == 'dense':
        dy, da = moe.moe_block_dense(tx, tm, tcfg)
        assert torch.equal(dy, ty) and torch.equal(da, ta)


def test_moe_block_dense_is_the_per_token_top_k_mixture():
    """The dense block equals, token by token, the renormalized top-k
    mixture of the chosen experts' gated MLPs (HF Mixtral's routing),
    computed with plain loops; and an unknown router_impl raises as the
    JAX block does."""
    _, tcfg, _, tm, _, tx = _block_inputs('float32', batch=1, seq=5)
    y, _ = moe.moe_block_dense(tx, tm, tcfg)
    for s in range(5):
        xs = tx[0, s]
        gates = torch.softmax(xs @ tm['router'], -1)
        w, idx = torch.topk(gates, 2)
        w = w / w.sum()
        want = sum(wi * ((torch.nn.functional.silu(xs @ tm['w_gate'][e])
                          * (xs @ tm['w_up'][e])) @ tm['w_down'][e])
                   for wi, e in zip(w, idx.tolist()))
        np.testing.assert_allclose(_np(y[0, s]), _np(want), atol=ATOL)
    bad = dataclasses.replace(tcfg, router_impl='sparse')
    with pytest.raises(ValueError, match='router_impl'):
        moe.moe_block(tx, tm, bad)
    with pytest.raises(ValueError, match='router_impl'):
        j_moe.moe_block(jnp.zeros((1, 2, tcfg.d_model)), jax.tree.map(
            jnp.asarray, {k: _np(v) for k, v in tm.items()}),
            dataclasses.replace(j_moe.MOE_DEBUG, router_impl='sparse'))


class _OpRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (op, output tensors) of every aten call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = out if isinstance(out, (tuple, list)) else [out]
        self.calls.append((func, [t for t in flat
                                  if isinstance(t, torch.Tensor)]))
        return out


@pytest.mark.parametrize('impl', ['dense', 'capacity'])
def test_moe_block_copies_no_bank_and_reads_nothing_on_the_host(impl):
    """A decode-sized call (8 tokens): no aten op makes a tensor of a
    bank's size except as a view of the bank itself (the products run
    over the stored banks, no permuted copy), and no op reads a device
    value on the host (`.item()`, nonzero: the block is captured in the
    batcher's CUDA graph)."""
    _, tcfg, _, tm, _, tx = _block_inputs('float32', batch=8, seq=1)
    tcfg = dataclasses.replace(tcfg, router_impl=impl)
    bank = tm['w_up'].numel()
    banks = {t.untyped_storage().data_ptr() for t in tm.values()}
    with torch.no_grad(), _OpRecorder() as rec:
        moe.moe_block(tx, tm, tcfg)
    names = [str(func) for func, _ in rec.calls]
    assert any('bmm' in n for n in names)
    for func, outs in rec.calls:
        assert 'local_scalar_dense' not in str(func)
        assert 'nonzero' not in str(func)
        for t in outs:
            if t.numel() >= bank:
                assert t.untyped_storage().data_ptr() in banks, func


# ---- training: trunk, loss, gradients ---------------------------------------

@pytest.mark.parametrize('remat', [False, True])
@pytest.mark.parametrize('impl', ['capacity', 'dense'])
def test_loss_and_every_gradient_match_jax(impl, remat):
    """hidden_states (h, aux), forward's logits, loss_fn and every
    gradient against jax.value_and_grad, f32, 2 x 33 tokens."""
    jcfg, tcfg, jp, tp = _models(router_impl=impl, remat=remat)
    tokens = _tokens(2, 33)
    jt = jnp.asarray(tokens)
    tt = torch.from_numpy(tokens).long()
    jh, jaux = j_moe.hidden_states(jp, jt[:, :-1], jcfg)
    th, taux = moe.hidden_states(tp, tt[:, :-1], tcfg)
    np.testing.assert_allclose(_np(th), _np(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=GATE_ATOL)
    jl, _ = j_moe.forward(jp, jt[:, :-1], jcfg)
    tl, _ = moe.forward(tp, tt[:, :-1], tcfg)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)

    ref, ref_grads = jax.value_and_grad(
        lambda p: j_moe.loss_fn(p, {'tokens': jt}, jcfg))(jp)
    p = trainer.tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss = moe.loss_fn(p, {'tokens': tt}, tcfg)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(p))
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=ATOL,
                               rtol=0)
    want = jax.tree.leaves(ref_grads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert float(g.abs().max()) > 0
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=0)


def test_remat_changes_no_gradient():
    _, tcfg, _, tp = _models()
    tt = torch.from_numpy(_tokens(2, 17, seed=4)).long()
    grads = {}
    for remat in (False, True):
        p = trainer.tree_map(lambda t: t.clone().requires_grad_(), tp)
        loss = moe.loss_fn(p, {'tokens': tt},
                           dataclasses.replace(tcfg, remat=remat))
        grads[remat] = torch.autograd.grad(loss, trainer.tree_leaves(p))
    for a, b in zip(grads[False], grads[True]):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=0)


def test_trainer_steps_match_jax_trainer():
    """Three steps of the port's Trainer on moe.loss_fn against the JAX
    Trainer under MOE_RULES on the 8-device CPU mesh at ep 1, the same
    params and batches: loss and grad_norm of each step."""
    jcfg, tcfg, jp, tp = _models()
    tc = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    j_tr = j_trainer.Trainer(
        lambda p, b: j_moe.loss_fn(p, b, jcfg), jp,
        make_mesh(MeshConfig(dp=jax.device_count(), ep=1)),
        j_sharding.MOE_RULES, j_trainer.TrainConfig(**tc))
    tr = trainer.Trainer(lambda p, b: moe.loss_fn(p, b, tcfg), tp,
                         trainer.TrainConfig(**tc), device='cpu')
    j_batches = j_trainer.synthetic_batches(8, 32, jcfg.vocab_size)
    batches = trainer.synthetic_batches(8, 32, tcfg.vocab_size)
    for _ in range(3):
        want = j_tr.run_step(next(j_batches))
        got = tr.run_step(next(batches))
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5)
    assert tr.step == 3


def _sft_batch(batch, seq, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 512, size=(batch, seq + 1)).astype(np.int32)
    mask = (rng.rand(batch, seq) > 0.3).astype(np.float32)
    return {'tokens': tokens, 'loss_mask': mask}


@pytest.mark.parametrize('loss_chunk', [None, 8])
@pytest.mark.parametrize('impl', ['capacity', 'dense'])
def test_sft_loss_on_a_moe_config_matches_jax(impl, loss_chunk):
    """sft_loss_fn's MoE branch (blockwise CE over moe.hidden_states plus
    router_aux_weight x aux): value and every gradient."""
    jcfg, tcfg, jp, tp = _models(router_impl=impl, loss_chunk=loss_chunk)
    batch = _sft_batch(2, 24)
    ref, ref_grads = jax.value_and_grad(lambda p: j_sft.sft_loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))(jp)
    p = trainer.tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss = sft.sft_loss_fn(p, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(p))
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=ATOL,
                               rtol=0)
    for g, w in zip(grads, jax.tree.leaves(ref_grads)):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=0)
    # The aux term is in: without it the loss moves by weight x aux.
    no_aux = dataclasses.replace(tcfg, router_aux_weight=0.0)
    _, aux = moe.hidden_states(tp, torch.from_numpy(
        batch['tokens'][:, :-1]).long(), tcfg)
    plain = sft.sft_loss_fn(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, no_aux)
    np.testing.assert_allclose(float(loss.detach()) - float(plain),
                               tcfg.router_aux_weight * float(aux),
                               atol=1e-6)


def test_lora_sft_gradient_on_a_moe_base_matches_jax():
    """LoRA (attn target, rank 4) over a frozen MoE base through
    lora.wrap_loss: the adapters' gradients against the JAX package's."""
    jcfg, tcfg, jp, tp = _models(router_impl='dense')
    j_cfg = j_lora.LoraConfig(rank=4, alpha=8.0, targets='attn')
    t_cfg = lora.LoraConfig(rank=4, alpha=8.0, targets='attn')
    rng = np.random.RandomState(0)
    host = jax.tree.map(np.asarray,
                        j_lora.init_lora(jp, j_cfg, jax.random.PRNGKey(1)))

    def fill(node):
        if 'a' in node:
            return {'a': node['a'], 'b': 0.02 * rng.randn(
                *node['b'].shape).astype(np.float32)}
        return {k: fill(v) for k, v in node.items()}
    host = fill(host)
    batch = _sft_batch(2, 24, seed=1)
    ref, ref_grads = jax.value_and_grad(j_lora.wrap_loss(
        lambda p, b: j_sft.sft_loss_fn(p, b, jcfg), jp, j_cfg))(
        jax.tree.map(jnp.asarray, host),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ad = trainer.tree_map(lambda t: t.requires_grad_(),
                          lora.adapters_from_numpy(host, 'cpu'))
    loss = lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, tcfg), tp,
                          t_cfg)(ad, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, trainer.tree_leaves(ad))
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=ATOL,
                               rtol=0)
    want = jax.tree.leaves(ref_grads)
    assert len(grads) == len(want) == 8      # a and b of 4 stacks
    for g, w in zip(grads, want):
        assert float(g.abs().max()) > 0
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=0)


# ---- serving: every plane reaches _ffn --------------------------------------

# MOE_DEBUG with LLAMA_DEBUG's attention widths (2 heads of 128 over one
# KV head), for the JAX 'paged' plane's kernel.
HD128 = dict(d_model=256, n_heads=2, n_kv_heads=1)
KW = dict(max_seq_len=128, batch_size=4, prompt_buckets=[16, 32, 64],
          prefill_chunk=24, kv_block_size=16)
BUDGETS = [10, 6, 8, 12, 5, 9]


def _prompts():
    """Four short prompts and two chunked ones (30 and 40 tokens over a
    24-token prefill window), more requests than slots."""
    rng = np.random.RandomState(0)
    return [[int(t) for t in rng.randint(1, 512, size=n)]
            for n in (5, 12, 30, 3, 9, 40)]


@pytest.mark.parametrize('extra', [
    {}, dict(spec_k=3), dict(fuse_budget=8), dict(weights_dtype='int8'),
    dict(decode_impl='paged')],
    ids=['pooled', 'spec', 'fused', 'int8-weights', 'paged'])
def test_batcher_tokens_match_jax(models, extra):
    """Greedy tokens identical to the JAX ContinuousBatcher's at
    MOE_DEBUG f32: the pooled plane plain, with spec_k=3 (verify: K4's
    plain version), with fuse_budget (the fused step), with int8 weights
    (the expert banks stay f32) and on the legacy 'paged' plane (K7's
    plain version, at head_dim 128: the JAX K7 takes no other)."""
    jcfg, tcfg, jp, tp = (_models(**HD128) if 'decode_impl' in extra
                          else models)
    kw = dict(KW, **extra)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jb = j_serving.ContinuousBatcher(jp, jcfg,
                                         j_engine.GeneratorConfig(**kw),
                                         decode_chunk=4)
        j_rids = [jb.submit(p, max_new_tokens=n)
                  for p, n in zip(_prompts(), BUDGETS)]
        jb.run_until_idle()
        want = [jb.result(r) for r in j_rids]
        b = ContinuousBatcher(tp, tcfg, GeneratorConfig(**kw),
                              decode_chunk=4, device='cpu')
        rids = [b.submit(p, max_new_tokens=n)
                for p, n in zip(_prompts(), BUDGETS)]
        b.run_until_idle()
    assert [b.result(r) for r in rids] == want
    assert [len(o) for o in want] == BUDGETS
    if 'spec_k' in extra:
        assert b.spec_proposed > 0
    if 'fuse_budget' in extra:
        assert b._fuse_policy.stats.steps > 0
    if 'weights_dtype' in extra:
        assert quant.is_quantized(b.params['layers']['attn']['wq'])
        assert not quant.is_quantized(b.params['layers']['moe']['w_up'])


def test_int8_weights_leave_the_expert_banks_as_jax_does(models):
    """quantize_weights quantizes the attention and the head, and leaves
    the router and the expert banks in the model dtype, on the same
    paths as the JAX package."""
    _, _, jp, tp = models
    jq = j_quant.quantize_weights(jp)
    tq = quant.quantize_weights(tp)
    for key in ('router', 'w_gate', 'w_up', 'w_down'):
        assert not quant.is_quantized(tq['layers']['moe'][key])
        assert not j_quant.is_quantized(jq['layers']['moe'][key])
        assert tq['layers']['moe'][key] is tp['layers']['moe'][key]
    for key in ('wq', 'wk', 'wv', 'wo'):
        assert quant.is_quantized(tq['layers']['attn'][key])
        assert j_quant.is_quantized(jq['layers']['attn'][key])
    assert quant.is_quantized(tq['lm_head'])


# ---- the entry points -------------------------------------------------------

def _run_entry(module, *args, timeout=60):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_train_moe_runs_on_the_cpu():
    proc = _run_entry('skypilot_tpu_torch.train.train_moe', '--model-size',
                      'debug', '--device', 'cpu', '--steps', '3',
                      '--seq-len', '32', '--batch-size', '2', timeout=30)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.rstrip().splitlines()[-1]
    assert last.startswith('moe OK: ep=1 dp=1 experts=4 loss='), last
    assert np.isfinite(float(last.split('loss=')[1].split()[0]))


@pytest.mark.parametrize('flag', [('--ep', '2'), ('--dp', '2')])
def test_train_moe_refuses_a_mesh_naming_its_roadmap_item(flag):
    """--ep and --dp above 1 train on a mesh of rank processes (the
    experts over ep, the batch over dp) and print the reference's line."""
    proc = _run_entry('skypilot_tpu_torch.train.train_moe', *flag,
                      '--model-size', 'debug', '--device', 'cpu', '--steps',
                      '3', '--seq-len', '32', '--batch-size', '2',
                      timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    last = proc.stdout.rstrip().splitlines()[-1]
    ep, dp = (2, 1) if flag[0] == '--ep' else (1, 2)
    assert last.startswith(f'moe OK: ep={ep} dp={dp} experts=4 loss='), last
    assert np.isfinite(float(last.split('loss=')[1].split()[0]))


def test_train_moe_small_is_the_reference_model():
    from skypilot_tpu_torch.train import train_moe
    small = train_moe.PRESETS['small']
    assert (small.vocab_size, small.d_model, small.n_layers, small.n_heads,
            small.n_kv_heads, small.d_ff, small.n_experts, small.dtype,
            small.remat) == (32768, 1024, 8, 8, 4, 2816, 8, torch.bfloat16,
                             True)
    assert train_moe.PRESETS['debug'] is moe.MOE_DEBUG
