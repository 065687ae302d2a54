"""The port's LoRA (skypilot_tpu_torch/train/lora.py, its Trainer over
the adapter tree, and train_sft --lora-rank) against the JAX package's
train/lora.py, on the CPU.

Parameters come from one JAX draw (LLAMA_DEBUG) and cross with
``llama.params_from_numpy``; adapters cross in f32 with
``lora.adapters_from_numpy``, B drawn non-zero from a numpy seed so that
every product is exercised.  Tolerances:
- apply_lora / merge_lora: bitwise, with an f32 and with a bf16 base
  (both packages take the same rank-4 f32 product, scale it in f32,
  round it to the base dtype and add there; measured: no element of any
  target preset differs);
- adapter gradients: atol ATOL = 1e-5 (test_torch_train.py's);
- three LoRA-SFT Trainer steps against the JAX Trainer on the 8-device
  CPU mesh: loss and grad_norm rtol 1e-5, adapters within 2 x the summed
  learning rates (test_torch_train.py's bound), the base bitwise
  untouched;
- checkpoints: bitwise, in both directions, holding only the adapters.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.ckpt import format as j_format  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.parallel import MeshConfig, make_mesh  # noqa: E402
from skypilot_tpu.train import lora as j_lora  # noqa: E402
from skypilot_tpu.train import sft as j_sft  # noqa: E402
from skypilot_tpu.train import trainer as j_trainer  # noqa: E402
from skypilot_tpu_torch.ckpt import format as t_format  # noqa: E402
from skypilot_tpu_torch.infer.engine import (Generator,  # noqa: E402
                                             GeneratorConfig)
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.train import lora, sft, trainer  # noqa: E402

ATOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
TARGETS = ['attn', 'attn-qv', 'all-linear', r'mlp/w_(up|down)$']


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _models(dtype='float32'):
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG, dtype=jnp.dtype(dtype))
    tcfg = dataclasses.replace(llama.LLAMA_DEBUG,
                               dtype=getattr(torch, dtype))
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jcfg, tcfg, jp, llama.params_from_numpy(tree, tcfg, 'cpu')


def _adapters(jp, lcfg, seed=0, b_scale=0.02):
    """JAX init_lora's A, and B drawn from numpy (non-zero), as a host
    tree of f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray,
                        j_lora.init_lora(jp, lcfg, jax.random.PRNGKey(1)))

    def fill(node):
        if 'a' in node:
            b = rng.randn(*node['b'].shape).astype(np.float32) * b_scale
            return {'a': node['a'], 'b': b}
        return {k: fill(v) for k, v in node.items()}
    return fill(tree)


def _paths(tree):
    return [(p, tuple(leaf.shape)) for p, leaf in
            ((j_lora._path_str(path), leaf) for path, leaf in
             jax.tree_util.tree_flatten_with_path(tree)[0])]


def _t_paths(tree):
    return [('/'.join(path), tuple(leaf.shape))
            for path, leaf in lora._flatten_with_paths(tree)]


# ---- targets, init, apply and merge ---------------------------------------------

@pytest.mark.parametrize('targets', TARGETS)
def test_init_picks_the_same_leaves_as_jax(targets):
    _, _, jp, tp = _models()
    lcfg = lora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    j_tree = j_lora.init_lora(jp, j_lora.LoraConfig(4, 8.0, targets),
                              jax.random.PRNGKey(1))
    t_tree = lora.init_lora(tp, lcfg, torch.Generator().manual_seed(1))
    assert _t_paths(t_tree) == _paths(j_tree)
    assert lora.split_shapes(t_tree) == j_lora.split_shapes(j_tree)
    assert lora.num_params(t_tree) == j_lora.num_params(j_tree)
    for path, leaf in lora._flatten_with_paths(t_tree):
        assert leaf.dtype == torch.float32
        if path[-1] == 'b':
            assert not leaf.any()
        else:
            # A ~ N(0, 1/in): the same distribution as JAX's draw.
            std = float(leaf.std()) * leaf.shape[-2] ** 0.5
            assert 0.9 < std < 1.1, (path, std)


@pytest.mark.parametrize('targets', ['final_norm', r'(final_norm|attn/wq)$',
                                     'nothing$'])
def test_bad_targets_raise_like_jax(targets):
    _, _, jp, tp = _models()
    with pytest.raises(ValueError) as want:
        j_lora.init_lora(jp, j_lora.LoraConfig(targets=targets),
                         jax.random.PRNGKey(1))
    with pytest.raises(ValueError) as got:
        lora.init_lora(tp, lora.LoraConfig(targets=targets),
                       torch.Generator().manual_seed(1))
    assert str(got.value) == str(want.value)


def _assert_leaves_match(got_tree, want_tree, dtype):
    got = trainer.tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('targets', TARGETS)
def test_apply_and_merge_match_jax(targets, dtype):
    _, _, jp, tp = _models(dtype)
    j_cfg = j_lora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    t_cfg = lora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    host = _adapters(jp, j_cfg)
    j_ad = jax.tree.map(jnp.asarray, host)
    t_ad = lora.adapters_from_numpy(host, 'cpu')
    applied = lora.apply_lora(tp, t_ad, t_cfg)
    _assert_leaves_match(applied, j_lora.apply_lora(jp, j_ad, j_cfg), dtype)
    merged = lora.merge_lora(tp, t_ad, t_cfg)
    _assert_leaves_match(merged, j_lora.merge_lora(jp, j_ad, j_cfg), dtype)
    for path, leaf in lora._flatten_with_paths(merged):
        assert not leaf.requires_grad
        if lora._get_nested(t_ad, path) is None:
            # Unadapted leaves are the base's own tensors (no copy).
            assert leaf.data_ptr() == lora._get_nested(tp, path).data_ptr()


def test_adapters_from_numpy_keeps_f32_under_a_bf16_model():
    _, tcfg, jp, tp = _models('bfloat16')
    host = _adapters(jp, j_lora.LoraConfig(rank=2))
    ad = lora.adapters_from_numpy(host, 'cpu')
    for path, leaf in lora._flatten_with_paths(ad):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(),
                                      lora._get_nested(host, path))
    assert trainer.tree_leaves(tp)[0].dtype == torch.bfloat16


# ---- gradients and the Trainer ---------------------------------------------------

def _sft_batch(batch, seq, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 512, size=(batch, seq + 1)).astype(np.int32)
    mask = (rng.rand(batch, seq) > 0.3).astype(np.float32)
    return {'tokens': tokens, 'loss_mask': mask}


@pytest.mark.parametrize('targets', ['attn', 'all-linear'])
def test_wrap_loss_adapter_gradients_match_jax(targets):
    jcfg, tcfg, jp, tp = _models()
    j_cfg = j_lora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    t_cfg = lora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    host = _adapters(jp, j_cfg)
    batch = _sft_batch(2, 24)
    j_loss = j_lora.wrap_loss(
        lambda p, b: j_sft.sft_loss_fn(p, b, jcfg), jp, j_cfg)
    ref, ref_grads = jax.value_and_grad(j_loss)(
        jax.tree.map(jnp.asarray, host),
        {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss = lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, tcfg), tp,
                            t_cfg)
    ad = trainer.tree_map(lambda t: t.requires_grad_(),
                          lora.adapters_from_numpy(host, 'cpu'))
    loss = t_loss(ad, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, trainer.tree_leaves(ad))
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=ATOL,
                               rtol=0)
    want = jax.tree.leaves(ref_grads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert float(g.abs().max()) > 0
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=0)
    assert all(not t.requires_grad for t in trainer.tree_leaves(tp))


def _lora_trainers(jcfg, tcfg, jp, tp, host, lr=1e-3):
    j_cfg = j_lora.LoraConfig(rank=4, alpha=8.0)
    t_cfg = lora.LoraConfig(rank=4, alpha=8.0)
    tc = dict(learning_rate=lr, warmup_steps=1, total_steps=4)
    j_tr = j_trainer.Trainer(
        j_lora.wrap_loss(lambda p, b: j_sft.sft_loss_fn(p, b, jcfg), jp,
                         j_cfg),
        jax.tree.map(np.copy, host),
        make_mesh(MeshConfig(dp=jax.device_count())), j_lora.LORA_RULES,
        j_trainer.TrainConfig(**tc))
    t_tr = trainer.Trainer(
        lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, tcfg), tp, t_cfg),
        lora.adapters_from_numpy(host, 'cpu'), trainer.TrainConfig(**tc),
        device='cpu')
    return j_tr, t_tr


def test_lora_sft_trainer_steps_match_jax_trainer():
    """Three LoRA-SFT steps (B starting at zero, as init_lora gives it):
    loss, grad norm and adapters equal the JAX Trainer's; the base never
    moves."""
    jcfg, tcfg, jp, tp = _models()
    host = jax.tree.map(np.asarray,
                        j_lora.init_lora(jp, j_lora.LoraConfig(rank=4),
                                         jax.random.PRNGKey(1)))
    base_before = [t.clone() for t in trainer.tree_leaves(tp)]
    j_tr, t_tr = _lora_trainers(jcfg, tcfg, jp, tp, host)
    lrs = 0.0
    for step in range(3):
        batch = _sft_batch(8, 32, seed=step)
        want = j_tr.run_step(batch)
        got = t_tr.run_step(batch)
        lrs += t_tr.tx.schedule(step)
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5)
    for got, want in zip(trainer.tree_leaves(t_tr.params),
                         jax.tree.leaves(j_tr.params)):
        np.testing.assert_allclose(_np(got), _np(want), atol=2 * lrs,
                                   rtol=0)
    # Every B has moved from zero; the base is bitwise untouched.
    for path, leaf in lora._flatten_with_paths(t_tr.params):
        if path[-1] == 'b':
            assert leaf.detach().abs().max() > 0
    for before, after in zip(base_before, trainer.tree_leaves(tp)):
        assert torch.equal(before, after) and not after.requires_grad


def _named_bits(tree, fmt):
    named, _ = fmt.flatten_with_keys(tree)
    return [(k, _np(v).tobytes()) for k, v in named]


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_lora_checkpoint_restores_bitwise_across_packages(tmp_path, writer):
    """One step in the writing package, a checkpoint, a restore into the
    other package's LoRA trainer: the state is bitwise equal, and the
    checkpoint holds the adapters (and their AdamW moments) only."""
    jcfg, tcfg, jp, tp = _models()
    host = _adapters(jp, j_lora.LoraConfig(rank=4), b_scale=0.0)
    j_tr, t_tr = _lora_trainers(jcfg, tcfg, jp, tp, host)
    batch = _sft_batch(8, 32)
    root = str(tmp_path / 'ckpt')
    if writer == 'jax':
        j_tr.run_step(batch)
        j_tr.save_checkpoint(root)
        assert t_tr.restore_latest(root) == 1
    else:
        t_tr.run_step(batch)
        t_tr.save_checkpoint(root)
        assert j_tr.restore_latest(root) == 1
    assert t_tr.step == j_tr.step == 1
    assert _named_bits(t_tr._state_dict(), t_format) == \
        _named_bits(j_tr._state_dict(), j_format)
    with open(os.path.join(root, 'step_1', 'manifest.json')) as f:
        keys = [e['key'] for e in json.load(f)['entries']]
    assert keys and all(k.endswith(('/a', '/b', "['a']", "['b']"))
                        or 'count' in k for k in keys), keys
    assert not any('embed' in k or 'lm_head' in k for k in keys)
    # Both continue from the restored state to the same next step.
    batch = _sft_batch(8, 32, seed=1)
    want, got = j_tr.run_step(batch), t_tr.run_step(batch)
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-5)


# ---- the entry point ---------------------------------------------------------------

def _run_sft(*args, timeout=60):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    return subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.train_sft', *args,
         '--device', 'cpu'], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=timeout)


def test_train_sft_lora_merge_save_equals_the_restored_merge(tmp_path):
    """train_sft --lora-rank 8 with a checkpoint dir and --merge-save: the
    merged file equals, bitwise, merge_lora of the adapters restored
    from its checkpoint over the seed-0 base; greedy tokens from both
    trees agree; a relaunch with --resume auto resumes."""
    data = tmp_path / 'sft.jsonl'
    data.write_text(''.join(
        json.dumps({'prompt': f'q{i}?', 'completion': f' a{i * 7}.'}) + '\n'
        for i in range(5)))
    ckpt, out = str(tmp_path / 'ckpt'), str(tmp_path / 'out')
    common = ['--data-file', str(data), '--seq-len', '32', '--lora-rank',
              '8', '--checkpoint-dir', ckpt, '--log-every', '1']
    proc = _run_sft(*common, '--steps', '3', '--merge-save', out,
                    timeout=30)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LoRA: 4 adapted weights' in proc.stdout
    assert f'merged model saved to {out}/merged' in proc.stdout

    cfg = llama.LLAMA_DEBUG
    base = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    lcfg = lora.LoraConfig(rank=8)
    tr = trainer.Trainer(
        lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, cfg), base, lcfg),
        lora.init_lora(base, lcfg, torch.Generator().manual_seed(1)),
        device='cpu')
    assert tr.restore_latest(ckpt) == 3
    want = lora.merge_lora(base, tr.params, lcfg)
    got = t_format.restore_pytree(os.path.join(out, 'merged'), 0,
                                  {'params': want})['params']
    for (_, g), (_, w) in zip(lora._flatten_with_paths(got),
                              lora._flatten_with_paths(want)):
        assert torch.equal(g, w)
    gen_cfg = GeneratorConfig(max_seq_len=64, batch_size=2)
    prompts = [[5, 9, 11], [7, 3]]
    assert Generator(got, cfg, gen_cfg, device='cpu').generate(
        prompts, max_new_tokens=6) == Generator(
            want, cfg, gen_cfg, device='cpu').generate(prompts,
                                                       max_new_tokens=6)

    proc = _run_sft(*common, '--steps', '4', '--resume', 'auto', timeout=30)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'resumed from step 3' in proc.stdout
    assert 'step 4: loss=' in proc.stdout
