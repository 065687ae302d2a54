"""The port's DPO (skypilot_tpu_torch/train/dpo.py and
train/train_dpo.py) against the JAX package's train/dpo.py, on the CPU.

LLAMA_DEBUG in f32, parameters from one JAX draw crossed with
``llama.params_from_numpy``, adapters with ``lora.adapters_from_numpy``,
tokens and masks from numpy seeds.  Tolerances:
- the data path (dpo_batches): arrays equal; the same ValueError
  messages for bad JSONL;
- loss and metrics: atol ATOL = 1e-5 (test_torch_train.py's; both
  sides sum in f32 in other orders through 2 layers); gradients: atol
  ATOL x max(1, max|grad|) per leaf, since DPO differentiates summed
  (not mean) logprobs and the embedding's gradient reaches ~3 here, where
  f32 summation order alone moves it by ~2e-5;
- the loss with the policy equal to the reference: log 2 to f32
  rounding (rtol 1e-6), in both packages.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.train import dpo as j_dpo  # noqa: E402
from skypilot_tpu.train import lora as j_lora  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.ops import attention  # noqa: E402
from skypilot_tpu_torch.train import dpo, lora, trainer  # noqa: E402

ATOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _models(seed=0, **overrides):
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG, **overrides)
    tcfg = dataclasses.replace(llama.LLAMA_DEBUG, **overrides)
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jcfg, tcfg, jp, tree


def _pair_batch(batch=2, seq=24, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for side in ('chosen', 'rejected'):
        out[f'tokens_{side}'] = rng.randint(
            1, 512, size=(batch, seq + 1)).astype(np.int32)
        mask = np.zeros((batch, seq), np.float32)
        for b in range(batch):
            start = int(rng.randint(1, seq // 2))
            mask[b, start:start + int(rng.randint(2, seq // 2))] = 1.0
        out[f'mask_{side}'] = mask
    return out


def _assert_grads_close(grads, want_leaves):
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        w = _np(w)
        assert float(g.abs().max()) > 0
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(w).max()))


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _write_jsonl(path, rows):
    with open(path, 'w', encoding='utf-8') as f:
        for row in rows:
            f.write((row if isinstance(row, str) else json.dumps(row))
                    + '\n')
    return str(path)


def _encode(text):
    return [b % 512 for b in text.encode('utf-8')]


# ---- the data path -----------------------------------------------------------

@pytest.mark.parametrize('eos_id', [None, 2])
def test_dpo_batches_match_jax(tmp_path, eos_id):
    rng = np.random.RandomState(1)
    rows = [{'prompt': 'p' * int(rng.randint(1, 9)) + f'{i}',
             'chosen': ' yes' * int(rng.randint(1, 6)),
             'rejected': ' no' * int(rng.randint(1, 6))} for i in range(7)]
    path = _write_jsonl(tmp_path / 'pairs.jsonl', rows)
    got = dpo.dpo_batches(path, _encode, 3, 20, eos_id=eos_id, seed=4)
    want = j_dpo.dpo_batches(path, _encode, 3, 20, eos_id=eos_id, seed=4)
    for _ in range(5):   # across an epoch boundary (7 // 3 = 2 a epoch)
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for key in g:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize('rows', [
    [{'prompt': 'a', 'chosen': 'b'}],
    [{'prompt': 'a', 'chosen': 'b', 'rejected': 'c'}, {'chosen': 'd'}],
    [''],
])
def test_dpo_jsonl_errors_match_jax(tmp_path, rows):
    path = _write_jsonl(tmp_path / 'bad.jsonl', rows)
    with pytest.raises(ValueError) as want:
        j_dpo.load_jsonl(path)
    with pytest.raises(ValueError) as got:
        dpo.load_jsonl(path)
    assert str(got.value) == str(want.value)


# ---- loss, metrics, gradients -------------------------------------------------

@pytest.mark.parametrize('loss_chunk', [None, 16])
def test_dpo_loss_metrics_and_gradients_match_jax(loss_chunk):
    """Full-parameter DPO against a reference from another seed: loss,
    both metrics and every policy gradient; the reference gets none."""
    jcfg, tcfg, jp, tree = _models(loss_chunk=loss_chunk)
    _, _, jref, ref_tree = _models(seed=1, loss_chunk=loss_chunk)
    j_batch, t_batch = _both(_pair_batch())
    ref, ref_grads = jax.value_and_grad(
        lambda p: j_dpo.dpo_loss_fn(p, jref, j_batch, jcfg, beta=0.5))(jp)
    params = trainer.tree_map(lambda t: t.requires_grad_(),
                              llama.params_from_numpy(tree, tcfg, 'cpu'))
    ref_params = trainer.tree_map(
        lambda t: t.requires_grad_(),
        llama.params_from_numpy(ref_tree, tcfg, 'cpu'))
    loss = dpo.dpo_loss_fn(params, ref_params, t_batch, tcfg, beta=0.5)
    leaves = trainer.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=ATOL,
                               rtol=0)
    _assert_grads_close(grads, jax.tree.leaves(ref_grads))
    # The reference pass kept no graph: no gradient can reach it.
    assert loss.grad_fn is not None
    with pytest.raises(RuntimeError):
        torch.autograd.grad(
            dpo.dpo_loss_fn(params, ref_params, t_batch, tcfg),
            trainer.tree_leaves(ref_params))
    got = dpo.dpo_metrics(params, ref_params, t_batch, tcfg, beta=0.5)
    want = j_dpo.dpo_metrics(jp, jref, j_batch, jcfg, beta=0.5)
    assert sorted(got) == sorted(want)
    for key in want:
        assert not got[key].requires_grad
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=ATOL, rtol=0)


def test_lora_dpo_starts_at_log2_and_its_gradients_match_jax():
    """LoRA-DPO as train_dpo builds it: the reference is the frozen base.
    With B = 0 the policy is the reference, so the loss is log 2 in both
    packages; with B drawn non-zero the adapter gradients agree."""
    jcfg, tcfg, jp, tree = _models()
    tp = llama.params_from_numpy(tree, tcfg, 'cpu')
    j_cfg, t_cfg = j_lora.LoraConfig(rank=4), lora.LoraConfig(rank=4)
    host = jax.tree.map(np.asarray, j_lora.init_lora(
        jp, j_cfg, jax.random.PRNGKey(1)))
    j_batch, t_batch = _both(_pair_batch(seed=3))

    def j_loss(ad):
        return j_dpo.dpo_loss_fn(j_lora.apply_lora(jp, ad, j_cfg), jp,
                                 j_batch, jcfg)

    def t_loss(ad):
        return dpo.dpo_loss_fn(lora.apply_lora(tp, ad, t_cfg), tp, t_batch,
                               tcfg)

    ad = lora.adapters_from_numpy(host, 'cpu')
    np.testing.assert_allclose(float(t_loss(ad)), math.log(2), rtol=1e-6)
    np.testing.assert_allclose(float(j_loss(jax.tree.map(jnp.asarray,
                                                         host))),
                               math.log(2), rtol=1e-6)

    rng = np.random.RandomState(0)
    host = jax.tree.map(
        lambda x: (rng.randn(*x.shape).astype(np.float32) * 0.05
                   if not x.any() else x), host)
    ref, ref_grads = jax.value_and_grad(j_loss)(
        jax.tree.map(jnp.asarray, host))
    ad = trainer.tree_map(lambda t: t.requires_grad_(),
                          lora.adapters_from_numpy(host, 'cpu'))
    loss = t_loss(ad)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(ad))
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=ATOL,
                               rtol=0)
    _assert_grads_close(grads, jax.tree.leaves(ref_grads))


def test_reference_passes_take_the_no_lse_forward(monkeypatch):
    """The policy passes run the flash forward with its lse (for the
    backward), the reference passes without it (under no_grad): on the
    card, K2's two routes."""
    _, tcfg, _, tree = _models()
    tp = llama.params_from_numpy(tree, tcfg, 'cpu')
    ad = lora.init_lora(tp, lora.LoraConfig(rank=2),
                        torch.Generator().manual_seed(1))
    ad = trainer.tree_map(lambda t: t.requires_grad_(), ad)
    seen = []
    fwd = attention.flash_attention_fwd

    def record(q, k, v, causal=True, need_lse=False):
        seen.append(need_lse)
        return fwd(q, k, v, causal, need_lse)
    monkeypatch.setattr(attention, 'flash_attention_fwd', record)
    _, t_batch = _both(_pair_batch())
    policy = lora.apply_lora(tp, ad, lora.LoraConfig(rank=2))
    dpo.dpo_loss_fn(policy, tp, t_batch, tcfg)
    layers = tcfg.n_layers
    # chosen and rejected: the policy's first, then the reference's.
    assert seen == [True] * (2 * layers) + [False] * (2 * layers)


# ---- the entry point -------------------------------------------------------------

def test_train_dpo_lora_runs_on_the_cpu(tmp_path):
    path = _write_jsonl(tmp_path / 'pairs.jsonl', [
        {'prompt': f'q{i}?', 'chosen': f' good {i}', 'rejected': f' bad {i}'}
        for i in range(6)])
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.train_dpo',
         '--data-file', path, '--seq-len', '32', '--steps', '3',
         '--log-every', '1', '--lora-rank', '8', '--learning-rate', '1e-3',
         '--device', 'cpu'], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=30)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'reference = frozen base (no copy)' in proc.stdout
    losses = [float(line.split('loss=')[1]) for line in
              proc.stdout.splitlines() if line.startswith('step ')]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert losses[0] == pytest.approx(math.log(2), abs=1e-4)
    assert proc.stdout.rstrip().endswith('DPO done.')
