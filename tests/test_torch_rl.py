"""The port's GRPO (skypilot_tpu_torch/train/rl.py and
train/train_rl.py) against the JAX package's train/rl.py, on the CPU.

LLAMA_DEBUG in f32 (and the JAX tests' 64-wide config for the learning
run), parameters from one JAX draw crossed with
``llama.params_from_numpy``.  Tolerances:
- group_advantages and build_batch: arrays equal, the same ValueError;
- grpo_loss, kl_coef 0 and 0.05, and with the port's loss_chunk against
  JAX's full logits: loss atol ATOL = 1e-5 (test_torch_train.py's), each
  gradient leaf atol ATOL (f32 summation order through 2 layers);
- GrpoTrainer at temperature 0: every rollout token identical to the JAX
  GrpoTrainer's (greedy, f32), the loss at atol ATOL;
- sampled rollouts (temperature 1) are compared in distribution only:
  both packages' GRPO raise the reward, and the first step's
  token-band reward means agree within 5 standard errors.
"""
import dataclasses
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
from skypilot_tpu.parallel import MeshConfig, make_mesh  # noqa: E402
from skypilot_tpu.parallel import sharding as j_sharding  # noqa: E402
from skypilot_tpu.train import rl as j_rl  # noqa: E402
from skypilot_tpu_torch.infer.engine import (Generator,  # noqa: E402
                                             GeneratorConfig)
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.train import rl, trainer  # noqa: E402
from skypilot_tpu_torch.train.train_rl import make_rewards  # noqa: E402

ATOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
# The JAX package's tests/test_rl.py config, for the sampled runs.
SMALL = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128, remat=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """The Generator's decode steps are many small ops: with several test
    workers on the host's cores, torch's intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ---- host-side helpers ---------------------------------------------------------

@pytest.mark.parametrize('rewards,group', [
    ([1.0, 3.0, 10.0, 10.0], 2),
    (list(np.random.RandomState(0).rand(12)), 4),
    ([0.5] * 8, 8),
])
def test_group_advantages_match_jax(rewards, group):
    got = rl.group_advantages(np.asarray(rewards), group)
    want = j_rl.group_advantages(np.asarray(rewards), group)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_group_advantages_rejects_a_ragged_group_like_jax():
    with pytest.raises(ValueError) as want:
        j_rl.group_advantages(np.ones(5), 2)
    with pytest.raises(ValueError) as got:
        rl.group_advantages(np.ones(5), 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('pad_to', [8, 16, 5])
def test_build_batch_matches_jax(pad_to):
    prompts = [[5, 6], [1], [2, 3, 4]]
    completions = [[7, 8, 9], [4, 4, 4, 4, 4], []]
    got = rl.build_batch(prompts, completions, [1.0, -0.5, 0.0], pad_to)
    want = j_rl.build_batch(prompts, completions, [1.0, -0.5, 0.0], pad_to)
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


# ---- the loss -------------------------------------------------------------------

def _rl_batch(seed=0, rows=4, t_len=24):
    rng = np.random.RandomState(seed)
    prompts = [list(rng.randint(1, 512, size=rng.randint(2, 8)))
               for _ in range(rows)]
    completions = [list(rng.randint(1, 512, size=rng.randint(1, 12)))
                   for _ in range(rows)]
    adv = rl.group_advantages(rng.rand(rows), 2)
    return rl.build_batch(prompts, completions, adv, t_len)


@pytest.mark.parametrize('kl_coef,loss_chunk',
                         [(0.0, None), (0.05, None), (0.05, 8)],
                         ids=['0.0', '0.05', '0.05-chunk8'])
def test_grpo_loss_and_gradients_match_jax(kl_coef, loss_chunk):
    """With loss_chunk the port takes the blockwise CE (T-1 = 23 in
    chunks of 8, a ragged tail); the JAX grpo_loss always takes the full
    logits."""
    jcfg, tcfg, jp, tree = _models()
    _, _, jref, ref_tree = _models(seed=1)
    tcfg = dataclasses.replace(tcfg, loss_chunk=loss_chunk)
    batch = _rl_batch()
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, ref_grads = jax.value_and_grad(
        lambda p: j_rl.grpo_loss(p, j_batch, jcfg, kl_coef=kl_coef,
                                 ref_params=jref))(jp)
    params = trainer.tree_map(lambda t: t.requires_grad_(),
                              llama.params_from_numpy(tree, tcfg, 'cpu'))
    ref_params = llama.params_from_numpy(ref_tree, tcfg, 'cpu')
    loss = rl.grpo_loss(params, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                        tcfg, kl_coef=kl_coef, ref_params=ref_params)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=ATOL,
                               rtol=0)
    for g, w in zip(grads, jax.tree.leaves(ref_grads)):
        assert float(g.abs().max()) > 0
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=0)


# ---- the GrpoTrainer --------------------------------------------------------------

def _recording(reward_fn, seen):
    def reward(prompt, completion):
        seen.append((list(map(int, prompt)), list(map(int, completion))))
        return reward_fn(prompt, completion)
    return reward


def test_greedy_grpo_trainer_matches_jax():
    """Two GrpoTrainer steps at temperature 0 with the KL term on: the
    same rollout tokens and losses as the JAX GrpoTrainer on the 8-device
    CPU mesh.  (Greedy rollouts of one prompt are identical, so every
    advantage is 0: the step is AdamW's weight decay alone.)"""
    jcfg, tcfg, jp, tree = _models()
    band = make_rewards(512)['token-band']
    kw = dict(group_size=4, max_new_tokens=8, max_prompt_len=16,
              temperature=0.0, learning_rate=1e-2, kl_coef=0.05,
              total_steps=4, seed=3)
    j_seen, t_seen = [], []
    j_tr = j_rl.GrpoTrainer(jax.tree.map(np.asarray, jp), jcfg,
                            make_mesh(MeshConfig(dp=jax.device_count())),
                            j_sharding.LLAMA_RULES,
                            _recording(band, j_seen), **kw)
    t_tr = rl.GrpoTrainer(llama.params_from_numpy(tree, tcfg, 'cpu'), tcfg,
                          _recording(band, t_seen), device='cpu', **kw)
    prompts = [[11, 13, 5], [17, 19]]
    for _ in range(2):
        want, got = j_tr.step(prompts), t_tr.step(prompts)
        assert got['step'] == want['step']
        for key in ('loss', 'reward_mean', 'reward_std'):
            np.testing.assert_allclose(got[key], want[key], atol=ATOL,
                                       rtol=0)
        assert got['rollout_s'] > 0 and got['update_s'] > 0
    assert len(t_seen) == 16 and t_seen == j_seen
    assert all(len(c) == 8 for _, c in t_seen)
    for got, want in zip(trainer.tree_leaves(t_tr.trainer.params),
                         jax.tree.leaves(j_tr.trainer.params)):
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    t_tr.close()
    j_tr.close()


def test_rollouts_read_the_live_policy():
    """The Generator holds the Trainer's own tensors: after an update, a
    rollout from it equals one from a fresh Generator over a clone of the
    Trainer's params (same seed), and differs from the initial policy's."""
    _, tcfg, _, tree = _models()
    params = llama.params_from_numpy(tree, tcfg, 'cpu')
    initial = trainer.tree_map(lambda t: t.clone(), params)
    tr = rl.GrpoTrainer(params, tcfg, make_rewards(512)['token-band'],
                        group_size=4, max_new_tokens=8, max_prompt_len=16,
                        temperature=1.0, learning_rate=3e-2,
                        total_steps=4, seed=0, device='cpu')
    live = tr._generator
    for got, want in zip(trainer.tree_leaves(live.params), tr.trainer._leaves):
        assert got is want
    for _ in range(2):   # the first step's learning rate is 0 (warmup)
        tr.step([[11, 13], [17, 19]])
    prompts = [[11, 13]] * 4

    def rollout(gen):
        with torch.no_grad():
            return gen.generate(prompts, max_new_tokens=8, seed=7)
    clone = trainer.tree_map(lambda t: t.detach().clone(), tr.trainer.params)
    fresh = Generator(clone, tcfg, live.gen, device='cpu')
    stale = Generator(initial, tcfg, live.gen, device='cpu')
    assert rollout(live) == rollout(fresh)
    assert rollout(live) != rollout(stale)
    tr.close()


def _band_share(completions, target):
    toks = [t for c in completions for t in c]
    return sum(1 for t in toks if t <= target) / len(toks), len(toks)


def test_sampled_rollouts_agree_with_jax_in_distribution():
    """First step, same params, temperature 1, 64 completions of 8 tokens
    a package: the token-band share agrees within 5 standard errors."""
    jcfg, tcfg, jp, tree = _models(**SMALL)
    kw = dict(group_size=64, max_new_tokens=8, max_prompt_len=8,
              temperature=1.0, learning_rate=1e-3, total_steps=2)
    j_seen, t_seen = [], []
    j_tr = j_rl.GrpoTrainer(jax.tree.map(np.asarray, jp), jcfg,
                            make_mesh(MeshConfig(dp=jax.device_count())),
                            j_sharding.LLAMA_RULES,
                            _recording(lambda p, c: 0.0, j_seen), **kw)
    t_tr = rl.GrpoTrainer(llama.params_from_numpy(tree, tcfg, 'cpu'), tcfg,
                          _recording(lambda p, c: 0.0, t_seen),
                          device='cpu', **kw)
    j_tr.step([[11, 13]])
    t_tr.step([[11, 13]])
    target = 64 // 8
    p_j, n = _band_share([c for _, c in j_seen], target)
    p_t, _ = _band_share([c for _, c in t_seen], target)
    se = np.sqrt(2 * max(p_j, 1e-3) * (1 - p_j) / n)
    assert abs(p_t - p_j) < 5 * se, (p_t, p_j, se)
    t_tr.close()
    j_tr.close()


def test_grpo_learns_the_target_token_reward():
    """The JAX package's end-to-end property, on the port: a few GRPO
    iterations raise the reward (test_rl.py's settings)."""
    _, tcfg, _, tree = _models(**SMALL)
    target = 7

    def reward(prompt, completion):
        return sum(1 for t in completion if t == target) / max(
            len(completion), 1)
    tr = rl.GrpoTrainer(llama.params_from_numpy(tree, tcfg, 'cpu'), tcfg,
                        reward, group_size=8, max_new_tokens=8,
                        temperature=1.0, learning_rate=5e-3,
                        total_steps=12, seed=3, device='cpu')
    history = [tr.step([[11, 13], [17, 19]])['reward_mean']
               for _ in range(10)]
    assert np.mean(history[-3:]) > np.mean(history[:3]) + 0.1, history
    tr.close()


def test_prompt_longer_than_max_prompt_len_raises():
    _, tcfg, _, tree = _models(**SMALL)
    tr = rl.GrpoTrainer(llama.params_from_numpy(tree, tcfg, 'cpu'), tcfg,
                        lambda p, c: 0.0, max_prompt_len=4, device='cpu')
    with pytest.raises(ValueError, match='exceed max_prompt_len=4'):
        tr.step([[1, 2, 3, 4, 5]])


# ---- the entry point ------------------------------------------------------------------

def test_train_rl_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.train_rl',
         '--steps', '3', '--device', 'cpu'], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=30)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith('rl step ')]
    assert len(lines) == 3
    assert all(np.isfinite(float(line.split('loss=')[1])) for line in lines)
    assert 'rl OK: 3 steps' in proc.stdout
