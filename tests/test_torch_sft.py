"""The port's SFT path (skypilot_tpu_torch: train/sft.py,
models/llama.token_logprobs, train/trainer.make_optimizer and the
SKYTPU_STEP_METRICS timing, train/train_sft.py) against the JAX
package, on the CPU.

Inputs are numpy draws from fixed seeds (and JSONL files the tests
write), at LLAMA_DEBUG widths in f32, with the JAX parameters carried
over by ``llama.params_from_numpy``.  Tolerances:
- the data path (encode_example, sft_batches): arrays equal, and the
  same ValueError messages for bad JSONL;
- the masked CE: loss atol ATOL = 1e-5 (test_torch_train.py's), and each
  gradient leaf atol ATOL (both sides sum in f32 in other orders through
  2 layers; the gradients are O(1e-2));
- the entry point: finishes on the CPU within 30 s with finite losses;
  train_sft, train_dpo, train_rl and train_llama train from a tiny HF
  checkpoint directory (--hf-model) that the test writes with
  chip_smoke.py's writer, and print finite losses; train_sft, train_dpo
  and train_rl take the mesh flags (2 gloo rank processes);
- on meshes of 4 gloo ranks (tests/_torch_ranks.py): LoRA-SFT and
  LoRA-DPO at dp 2 x fsdp 2 and fsdp 2 x tp 2 against the JAX mesh
  Trainer on 4 of the 8 CPU devices and the port's one card (losses and
  grad norms within MESH_RTOL, the adapters after within 2 x the summed
  learning rates), merge_lora on the mesh bitwise one card's merge of
  the same adapters; GRPO at dp 2 (rows padded to the shards) and fsdp
  2 with the one-card rollout tokens and losses within MESH_RTOL.
"""
import dataclasses
import importlib.util
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

from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.ops import losses as j_losses  # noqa: E402
from skypilot_tpu.train import sft as j_sft  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.telemetry import metrics  # noqa: E402
from skypilot_tpu_torch.train import sft, trainer  # noqa: E402

ATOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _debug_models(**overrides):
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG, **overrides)
    tcfg = dataclasses.replace(llama.LLAMA_DEBUG, **overrides)
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jcfg, tcfg, jp, tree


def _write_jsonl(path, rows):
    with open(path, 'w', encoding='utf-8') as f:
        for row in rows:
            f.write((row if isinstance(row, str) else json.dumps(row))
                    + '\n')
    return str(path)


def _pairs(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [{'prompt': 'q' * int(rng.randint(1, 12)) + f' {i}?',
             'completion': ' a' * int(rng.randint(1, 9)) + '.'}
            for i in range(n)]


def _encode(text):
    return [b % 512 for b in text.encode('utf-8')]


# ---- the data path -----------------------------------------------------------

@pytest.mark.parametrize('prompt,completion,seq_len', [
    ([5, 6, 7], [8, 9], 8),          # fits, with pad
    ([5, 6, 7], [8, 9, 10, 11], 4),  # truncated inside the completion
    (list(range(1, 10)), [3], 4),    # truncated inside the prompt
    ([], [4, 5], 6),                 # no prompt
    ([2], [], 3),                    # no completion
])
def test_encode_example_matches_jax(prompt, completion, seq_len):
    got = sft.encode_example(prompt, completion, seq_len)
    want = j_sft.encode_example(prompt, completion, seq_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('eos_id', [None, 3])
def test_sft_batches_match_jax(tmp_path, eos_id):
    path = _write_jsonl(tmp_path / 'sft.jsonl', _pairs())
    got = sft.sft_batches(path, _encode, 3, 24, eos_id=eos_id, seed=5)
    want = j_sft.sft_batches(path, _encode, 3, 24, eos_id=eos_id, seed=5)
    for _ in range(4):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ['loss_mask', 'tokens']
        for key in g:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize('rows', [
    [{'prompt': 'a', 'completion': 'b'}, {'prompt': 'c'}],
    [{'completion': 'b'}],
    ['', '   '],
])
def test_sft_jsonl_errors_match_jax(tmp_path, rows):
    path = _write_jsonl(tmp_path / 'bad.jsonl', rows)
    with pytest.raises(ValueError) as want:
        j_sft.load_jsonl(path)
    with pytest.raises(ValueError) as got:
        sft.load_jsonl(path)
    assert str(got.value) == str(want.value)


# ---- the loss ------------------------------------------------------------------

def test_token_logprobs_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 64).astype(np.float32) * 3
    targets = rng.randint(0, 64, size=(2, 5)).astype(np.int32)
    want = j_llama.token_logprobs(jnp.asarray(logits), jnp.asarray(targets))
    got = llama.token_logprobs(torch.from_numpy(logits),
                               torch.from_numpy(targets))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        _np(want), _np(j_losses.token_logprobs(jnp.asarray(logits),
                                               jnp.asarray(targets))))


def _sft_batch(batch=2, seq=40, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 512, size=(batch, seq + 1)).astype(np.int32)
    mask = np.zeros((batch, seq), np.float32)
    mask[0, 10:30] = 1.0
    mask[1, 3:seq] = 1.0
    return {'tokens': tokens, 'loss_mask': mask}


@pytest.mark.parametrize('loss_chunk', [None, 16])
def test_sft_loss_and_gradients_match_jax(loss_chunk):
    """LLAMA_DEBUG f32, 2 x 40 targets with a prompt mask; loss_chunk 16
    gives two chunks and a ragged tail."""
    jcfg, tcfg, jp, tree = _debug_models(loss_chunk=loss_chunk)
    batch = _sft_batch()
    ref, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: j_sft.sft_loss_fn(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)))(jp)
    params = trainer.tree_map(lambda t: t.requires_grad_(),
                              llama.params_from_numpy(tree, tcfg, 'cpu'))
    loss = sft.sft_loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(ref), atol=ATOL,
                               rtol=0)
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(ref_leaves) == len(grads) == 12
    for got, want in zip(grads, ref_leaves):
        assert float(got.abs().max()) > 0
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_sft_loss_ignores_masked_targets_and_empty_mask():
    """A target outside the mask moves nothing; an all-zero mask gives
    0 (the max(mask.sum(), 1) floor), as in the JAX package."""
    _, tcfg, _, tree = _debug_models()
    params = llama.params_from_numpy(tree, tcfg, 'cpu')
    batch = {k: torch.from_numpy(v) for k, v in _sft_batch().items()}
    base = float(sft.sft_loss_fn(params, batch, tcfg))
    masked_only = dict(batch, tokens=batch['tokens'].clone())
    masked_only['tokens'][0, 40] = 9  # target of position 39: masked out
    assert float(sft.sft_loss_fn(params, masked_only, tcfg)) == base
    empty = dict(batch, loss_mask=torch.zeros_like(batch['loss_mask']))
    assert float(sft.sft_loss_fn(params, empty, tcfg)) == 0.0


# ---- the trainer's additions ---------------------------------------------------

def test_make_optimizer_is_the_trainers_optimizer():
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=2,
                             total_steps=9)
    opt = trainer.make_optimizer(tc)
    assert isinstance(opt, trainer.Optimizer) and opt.config == tc
    tr = trainer.Trainer(lambda p, b: (p['w'] ** 2).sum(),
                         {'w': torch.ones(3)}, tc, device='cpu')
    assert isinstance(tr.tx, trainer.Optimizer)
    assert [opt.schedule(i) for i in range(10)] == \
        [tr.tx.schedule(i) for i in range(10)]


def _sync_count():
    return metrics.REGISTRY.get_sample_value(
        'skytpu_train_step_duration_seconds_count', {'phase': 'sync'}) or 0.0


@pytest.mark.parametrize('env', [None, '1'])
def test_step_metrics_env_times_each_run_step(monkeypatch, env):
    """SKYTPU_STEP_METRICS set: every run_step observes phase="sync";
    unset: none does."""
    if env is None:
        monkeypatch.delenv('SKYTPU_STEP_METRICS', raising=False)
    else:
        monkeypatch.setenv('SKYTPU_STEP_METRICS', env)
    tr = trainer.Trainer(lambda p, b: (p['w'] * b['x']).sum() ** 2,
                         {'w': torch.ones(3)},
                         trainer.TrainConfig(warmup_steps=1, total_steps=4),
                         device='cpu')
    before = _sync_count()
    for _ in range(3):
        tr.run_step({'x': np.ones(3, np.float32)})
    assert _sync_count() - before == (3 if env else 0)


# ---- the entry point -----------------------------------------------------------

def _run_entry(module, *args, timeout=60):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_train_sft_runs_on_the_cpu(tmp_path):
    path = _write_jsonl(tmp_path / 'sft.jsonl', _pairs())
    proc = _run_entry('skypilot_tpu_torch.train.train_sft', '--data-file',
                      path, '--seq-len', '32', '--steps', '3',
                      '--log-every', '1', '--loss-chunk', '16', '--device',
                      'cpu', timeout=30)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(line.split('loss=')[1]) for line in
              proc.stdout.splitlines() if line.startswith('step ')]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert proc.stdout.startswith('SFT: devices=1 device=cpu model=debug')
    assert proc.stdout.rstrip().endswith('SFT done.')


# The mesh flags of the post-training entry points, each a run of 2 gloo
# rank processes on the CPU: (module, flags, the mesh line).  --ep is
# train_sft's alone and takes a Mixtral tree, as in the JAX scripts.
_MESH_RUNS = [
    ('train_sft', ('--fsdp', '2'), 'devices=2 mesh(fsdp=2)'),
    ('train_sft', ('--tp', '2', '--lora-rank', '4'), 'devices=2 mesh(tp=2)'),
    ('train_sft', ('--ep', '2', '--lora-rank', '4', '--lora-targets',
                   'attn-qv'), 'devices=2 mesh(ep=2)'),
    ('train_dpo', ('--fsdp', '2', '--lora-rank', '4'),
     'devices=2 mesh(fsdp=2)'),
    ('train_dpo', ('--tp', '2'), 'devices=2 mesh(tp=2)'),
    ('train_rl', ('--fsdp', '2'), None),
    ('train_rl', ('--tp', '2'), None),
]


@pytest.mark.parametrize('module,flags,line', _MESH_RUNS,
                         ids=['sft-fsdp2', 'sft-lora-tp2', 'sft-ep2-mixtral',
                              'dpo-lora-fsdp2', 'dpo-tp2', 'rl-fsdp2',
                              'rl-tp2'])
def test_entry_points_train_on_meshes(tmp_path, hf_dirs, module, flags,
                                      line):
    """--dp/--fsdp/--tp/--ep spawn one process a rank: the run prints
    the reference's lines once (rank 0), with the mesh, and finite
    losses."""
    if module == 'train_rl':
        args = ['--steps', '2', '--group-size', '2', '--max-new-tokens',
                '4']
    else:
        rows = _pairs() if module == 'train_sft' else [
            {'prompt': p['prompt'], 'chosen': p['completion'],
             'rejected': p['completion'][::-1]} for p in _pairs()]
        args = ['--data-file', _write_jsonl(tmp_path / 'd.jsonl', rows),
                '--seq-len', '32', '--steps', '2', '--log-every', '1']
    if '--ep' in flags:
        args += ['--hf-model', hf_dirs['mixtral']]
    proc = _run_entry(f'skypilot_tpu_torch.train.{module}', *args, *flags,
                      '--device', 'cpu', timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    out = proc.stdout
    if module == 'train_rl':
        steps = [ln for ln in out.splitlines() if ln.startswith('rl step')]
        assert len(steps) == 2 and out.rstrip().splitlines()[-1].startswith(
            'rl OK: 2 steps, final reward=')
        losses = [float(ln.split('loss=')[1]) for ln in steps]
    else:
        head = 'SFT' if module == 'train_sft' else 'DPO'
        assert out.startswith(f'{head}: {line} device=cpu'), out
        assert out.rstrip().endswith(f'{head} done.')
        losses = [float(ln.split('loss=')[1]) for ln in out.splitlines()
                  if ln.startswith('step ')]
        assert len(losses) == 2
    assert np.all(np.isfinite(losses))


# Tiny HF configs (config.json fields) of three families for --hf-model:
# Gemma (head_dim 32 != 64 / 4, gelu, (1 + w) norms, tied), Qwen2 (q/k/v
# biases, a group of 6, tied) and Mixtral (4 experts, top 2).
_TINY = dict(vocab_size=300, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256,
             rms_norm_eps=1e-6, rope_theta=10000.0,
             tie_word_embeddings=False)
_HF_CONFIGS = {
    'gemma': dict(_TINY, model_type='gemma', head_dim=32,
                  num_key_value_heads=1, hidden_act='gelu',
                  tie_word_embeddings=True),
    'qwen2': dict(_TINY, model_type='qwen2', hidden_size=96,
                  num_attention_heads=6, num_key_value_heads=1,
                  use_sliding_window=False, tie_word_embeddings=True),
    'mixtral': dict(_TINY, model_type='mixtral', num_local_experts=4,
                    num_experts_per_tok=2, sliding_window=None),
}


@pytest.fixture(scope='module')
def hf_dirs(tmp_path_factory):
    """family -> a bf16 checkpoint directory in HF's layout, random
    weights from seed 0, written by chip_smoke.py's writer."""
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = {}
    for family, hf_config in _HF_CONFIGS.items():
        d = tmp_path_factory.mktemp(f'hf_{family}')
        cs.write_hf_checkpoint(
            str(d), hf_config,
            lambda name, shape, g=family == 'gemma': cs.draw_hf_tensor(
                name, shape, 0, torch.bfloat16, 'cpu', gemma=g))
        out[family] = str(d)
    return out


def _dpo_rows(n=6, seed=0):
    rng = np.random.RandomState(seed)
    letters = list('abcdefgh ')
    text = lambda k: ''.join(rng.choice(letters, k))  # noqa: E731
    return [{'prompt': text(12), 'chosen': text(20), 'rejected': text(20)}
            for _ in range(n)]


_HF_RUNS = {
    'train_sft': (['--seq-len', '32', '--steps', '3', '--log-every', '1',
                   '--lora-rank', '4'], 'step '),
    'train_dpo': (['--seq-len', '48', '--steps', '3', '--log-every', '1',
                   '--lora-rank', '4'], 'step '),
    'train_rl': (['--steps', '2', '--group-size', '2',
                  '--max-new-tokens', '4'], 'rl step '),
    'train_llama': (['--seq-len', '32', '--batch-size', '2', '--steps', '3',
                     '--checkpoint-every', '1'], None),
}


@pytest.mark.parametrize('module,family', [
    (module, family) for module in _HF_RUNS for family in ('gemma', 'qwen2')
] + [('train_sft', 'mixtral')])
def test_entry_points_train_from_an_hf_checkpoint(tmp_path, hf_dirs, module,
                                                  family):
    """--hf-model DIR: the entry point converts the directory (a Mixtral
    one into the MoE tree, through train_sft) and trains from it on the
    CPU with finite losses."""
    args, prefix = _HF_RUNS[module]
    data = []
    if module == 'train_sft':
        data = ['--data-file', _write_jsonl(tmp_path / 'd.jsonl', _pairs())]
    elif module == 'train_dpo':
        data = ['--data-file', _write_jsonl(tmp_path / 'd.jsonl',
                                            _dpo_rows())]
    proc = _run_entry(f'skypilot_tpu_torch.train.{module}', '--hf-model',
                      hf_dirs[family], *data, *args, '--device', 'cpu',
                      timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if module != 'train_rl':   # train_rl prints no header, as the JAX one
        assert f'model={hf_dirs[family]}' in proc.stdout.splitlines()[0]
    if prefix is None:   # train_llama: its final line
        losses = [float(proc.stdout.split('final: loss=')[1].split()[0])]
    else:
        losses = [float(line.split('loss=')[1].split()[0]) for line in
                  proc.stdout.splitlines() if line.startswith(prefix)]
        assert len(losses) == int(args[args.index('--steps') + 1])
    assert np.all(np.isfinite(losses)), proc.stdout


@pytest.mark.parametrize('module', ['train_dpo', 'train_rl', 'train_llama'])
def test_dense_entry_points_refuse_a_mixtral_checkpoint(tmp_path, hf_dirs,
                                                        module):
    data = (['--data-file', str(tmp_path / 'x.jsonl')]
            if module == 'train_dpo' else [])
    proc = _run_entry(f'skypilot_tpu_torch.train.{module}', '--hf-model',
                      hf_dirs['mixtral'], *data, '--device', 'cpu',
                      timeout=60)
    assert proc.returncode != 0
    assert 'Mixtral (MoE) checkpoint' in proc.stderr, proc.stderr


# ---- post-training on meshes ------------------------------------------------

MESH_RTOL = 1e-5
MESH_CFG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=128, remat=False)
MESH_TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4)


@pytest.fixture(scope='module')
def pool4():
    import _torch_ranks
    p = _torch_ranks.RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope='module')
def pool2():
    """A 2-rank pool for the 2-rank meshes, closed at module teardown,
    so that a worker never holds a finished module's ranks."""
    import _torch_ranks
    p = _torch_ranks.RankPool(2)
    yield p
    p.close()


def _mesh_base():
    import _torch_ranks
    cfg = _torch_ranks._cfg('llama', **MESH_CFG)
    return _torch_ranks._tree_np(
        llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu'))


def _mesh_adapters(tree, rank=4, seed=0):
    """Adapters of the 'attn' targets with A and B both non-zero."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in ('wq', 'wk', 'wv', 'wo'):
        w = tree['layers']['attn'][name]
        lead, (d_in, d_out) = w.shape[:-2], w.shape[-2:]
        out[name] = {'a': (rng.randn(*lead, d_in, rank) * d_in ** -0.5
                           ).astype(np.float32),
                     'b': (rng.randn(*lead, rank, d_out) * 0.02
                           ).astype(np.float32)}
    return {'layers': {'attn': out}}


def _mesh_batches(kind, n=3, batch=4, seq=16):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        def side():
            tokens = rng.integers(0, MESH_CFG['vocab_size'],
                                  (batch, seq + 1), dtype=np.int32)
            mask = (rng.random((batch, seq)) < 0.7).astype(np.float32)
            return tokens, mask
        if kind == 'sft':
            t, m = side()
            out.append({'tokens': t, 'loss_mask': m})
        else:
            (tc, mc), (tr, mr) = side(), side()
            out.append({'tokens_chosen': tc, 'mask_chosen': mc,
                        'tokens_rejected': tr, 'mask_rejected': mr})
    return out


def _jax_lora_run(kind, tree, adapters, mesh_kw, batches, beta):
    from skypilot_tpu.parallel import MeshConfig, make_mesh
    from skypilot_tpu.parallel import sharding as j_sharding
    from skypilot_tpu.train import dpo as j_dpo
    from skypilot_tpu.train import lora as j_lora
    from skypilot_tpu.train import trainer as j_trainer
    jcfg = j_llama.LlamaConfig(**dict(MESH_CFG, dtype=jnp.float32))
    n = int(np.prod(list(mesh_kw.values())))
    mesh = make_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:n])
    base = j_sharding.shard_params(jax.tree.map(jnp.asarray, tree), mesh,
                                   j_sharding.LLAMA_RULES)
    lcfg = j_lora.LoraConfig(rank=4, alpha=8.0)
    if kind == 'sft':
        loss = j_lora.wrap_loss(lambda p, b: j_sft.sft_loss_fn(p, b, jcfg),
                                base, lcfg)
    else:
        def loss(ad, b):
            return j_dpo.dpo_loss_fn(j_lora.apply_lora(base, ad, lcfg),
                                     base, b, jcfg, beta=beta)
    tr = j_trainer.Trainer(loss, jax.tree.map(np.copy, adapters), mesh,
                           j_lora.LORA_RULES, j_trainer.TrainConfig(**MESH_TC))
    out = {'loss': [], 'grad_norm': []}
    for b in batches:
        m = tr.run_step(b)
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
    out['params'] = jax.tree.map(np.asarray, tr.params)
    tr.close()
    return out


def _leaf_items(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], f'{prefix}/{k}')
    else:
        yield prefix, np.asarray(tree)


def _hold_run(got, want, what):
    for key in ('loss', 'grad_norm'):
        np.testing.assert_allclose(got[key], want[key], rtol=MESH_RTOL,
                                   err_msg=f'{what} {key}')
    schedule = trainer.make_optimizer(
        trainer.TrainConfig(**MESH_TC)).schedule
    atol = 2 * sum(schedule(i) for i in range(len(got['loss'])))
    for (k, g), (_, w) in zip(_leaf_items(got['params']),
                              _leaf_items(want['params'])):
        assert np.abs(g - w).max() <= atol, (what, k)


@pytest.mark.parametrize('kind,mesh_kw', [
    ('sft', {'dp': 2, 'fsdp': 2}), ('sft', {'fsdp': 2, 'tp': 2}),
    ('dpo', {'dp': 2, 'fsdp': 2}), ('dpo', {'fsdp': 2, 'tp': 2})],
    ids=['sft-dp2-fsdp2', 'sft-fsdp2-tp2', 'dpo-dp2-fsdp2',
         'dpo-fsdp2-tp2'])
def test_lora_on_a_mesh_matches_jax_and_one_card(pool4, kind, mesh_kw):
    """3 LoRA steps (adapters replicated, the base this rank's blocks):
    every rank the same bits; losses, norms and adapters as the JAX mesh
    Trainer's and one card's; merge_lora on the mesh bitwise one card's
    merge of the mesh's adapters on rank 0, and nothing on the others."""
    import _torch_ranks
    from skypilot_tpu_torch.train import lora
    tree = _mesh_base()
    adapters = _mesh_adapters(tree)
    batches = _mesh_batches(kind)
    common = dict(kind=kind, tree=tree, adapters=adapters,
                  cfg_kw=MESH_CFG, lcfg_kw=dict(rank=4, alpha=8.0),
                  tc_kw=MESH_TC, batches=batches, beta=0.5)
    outs = pool4.run('lora_mesh_case', mesh_kw=mesh_kw, **common)
    for o in outs[1:]:
        assert o['bits'] == outs[0]['bits']
    got = outs[0]
    one = _torch_ranks.lora_mesh_case(mesh_kw=None, **common)
    want = _jax_lora_run(kind, tree, adapters, mesh_kw, batches, 0.5)
    _hold_run(got, want, 'against the JAX mesh Trainer')
    _hold_run(got, one, "against the port's one card")
    cfg = _torch_ranks._cfg('llama', **MESH_CFG)
    one_merge = lora.merge_lora(
        _torch_ranks._params(tree, cfg),
        lora.adapters_from_numpy(got['params'], 'cpu'),
        lora.LoraConfig(rank=4, alpha=8.0))
    for (k, g), (_, w) in zip(_leaf_items(got['merged']),
                              _leaf_items(trainer.tree_map(
                                  lambda x: x.numpy(), one_merge))):
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    # The other ranks keep no host copy of the merged tree.
    assert all(o['merged'] is None for o in outs[1:])


@pytest.mark.parametrize('mesh_kw,group,prompts', [
    ({'dp': 2}, 4, [[11, 13, 5], [17, 19]]),
    ({'dp': 2}, 3, [[11, 13, 5], [17, 19], [23]]),
    ({'fsdp': 2}, 4, [[11, 13, 5], [17, 19]])],
    ids=['dp2', 'dp2-padded', 'fsdp2'])
def test_grpo_on_a_mesh_gives_one_cards_rollouts(pool4, pool2, mesh_kw,
                                                 group, prompts):
    """Two GrpoTrainer steps at temperature 1 with the KL term on: every
    rank rolls out the one-card tokens (the policy gathered whole), and
    the losses and reward statistics are one card's (MESH_RTOL); 9 rows
    on dp 2 are padded to 10 with zero-mask rows."""
    import _torch_ranks
    tree = _mesh_base()
    kw = dict(group_size=group, max_new_tokens=6, max_prompt_len=8,
              temperature=1.0, learning_rate=1e-2, kl_coef=0.05,
              total_steps=4, seed=3)
    ranks = mesh_kw.get('dp', 1) * mesh_kw.get('fsdp', 1)
    pool_kw = dict(tree=tree, cfg_kw=MESH_CFG, kw=kw, prompts=prompts,
                   steps=2)
    outs = (pool4 if ranks == 4 else pool2).run(
        'grpo_mesh_case', mesh_kw=mesh_kw, **pool_kw)
    one = _torch_ranks.grpo_mesh_case(mesh_kw=None, **pool_kw)
    for o in outs:
        assert o['seen'] == one['seen']
        assert o['rollout_bytes'] > 0
        for g, w in zip(o['metrics'], one['metrics']):
            assert g['step'] == w['step']
            for key in ('loss', 'reward_mean', 'reward_std'):
                assert g[key] == pytest.approx(w[key], rel=MESH_RTOL,
                                               abs=MESH_RTOL), key
