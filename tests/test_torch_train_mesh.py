"""The port's training meshes on the CPU (parallel/sharding.py, the mesh
Trainer of train/trainer.py, the sharded forward of models/llama.py and
models/moe.py, checkpoints under a mesh, and the entry points that take
mesh flags), held against the JAX package.

The port runs one gloo process a rank (tests/_torch_ranks.py, a pool of
4 started once); the JAX Trainer runs the same mesh shape on 4 devices
of the 8-device CPU mesh.  What must hold, in f32 at small widths:
- 3 Trainer steps at dp 2 x fsdp 2, fsdp 2 x tp 2, sp 4 (ring
  attention), sp 2 x tp 2 and tp 4 (KV heads replicated over tp), and
  MoE at ep 2 x dp 2 under both routers and under the 'capacity' router
  at sp 2 x ep 2 and sp 2 x dp 2 (dropping tokens): each step's loss and grad norm
  within STEP_RTOL of the JAX mesh Trainer's and of the port's one-card
  Trainer's, and every parameter after within the tolerance of
  test_torch_train (PARAM_ATOL_LRS x the summed learning rates, 99% of
  elements within 1e-6: Adam divides by sqrt(nu), so rounding in a
  near-zero gradient moves its element by up to the learning rate);
  every rank reports the same bits of loss and grad norm;
- a checkpoint saved at fsdp 2 x tp 2 restores bitwise in the JAX
  Trainer and in the port's one-card Trainer, and theirs restore
  bitwise at fsdp 2 x tp 2;
- llama.forward and moe.hidden_states under a mesh give each rank's
  block of the one-card outputs;
- shard_params / gather_params are inverse cuts of the global tree,
  and a one-rank mesh trains as one card (the 'pp' axis has
  test_torch_pipeline.py);
- the entry points run as child processes on ``--device cpu``.
"""
import functools
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
from skypilot_tpu.models import moe as j_moe  # noqa: E402
from skypilot_tpu.parallel import MeshConfig, make_mesh  # noqa: E402
from skypilot_tpu.parallel import ring_attention as j_ring  # noqa: E402
from skypilot_tpu.parallel import sharding as j_sharding  # noqa: E402
from skypilot_tpu.train import trainer as j_trainer  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from skypilot_tpu_torch.parallel import sharding  # noqa: E402
from skypilot_tpu_torch.train import trainer  # noqa: E402

import _torch_ranks  # noqa: E402
from _torch_ranks import RankPool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=128, remat=True)
MOE_KW = dict(CFG_KW, n_experts=4, top_k=2, remat=False)
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4)
# Sums in another order (shards, rank-order combines, the vocabulary-
# parallel logsumexp): f32 rounding only.
STEP_RTOL = 1e-5
PARAM_ATOL_LRS = 2


@pytest.fixture(scope='module')
def pool4():
    p = RankPool(4)
    yield p
    p.close()


def _tree(kind, cfg_kw, seed=0):
    cfg = _torch_ranks._cfg(kind, **cfg_kw)
    from skypilot_tpu_torch.models import moe
    model = moe if kind == 'moe' else llama
    return _torch_ranks._tree_np(
        model.init_params(cfg, torch.Generator().manual_seed(seed), 'cpu'))


def _batches(n=3, seed=0, batch=4, seq=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG_KW['vocab_size'], (batch, seq + 1),
                         dtype=np.int32) for _ in range(n)]


def _jax_cfg(kind, cfg_kw):
    kw = dict(cfg_kw, dtype=jnp.float32)
    return (j_moe.MoeConfig if kind == 'moe' else j_llama.LlamaConfig)(**kw)


def _jax_run(kind, cfg_kw, tree, mesh_kw, batches):
    """The JAX Trainer on the same mesh shape: per-step loss and grad
    norm, and the parameters after, as numpy."""
    jcfg = _jax_cfg(kind, cfg_kw)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = make_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:n])
    model = j_moe if kind == 'moe' else j_llama
    rules = j_sharding.MOE_RULES if kind == 'moe' else j_sharding.LLAMA_RULES
    attention_fn = None
    if mesh_kw.get('sp', 1) > 1:
        attention_fn = functools.partial(
            j_ring.ring_attention, mesh=mesh, axis_name='sp',
            head_axis='tp' if mesh_kw.get('tp', 1) > 1 else None)

    def loss(p, b):
        return model.loss_fn(p, b, jcfg, attention_fn=attention_fn)
    tr = j_trainer.Trainer(loss, jax.tree.map(jnp.asarray, tree), mesh,
                           rules, j_trainer.TrainConfig(**TC))
    out = {'loss': [], 'grad_norm': []}
    for b in batches:
        m = tr.run_step({'tokens': b})
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
    out['params'] = jax.tree.map(np.asarray, tr.params)
    return out


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{prefix}/{k}')
    else:
        yield prefix, np.asarray(tree)


def _lrs(steps=3):
    schedule = trainer.make_optimizer(trainer.TrainConfig(**TC)).schedule
    return sum(schedule(i) for i in range(steps))


def _hold(got, want, what):
    for key in ('loss', 'grad_norm'):
        np.testing.assert_allclose(got[key], want[key], rtol=STEP_RTOL,
                                   err_msg=f'{what} {key}')
    atol = PARAM_ATOL_LRS * _lrs()
    for (name, g), (_, w) in zip(_leaves(got['params']),
                                 _leaves(want['params'])):
        assert g.shape == w.shape, name
        err = np.abs(g - w)
        assert err.max() <= atol, (what, name, err.max())
        assert (err <= 1e-6).mean() > 0.99, (what, name)


MESHES = [
    ('llama', {'dp': 2, 'fsdp': 2}, CFG_KW),
    ('llama', {'fsdp': 2, 'tp': 2}, CFG_KW),
    ('llama', {'sp': 4}, CFG_KW),
    ('llama', {'sp': 2, 'tp': 2}, dict(CFG_KW, loss_chunk=8)),
    ('llama', {'tp': 4}, dict(CFG_KW, n_heads=8, n_kv_heads=2)),
    ('moe', {'ep': 2, 'dp': 2}, dict(MOE_KW, router_impl='capacity')),
    ('moe', {'ep': 2, 'dp': 2}, dict(MOE_KW, router_impl='dense')),
    ('moe', {'ep': 2, 'sp': 2}, dict(MOE_KW, router_impl='capacity')),
    ('moe', {'sp': 2, 'dp': 2}, dict(MOE_KW, router_impl='capacity',
                                     capacity_factor=0.5)),
]


@pytest.mark.parametrize('kind,mesh_kw,cfg_kw', MESHES,
                         ids=['dp2-fsdp2', 'fsdp2-tp2', 'sp4', 'sp2-tp2',
                              'tp4-kv2', 'moe-ep2-dp2-capacity',
                              'moe-ep2-dp2-dense', 'moe-sp2-ep2-capacity',
                              'moe-sp2-dp2-capacity-drops'])
def test_mesh_trainer_matches_jax_and_one_card(pool4, kind, mesh_kw,
                                               cfg_kw):
    tree = _tree(kind, cfg_kw)
    batches = _batches()
    outs = pool4.run('train_case', tree=tree, cfg_kw=cfg_kw, kind=kind,
                     mesh_kw=mesh_kw, tc_kw=TC, batches=batches)
    for o in outs[1:]:
        assert o['bits'] == outs[0]['bits']
    got = outs[0]
    one = _torch_ranks.train_case(tree, cfg_kw, kind, None, TC, batches)
    want = _jax_run(kind, cfg_kw, tree, mesh_kw, batches)
    _hold(got, want, 'against the JAX mesh Trainer')
    _hold(got, one, "against the port's one-card Trainer")


@pytest.mark.parametrize('kind,mesh_kw,cfg_kw', [
    ('llama', {'fsdp': 2, 'tp': 2}, CFG_KW),
    ('moe', {'ep': 2, 'dp': 2}, dict(MOE_KW, router_impl='dense')),
    ('moe', {'sp': 2, 'ep': 2}, dict(MOE_KW, router_impl='capacity',
                                     capacity_factor=0.5)),
], ids=['llama-fsdp2-tp2', 'moe-ep2-dp2', 'moe-sp2-ep2-capacity'])
def test_sharded_forward_gives_one_card_blocks(pool4, kind, mesh_kw,
                                               cfg_kw):
    """llama.forward under a mesh: each rank's rows and vocabulary block
    of the one-card logits; moe.hidden_states: its rows of the one-card
    hidden states and the one-card aux loss (f32, STEP_RTOL)."""
    from skypilot_tpu_torch.models import moe
    tree, tokens = _tree(kind, cfg_kw), _batches(1)[0][:, :-1]
    outs = pool4.run('forward_case', tree=tree, cfg_kw=cfg_kw, kind=kind,
                     mesh_kw=mesh_kw, tokens=tokens)
    cfg = _torch_ranks._cfg(kind, **cfg_kw)
    params = _torch_ranks._params(tree, cfg)
    with torch.no_grad():
        if kind == 'moe':
            want, aux = moe.hidden_states(params, torch.as_tensor(tokens),
                                          cfg)
        else:
            want = llama.forward(params, torch.as_tensor(tokens), cfg)
    for o in outs:
        block = want.numpy()[tuple(slice(a, b) for a, b in o['bounds'])]
        np.testing.assert_allclose(o['out'], block, rtol=STEP_RTOL,
                                   atol=STEP_RTOL)
        if kind == 'moe':
            assert o['aux'] == pytest.approx(float(aux), rel=STEP_RTOL)


def test_checkpoints_cross_mesh_shapes_and_packages(pool4, tmp_path):
    """fsdp 2 x tp 2 saves after 2 steps; the JAX Trainer and the
    port's one-card Trainer restore it bitwise; the one-card Trainer
    resumes a step and saves, the JAX Trainer does the same from the
    mesh's step, and fsdp 2 x tp 2 restores both bitwise."""
    tree = _tree('llama', CFG_KW)
    batches = _batches(4)
    mesh_kw = {'fsdp': 2, 'tp': 2}
    saved = pool4.run('ckpt_save_case', tree=tree, cfg_kw=CFG_KW,
                      kind='llama', mesh_kw=mesh_kw, tc_kw=TC,
                      batches=batches[:2], root=str(tmp_path / 'mesh'))[0]
    # The port on one card: restore, compare, resume one step, save.
    one = _torch_ranks.ckpt_save_case(
        tree, CFG_KW, 'llama', None, TC, [], None,
        restore_from=str(tmp_path / 'mesh'))
    assert one['step'] == 2
    for part in ('params', 'mu', 'nu'):
        for (k, g), (_, w) in zip(_leaves(one[part]), _leaves(saved[part])):
            assert np.array_equal(g, w), (part, k)
    resumed = _torch_ranks.ckpt_save_case(
        tree, CFG_KW, 'llama', None, TC, batches[2:3],
        str(tmp_path / 'one'), restore_from=str(tmp_path / 'mesh'))
    assert resumed['step'] == 3
    # The JAX Trainer restores the mesh's checkpoint bitwise.
    jcfg = _jax_cfg('llama', CFG_KW)
    jmesh = make_mesh(MeshConfig(fsdp=2, tp=2), devices=jax.devices()[:4])
    j_tr = j_trainer.Trainer(
        lambda p, b: j_llama.loss_fn(p, b, jcfg),
        jax.tree.map(jnp.asarray, tree), jmesh, j_sharding.LLAMA_RULES,
        j_trainer.TrainConfig(**TC))
    j_tr.restore_checkpoint(str(tmp_path / 'mesh'), 2)
    for (k, g), (_, w) in zip(_leaves(jax.tree.map(np.asarray,
                                                   j_tr.params)),
                              _leaves(saved['params'])):
        assert np.array_equal(g, w), k
    j_tr.run_step({'tokens': batches[2]})
    j_tr.save_checkpoint(str(tmp_path / 'jax'))
    j_params = jax.tree.map(np.asarray, j_tr.params)
    j_tr.close()
    # fsdp 2 x tp 2 restores both bitwise.
    for root, want in (('one', resumed['params']), ('jax', j_params)):
        back = pool4.run('ckpt_save_case', tree=tree, cfg_kw=CFG_KW,
                         kind='llama', mesh_kw=mesh_kw, tc_kw=TC,
                         batches=[], root=None,
                         restore_from=str(tmp_path / root))[0]
        assert back['restored'] == 3
        for (k, g), (_, w) in zip(_leaves(back['params']), _leaves(want)):
            assert np.array_equal(g, w), (root, k)


# ---- sharding helpers (one process) -----------------------------------------

def test_shard_and_gather_params_are_inverse_cuts():
    """On a one-rank mesh the blocks are the whole tree; the specs are
    LLAMA_RULES', the owner of each block is the one rank."""
    tree = _tree('llama', CFG_KW)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig())
    local = sharding.shard_params(tree, mesh, sharding.LLAMA_RULES)
    back = sharding.gather_params(local, mesh, sharding.LLAMA_RULES)
    for (k, g), (_, w) in zip(_leaves(back), _leaves(tree)):
        assert np.array_equal(g, w), k
    specs = sharding.param_shardings(tree, mesh, sharding.LLAMA_RULES)
    assert specs['embed'].spec == sharding.P('tp', 'fsdp')
    assert specs['layers']['ln1'].spec == sharding.P()
    assert all(s.owner for s in trainer.tree_leaves(specs))


@pytest.mark.parametrize('tied', [True, False])
def test_load_hf_model_sharded_takes_training_rules(pool4, tmp_path, tied):
    """A checkpoint read at fsdp 2 x tp 2 under LLAMA_RULES: every rank's
    blocks are bitwise the blocks shard_params cuts from the whole load,
    and the split leaves (embed, the head, the projections) are smaller
    than the whole."""
    import importlib.util
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    hf = dict(cs.QWEN25_1_5B, vocab_size=256, hidden_size=64,
              intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=2,
              tie_word_embeddings=tied)
    cs.write_hf_checkpoint(str(tmp_path), hf, lambda name, shape:
                           cs.draw_hf_tensor(name, shape, 0, torch.bfloat16,
                                             'cpu'), shard_bytes=40000)
    outs = pool4.run('hf_train_case', model_dir=str(tmp_path),
                     mesh_kw={'fsdp': 2, 'tp': 2})
    for o in outs:
        whole = dict(_leaves(o['whole']))
        for (k, g), (_, w) in zip(_leaves(o['got']), _leaves(o['want'])):
            assert g.dtype == w.dtype and np.array_equal(g, w), k
            if sharding.spec_axes(sharding.LLAMA_RULES.spec_for(k)):
                assert g.size < whole[k].size, k


def test_one_rank_mesh_trains_as_one_card():
    """A mesh of one rank: every collective is the identity, and the
    steps are the one-card Trainer's up to the order of the loss's
    sum."""
    tree, batches = _tree('llama', CFG_KW), _batches()
    got = _torch_ranks.train_case(tree, CFG_KW, 'llama', {'fsdp': 1}, TC,
                                  batches)
    one = _torch_ranks.train_case(tree, CFG_KW, 'llama', None, TC, batches)
    _hold(got, one, 'a one-rank mesh')


# ---- entry points as child processes ---------------------------------------

def _run(module, *args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_train_llama_on_a_mesh_saves_and_resumes(tmp_path):
    """--fsdp 2 --tp 2: 4 rank processes; the second run resumes the
    first's last step on the mesh."""
    common = ('--model-size', 'debug', '--device', 'cpu', '--seq-len', '16',
              '--batch-size', '2', '--checkpoint-every', '2',
              '--checkpoint-dir', str(tmp_path), '--fsdp', '2', '--tp', '2')
    first = _run('skypilot_tpu_torch.train.train_llama', *common,
                 '--steps', '2')
    assert first.returncode == 0, first.stderr[-3000:]
    assert first.stdout.startswith('device=cpu mesh(fsdp=2, tp=2) ranks=4')
    assert 'saved step 2' in first.stdout
    second = _run('skypilot_tpu_torch.train.train_llama', *common,
                  '--steps', '4', '--resume', 'auto')
    assert second.returncode == 0, second.stderr[-3000:]
    assert 'resumed from step 2' in second.stdout
    assert 'saved step 4' in second.stdout
    final = [line for line in second.stdout.splitlines()
             if line.startswith('final: loss=')]
    assert final and np.isfinite(float(final[0].split()[1][5:]))


def test_train_long_context_runs_the_ring():
    proc = _run('skypilot_tpu_torch.train.train_long_context', '--sp', '2',
                '--model-size', 'debug', '--device', 'cpu', '--seq-len',
                '64', '--steps', '3')
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.rstrip().splitlines()[-1]
    assert last.startswith('long-context OK: seq=64 sp=2 loss='), last
    assert np.isfinite(float(last.split('loss=')[1].split()[0]))


def test_allreduce_bench_prints_the_reference_keys():
    proc = _run('skypilot_tpu_torch.train.allreduce_bench', '--device',
                'cpu', '--ranks', '2', '--payload-mb', '1', '--iters', '2')
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ('payload_mb', 'ranks', 'time_s', 'algbw_gbps',
                'busbw_gbps'):
        assert key in result
    assert result['ranks'] == 2 and result['backend'] == 'gloo'
    assert result['busbw_gbps'] == pytest.approx(result['algbw_gbps'])


def test_mesh_config_follows_the_reference():
    from skypilot_tpu_torch.train import train_llama
    args = train_llama.parse_args(['--device', 'cpu', '--fsdp', '4'])
    assert train_llama.mesh_config(args, llama.LLAMA_DEBUG) == \
        mesh_lib.MeshConfig(fsdp=4)
    args = train_llama.parse_args(['--device', 'cpu'])
    assert train_llama.mesh_config(args, llama.LLAMA3_8B) == \
        mesh_lib.MeshConfig()
