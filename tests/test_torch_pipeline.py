"""The port's GPipe pipeline on the CPU (parallel/pipeline.py,
llama.forward_pipelined, the mesh Trainer with a 'pp' axis), held
against the JAX package's forward_pipelined and against one card.

The port runs one gloo process a rank (tests/_torch_ranks.py, a pool of
4 started once); the JAX package runs the same mesh shape on 4 devices
of the 8-device CPU mesh.  What must hold, in f32 at small widths:
- stack_stages gives the reference's stage-major shapes and refuses a
  layer count that does not divide;
- pipeline_apply on a plain stage function gives the sequential result
  and gradients, with fewer, as many or more microbatches than stages;
- forward_pipelined at pp 2 x dp 2, pp 4 and pp 2 x sp 2 gives each
  rank's block of the JAX forward_pipelined logits (FWD_TOL);
- loss_fn(forward_fn=forward_pipelined) and every gradient, summed over
  the data axes as the Trainer sums them, equal JAX's value_and_grad
  (GRAD_REL of each leaf's largest element) at pp 2 x dp 2, pp 2 x
  fsdp 2, pp 2 x tp 2 and pp 2 x sp 2, and every rank holds them;
- 3 Trainer steps at pp 2 x dp 2 and pp 2 x sp 2 equal the port's
  one-card Trainer (losses and grad norms within STEP_RTOL);
- on a one-rank mesh forward_pipelined is forward(), through the
  attention_fn it is given.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.parallel import MeshConfig, make_mesh  # noqa: E402
from skypilot_tpu.parallel import pipeline as j_pipeline  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.parallel import pipeline  # noqa: E402
from skypilot_tpu_torch.train import trainer  # noqa: E402

import _torch_ranks  # noqa: E402
from _torch_ranks import RankPool  # noqa: E402

CFG_KW = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=128, remat=True)
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4)
# f32 sums in another order (microbatches, shards, the ring's online
# softmax, the vocabulary-parallel logsumexp).
FWD_TOL = 1e-5
GRAD_REL = 1e-5
STEP_RTOL = 1e-5


@pytest.fixture(scope='module')
def pool4():
    p = RankPool(4)
    yield p
    p.close()


def _tree(seed=0):
    cfg = _torch_ranks._cfg('llama', **CFG_KW)
    return _torch_ranks._tree_np(
        llama.init_params(cfg, torch.Generator().manual_seed(seed), 'cpu'))


def _tokens(batch=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG_KW['vocab_size'], (batch, seq + 1),
                        dtype=np.int32)


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{prefix}/{k}')
    else:
        yield prefix, np.asarray(tree)


def _jax_mesh(mesh_kw):
    n = int(np.prod(list(mesh_kw.values())))
    return make_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:n])


def _jax_fwd(mesh, sequence_axis):
    return lambda p, t, c: j_llama.forward_pipelined(
        p, t, c, mesh=mesh, num_microbatches=2, sequence_axis=sequence_axis)


def test_stack_stages_matches_the_reference():
    tree = _tree()
    got = pipeline.stack_stages(_torch_ranks._params(
        tree, _torch_ranks._cfg('llama', **CFG_KW))['layers'], 2)
    want = j_pipeline.stack_stages(
        jax.tree.map(jnp.asarray, tree['layers']), 2)
    for (k, g), (_, w) in zip(_leaves(trainer.tree_map(
            lambda x: x.numpy(), got)), _leaves(want)):
        assert g.shape == w.shape and np.array_equal(g, w), k
    assert got['attn']['wq']._base is not None   # a view
    with pytest.raises(AssertionError):
        pipeline.stack_stages(got, 3)


@pytest.mark.parametrize('mesh_kw,num_microbatches', [
    ({'pp': 4}, 4), ({'pp': 2, 'dp': 2}, 8), ({'pp': 2, 'tp': 2}, 2)],
    ids=['pp4-m4', 'pp2-dp2-m8', 'pp2-tp2-m2'])
def test_pipeline_apply_is_the_sequential_stack(pool4, mesh_kw,
                                                num_microbatches):
    """A plain stage function (4 elementwise layers split over the
    stages) over 4 or 2 stages, with fewer, as many or more microbatches
    than stages: the output and the gradients of h and of every stage's
    parameters are the sequential ones (f32, FWD_TOL), on every rank."""
    outs = pool4.run('pipeline_apply_case', mesh_kw=mesh_kw,
                     num_microbatches=num_microbatches, seed=3)
    want = _torch_ranks.pipeline_apply_case(None, num_microbatches, 3)
    for o in outs:
        for key in ('out', 'grad_h', 'grad_w'):
            np.testing.assert_allclose(o[key], want[key], rtol=FWD_TOL,
                                       atol=FWD_TOL, err_msg=key)


FORWARD_MESHES = [({'pp': 2, 'dp': 2}, None), ({'pp': 4}, None),
                  ({'pp': 2, 'sp': 2}, 'sp')]


@pytest.fixture(scope='module')
def pp_runs(pool4):
    """The port's pipeline_case on every mesh of the forward and
    gradient tests (one pool run each), and the one-card gradient."""
    tree, tokens = _tree(), _tokens()
    meshes = FORWARD_MESHES + [({'pp': 2, 'fsdp': 2}, None),
                               ({'pp': 2, 'tp': 2}, None)]
    runs = {}
    for mesh_kw, seq_axis in meshes:
        runs[repr(mesh_kw)] = pool4.run(
            'pipeline_case', tree=tree, cfg_kw=CFG_KW, mesh_kw=mesh_kw,
            tokens=tokens, num_microbatches=2, sequence_axis=seq_axis)
    return tree, tokens, runs


@pytest.mark.parametrize('mesh_kw,seq_axis', FORWARD_MESHES,
                         ids=['pp2-dp2', 'pp4', 'pp2-sp2'])
def test_forward_pipelined_matches_jax(pp_runs, mesh_kw, seq_axis):
    tree, tokens, runs = pp_runs
    jcfg = j_llama.LlamaConfig(**dict(CFG_KW, dtype=jnp.float32))
    mesh = _jax_mesh(mesh_kw)
    want = np.asarray(jax.jit(_jax_fwd(mesh, seq_axis), static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens[:, :-1]), jcfg))
    for o in runs[repr(mesh_kw)]:
        block = want[tuple(slice(a, b) for a, b in o['bounds'])]
        np.testing.assert_allclose(o['out'], block, rtol=FWD_TOL,
                                   atol=FWD_TOL)


@pytest.mark.parametrize('mesh_kw,seq_axis', FORWARD_MESHES[:1] + [
    ({'pp': 2, 'fsdp': 2}, None), ({'pp': 2, 'tp': 2}, None),
    FORWARD_MESHES[2]], ids=['pp2-dp2', 'pp2-fsdp2', 'pp2-tp2', 'pp2-sp2'])
def test_pipelined_loss_and_gradients_match_jax(pp_runs, mesh_kw,
                                                seq_axis):
    """JAX value_and_grad of loss_fn(forward_fn=forward_pipelined) on the
    same mesh shape (which equals the sequential gradient) against the
    port's, every leaf summed over the data axes as the Trainer sums it,
    no leaf counted twice over pp."""
    tree, tokens, runs = pp_runs
    jcfg = j_llama.LlamaConfig(**dict(CFG_KW, dtype=jnp.float32))
    fwd = _jax_fwd(_jax_mesh(mesh_kw), seq_axis)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_llama.loss_fn(p, b, jcfg, forward_fn=fwd)))(
        jax.tree.map(jnp.asarray, tree), {'tokens': jnp.asarray(tokens)})
    outs = runs[repr(mesh_kw)]
    for o in outs:
        assert o['loss'] == outs[0]['loss']
        assert o['loss'] == pytest.approx(float(loss), rel=GRAD_REL)
        for (k, g), (_, w) in zip(_leaves(o['grads']),
                                  _leaves(jax.tree.map(np.asarray, grads))):
            assert g.shape == w.shape, k
            err = np.abs(g - w).max()
            assert err <= GRAD_REL * np.abs(w).max(), (mesh_kw, k, err)


@pytest.mark.parametrize('mesh_kw,seq_axis', [({'pp': 2, 'dp': 2}, None),
                                              ({'pp': 2, 'sp': 2}, 'sp')],
                         ids=['pp2-dp2', 'pp2-sp2'])
def test_pp_trainer_matches_one_card(pool4, mesh_kw, seq_axis):
    """3 steps of the mesh Trainer on the pipelined loss against the
    port's one-card Trainer: losses and grad norms within STEP_RTOL,
    the same bits on every rank, and the parameters after within
    test_torch_train_mesh's tolerance."""
    tree = _tree()
    batches = [_tokens(seed=s) for s in range(3)]
    outs = pool4.run('pp_train_case', tree=tree, cfg_kw=CFG_KW,
                     mesh_kw=mesh_kw, tc_kw=TC, batches=batches,
                     num_microbatches=2, sequence_axis=seq_axis)
    for o in outs[1:]:
        assert o['bits'] == outs[0]['bits']
    one = _torch_ranks.train_case(tree, CFG_KW, 'llama', None, TC, batches)
    for key in ('loss', 'grad_norm'):
        np.testing.assert_allclose(outs[0][key], one[key], rtol=STEP_RTOL,
                                   err_msg=key)
    schedule = trainer.make_optimizer(trainer.TrainConfig(**TC)).schedule
    atol = 2 * sum(schedule(i) for i in range(3))
    for (k, g), (_, w) in zip(_leaves(outs[0]['params']),
                              _leaves(one['params'])):
        err = np.abs(g - w)
        assert err.max() <= atol, (k, err.max())
        assert (err <= 1e-6).mean() > 0.99, k


def test_forward_pipelined_needs_the_sequence_axis_under_sp(pool4):
    msgs = pool4.run('pp_sp_refused_case', cfg_kw=CFG_KW)
    assert all("sequence_axis='sp'" in m for m in msgs), msgs


def test_loss_fn_takes_forward_fn_on_one_card():
    """loss_fn(forward_fn=forward) on one card is loss_fn itself."""
    cfg = _torch_ranks._cfg('llama', **CFG_KW)
    params = _torch_ranks._params(_tree(), cfg)
    batch = {'tokens': torch.as_tensor(_tokens())}
    with torch.no_grad():
        got = llama.loss_fn(params, batch, cfg, forward_fn=llama.forward)
        want = llama.loss_fn(params, batch, cfg)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_forward_pipelined_on_one_rank_takes_attention_fn():
    """A one-rank mesh (pp 1) runs the stack as one stage: the logits of
    forward() on one card, through the attention_fn it is given."""
    from skypilot_tpu_torch.ops import attention as attention_ops
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = _torch_ranks._cfg('llama', **CFG_KW)
    params = _torch_ranks._params(_tree(), cfg)
    tokens = torch.as_tensor(_tokens()[:, :-1])
    calls = []

    def attend(q, k, v):
        calls.append(q.shape)
        return attention_ops.flash_attention(q, k, v, causal=True)
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig())
    with torch.no_grad():
        got = llama.forward_pipelined(params, tokens, cfg, mesh=mesh,
                                      num_microbatches=1,
                                      attention_fn=attend)
        want = llama.forward(params, tokens, cfg)
    assert len(calls) == CFG_KW['n_layers']
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)
