"""Ring attention and the autograd collectives of the port's training
meshes (parallel/ring_attention.py, parallel/collectives.py) on the CPU,
held against the JAX package.

The port runs one gloo process a rank (tests/_torch_ranks.py, a pool of
4 started once); the JAX package runs ``ring_attention`` on its 8-device
CPU mesh.  What must hold, in f32:
- ring attention's output and its q/k/v gradients equal the JAX
  ``ring_attention``'s and full attention's (RING_TOL), causal and not,
  with GQA, over sp 4 and over sp 2 x tp 2 with heads over tp;
- where the KV heads do not divide over tp (replicated over it), the
  port equals full attention; the reference's per-shard repeat pairs a
  rank's query heads with the wrong KV heads there (ROADMAP Queue C),
  so that case is held against full attention only;
- each autograd collective's forward and backward are bitwise the
  stack, sum or block that the one process computes in flat mesh-rank
  order (rank 0 first), in f32 and bf16 (each sum in the inputs'
  dtype, as XLA's psum adds).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.ops import attention as j_attention  # noqa: E402
from skypilot_tpu.parallel import MeshConfig, make_mesh  # noqa: E402
from skypilot_tpu.parallel import ring_attention as j_ring  # noqa: E402

from _torch_ranks import RankPool  # noqa: E402

# f32 attention over 32 keys in blocks merged in another order than the
# one-pass softmax: a few f32 ulps of outputs and gradients of order 1.
RING_TOL = 2e-5
B, S, D = 2, 32, 16


@pytest.fixture(scope='module')
def pool4():
    p = RankPool(4)
    yield p
    p.close()


def _qkv(heads, kv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for shape in
            ((B, S, heads, D), (B, S, kv, D), (B, S, kv, D),
             (B, S, heads, D))]


def _assemble(outs, shape):
    """The global output from the ranks' blocks, and the global
    gradients as the sum of the ranks' shares."""
    full = np.full(shape, np.nan, np.float32)
    for o in outs:
        full[tuple(slice(a, b) for a, b in o['bounds'])] = o['out']
    grads = [sum(o['grads'][i] for o in outs) for i in range(3)]
    return full, grads


def _jax_out_and_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _full(q, k, v, do, causal):
    return _jax_out_and_grads(
        lambda a, b, c: j_attention.reference_attention(a, b, c,
                                                        causal=causal),
        q, k, v, do)


@pytest.mark.parametrize('mesh_kw,heads,kv,causal', [
    ({'sp': 4}, 4, 2, True),
    ({'sp': 4}, 4, 2, False),
    ({'sp': 2, 'tp': 2}, 8, 2, True),
    ({'sp': 2, 'tp': 2}, 8, 4, False),
    ({'dp': 2, 'sp': 2}, 4, 4, True),
])
def test_ring_attention_matches_jax_and_full(pool4, mesh_kw, heads, kv,
                                             causal):
    q, k, v, do = _qkv(heads, kv)
    head_axis = 'tp' if 'tp' in mesh_kw else None
    outs = pool4.run('ring_case', q=q, k=k, v=v, do=do, mesh_kw=mesh_kw,
                     causal=causal, head_axis=head_axis)
    got, grads = _assemble(outs, q.shape)
    mesh = make_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:4])
    want, want_grads = _jax_out_and_grads(
        lambda a, b, c: j_ring.ring_attention(
            a, b, c, mesh, axis_name='sp', causal=causal,
            head_axis=head_axis), q, k, v, do)
    full, full_grads = _full(q, k, v, do, causal)
    for ref, ref_grads in ((want, want_grads), (full, full_grads)):
        np.testing.assert_allclose(got, ref, atol=RING_TOL, rtol=RING_TOL)
        for g, w in zip(grads, ref_grads):
            np.testing.assert_allclose(g, w, atol=RING_TOL, rtol=RING_TOL)


def test_ring_attention_replicated_kv_heads_match_full(pool4):
    """8 query heads over 2 KV heads at tp 4 (sp 1): each rank's 2 query
    heads attend to the one KV head of their group, as full attention
    pairs them; the reference's repeat does not (its output is held here
    to differ from full attention by far more than the tolerance)."""
    q, k, v, do = _qkv(8, 2, seed=1)
    outs = pool4.run('ring_case', q=q, k=k, v=v, do=do,
                     mesh_kw={'tp': 4}, causal=True, head_axis='tp')
    got, grads = _assemble(outs, q.shape)
    full, full_grads = _full(q, k, v, do, True)
    np.testing.assert_allclose(got, full, atol=RING_TOL, rtol=RING_TOL)
    for g, w in zip(grads, full_grads):
        np.testing.assert_allclose(g, w, atol=RING_TOL, rtol=RING_TOL)
    mesh = make_mesh(MeshConfig(tp=4), devices=jax.devices()[:4])
    ref = np.asarray(j_ring.ring_attention(
        *(jnp.asarray(x) for x in (q, k, v)), mesh, head_axis='tp'))
    assert np.abs(ref - full).max() > 100 * RING_TOL


def _rank_order(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _sum(parts, dtype):
    """The port's combine: rank order, each add in `dtype`."""
    dt = getattr(torch, dtype)
    return _rank_order([torch.from_numpy(p).to(dt)
                        for p in parts]).float()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_autograd_collectives_are_rank_order_bitwise(pool4, dtype):
    """dp 2 x tp 2: rank r = 2 dp + tp.  Forward and backward of each
    collective against the one-process stack, sum or block."""
    outs = pool4.run('grad_collectives_case', seed=3, dtype=dtype)
    dt = getattr(torch, dtype)
    xs, cts = [], []
    for r in range(4):
        g = torch.Generator().manual_seed(3 + r)
        xs.append(torch.randn(4, 6, generator=g).to(dt).float().numpy())
        cts.append(torch.randn(8, 6, generator=g).to(dt).float().numpy())
    dp_fiber = {r: [r % 2, r % 2 + 2] for r in range(4)}
    tp_fiber = {r: [r - r % 2, r - r % 2 + 1] for r in range(4)}
    for o in outs:
        r = o['rank']
        res = {k: (torch.from_numpy(y), torch.from_numpy(g))
               for k, (y, g) in o['results'].items()}
        dp, tp = dp_fiber[r], tp_fiber[r]
        i_dp, i_tp = dp.index(r), tp.index(r)
        want = {
            'gather_scatter': (
                np.concatenate([xs[p] for p in dp]),
                _sum([cts[p][4 * i_dp:4 * i_dp + 4] for p in dp], dtype)),
            'gather_scatter_dim1': (
                np.concatenate([xs[p] for p in tp], axis=1),
                _sum([cts[p].reshape(4, 12)[:, 6 * i_tp:6 * i_tp + 6]
                      for p in tp], dtype)),
            'sum_forward': (_sum([xs[p] for p in range(4)], dtype),
                            cts[r][:4]),
            'sum_backward': (xs[r], _sum([cts[p][:4] for p in tp], dtype)),
            'split_gather': (
                xs[r][2 * i_dp:2 * i_dp + 2],
                np.concatenate([cts[p][:2] for p in dp])),
            'ring_permute': (xs[tp[(i_tp - 1) % 2]],
                             cts[tp[(i_tp + 1) % 2]][:4]),
        }
        for name, (wy, wg) in want.items():
            gy, gg = res[name]
            assert torch.equal(gy, torch.as_tensor(np.asarray(wy))), \
                (name, 'forward', r)
            assert torch.equal(gg, torch.as_tensor(np.asarray(wg))), \
                (name, 'backward', r)
