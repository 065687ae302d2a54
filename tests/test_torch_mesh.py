"""The port's meshes and collectives (skypilot_tpu_torch/parallel) on the
CPU, held against the JAX package.

What must hold:
- the pure rules are the reference's: ``ici_order`` (the
  tests/test_mesh_decode.py cases, on stand-in devices with torus
  coordinates), ``chunk_bounds``, ``MeshConfig``/``auto_mesh_config``,
  and the specs of ``PartitionRules`` (LLAMA_RULES, MOE_RULES,
  INFER_TP_RULES) path for path over the JAX package's own trees;
- over 4 gloo rank processes, every collective is bitwise a sum or
  stack computed in one process: the gathers stack in mesh-rank order,
  ``ring_reduce_scatter`` sums in the ring's arrival order, and
  ``all_reduce_sum`` and ``pipelined_psum`` (1-4 chunks) sum
  rank 0 first, in f32 and bf16;
- ``make_tp_mesh`` lays dp outermost and the GQA overshard ('tpq')
  innermost, with one process group per set of axes.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import tp as j_tp  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.models import moe as j_moe  # noqa: E402
from skypilot_tpu.parallel import collectives as j_coll  # noqa: E402
from skypilot_tpu.parallel import mesh as j_mesh  # noqa: E402
from skypilot_tpu.parallel import sharding as j_sharding  # noqa: E402
from skypilot_tpu_torch.infer import tp as tp_lib  # noqa: E402
from skypilot_tpu_torch.parallel import collectives as coll  # noqa: E402
from skypilot_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from skypilot_tpu_torch.parallel import sharding  # noqa: E402

from _torch_ranks import RankPool  # noqa: E402


class FakeDev:
    """A device with torus coordinates and a core index."""

    def __init__(self, coords, core=0):
        self.coords = coords
        self.core_on_chip = core

    def __repr__(self):
        return f'FakeDev{self.coords}/{self.core_on_chip}'


def _grid(shape):
    import itertools
    return [FakeDev(c) for c in itertools.product(
        *[range(s) for s in reversed(shape)])]


@pytest.mark.parametrize('shape', [(2, 2), (3, 3), (4, 2), (2, 2, 2)])
def test_ici_order_matches_reference(shape):
    devs = _grid(shape)
    order = mesh_lib.ici_order(devs)
    assert order == j_mesh.ici_order(devs)
    # Consecutive ranks are torus neighbours (one hop).
    for a, b in zip(order, order[1:]):
        assert sum(abs(x - y) for x, y in zip(a.coords, b.coords)) == 1


def test_ici_order_megacore_tiebreak_and_no_coords():
    devs = [FakeDev((0, 0), 1), FakeDev((0, 0), 0), FakeDev((1, 0), 0),
            FakeDev((1, 0), 1)]
    assert mesh_lib.ici_order(devs) == j_mesh.ici_order(devs)
    plain = [object() for _ in range(4)]
    assert mesh_lib.ici_order(plain) == plain == j_mesh.ici_order(plain)
    dup = [FakeDev((0, 0)), FakeDev((0, 0))]
    assert mesh_lib.ici_order(dup) == dup
    assert mesh_lib.ici_order([3, 1, 2]) == [3, 1, 2]


@pytest.mark.parametrize('dim,chunks', [(64, 1), (64, 3), (10, 4), (3, 8),
                                        (4096, 12), (1, 2)])
def test_chunk_bounds_match_reference(dim, chunks):
    assert coll.chunk_bounds(dim, chunks) == j_coll.chunk_bounds(dim, chunks)
    assert coll._ring_perm(chunks) == j_coll._ring_perm(chunks)


@pytest.mark.parametrize('args', [(8, 8.0, 8192, 1), (16, 70.0, 8192, 1),
                                  (64, 405.0, 65536, 1), (32, 8.0, 4096, 4),
                                  (4, 1.0, 2048, 1)])
def test_mesh_config_and_auto_mesh_match_reference(args):
    got = mesh_lib.auto_mesh_config(*args)
    want = j_mesh.auto_mesh_config(*args)
    assert got.axis_sizes() == want.axis_sizes()
    assert str(got) == str(want)
    assert got.num_devices == want.num_devices == args[0]
    assert mesh_lib.AXES == j_mesh.AXES


def _spec_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _flat_specs(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict):
            out.update(_flat_specs(v, path))
        else:
            out[path] = _spec_tuple(v)
    return out


@pytest.mark.parametrize('which', ['llama', 'qwen', 'moe'])
@pytest.mark.parametrize('rules', ['LLAMA_RULES', 'MOE_RULES',
                                   'INFER_TP_RULES'])
def test_partition_rules_match_reference_path_for_path(which, rules):
    if which == 'moe':
        cfg = j_moe.MoeConfig(vocab_size=256, d_model=64, n_layers=2,
                              n_heads=8, n_kv_heads=4, d_ff=128,
                              n_experts=4, top_k=2, dtype=jnp.float32)
        tree = jax.eval_shape(lambda: j_moe.init_params(
            cfg, jax.random.PRNGKey(0)))
    else:
        cfg = j_llama.LlamaConfig(vocab_size=256, d_model=64, n_layers=2,
                                  n_heads=8, n_kv_heads=4, d_ff=128,
                                  attn_bias=which == 'qwen',
                                  dtype=jnp.float32)
        tree = jax.eval_shape(lambda: j_llama.init_params(
            cfg, jax.random.PRNGKey(0)))
    j_rules = (getattr(j_tp, rules) if rules == 'INFER_TP_RULES'
               else getattr(j_sharding, rules))
    p_rules = (getattr(tp_lib, rules) if rules == 'INFER_TP_RULES'
               else getattr(sharding, rules))
    want = jax.tree_util.tree_map_with_path(
        lambda path, _: _spec_tuple(j_rules.spec_for(
            '/'.join(j_sharding._key_str(k) for k in path))), tree)
    want = _flat_specs(want)
    shapes = jax.tree.map(lambda x: x.shape, tree)
    got = _flat_specs(p_rules.tree_specs(
        jax.tree.map(lambda x: None, shapes, is_leaf=lambda x: isinstance(
            x, tuple))))
    assert got == want
    assert len(got) >= 10


def test_tp_helpers_match_reference():
    for n_kv in (1, 2, 4, 8):
        cfg = j_llama.LlamaConfig(n_kv_heads=n_kv, n_heads=32)
        for tp in (1, 2, 4, 8):
            assert tp_lib.tp_factors(cfg, tp) == j_tp.tp_factors(cfg, tp)
            try:
                j_tp.validate_tp(cfg, tp)
                ok = None
            except ValueError as e:
                ok = str(e)
            if ok is None:
                tp_lib.validate_tp(cfg, tp)
            else:
                with pytest.raises(ValueError) as e:
                    tp_lib.validate_tp(cfg, tp)
                assert str(e.value) == ok
    assert tp_lib.CACHE_SPEC == _spec_tuple(j_tp.CACHE_SPEC)
    assert tp_lib.CACHE_SCALE_SPEC == _spec_tuple(j_tp.CACHE_SCALE_SPEC)
    assert tp_lib.POOL_ARENA_SPEC == _spec_tuple(j_tp.POOL_ARENA_SPEC)
    assert tp_lib.TABLE_SPEC == _spec_tuple(j_tp.TABLE_SPEC)


def test_int8_scale_spec_drops_the_input_axis():
    assert tp_lib.param_spec('layers/attn/wo/q') == (None, ('tp', 'tpq'),
                                                     None)
    assert tp_lib.param_spec('layers/attn/wo/s') == (None, None)
    assert tp_lib.param_spec('layers/attn/wq/s') == (None, ('tp', 'tpq'))
    assert tp_lib.param_spec('lm_head/s') == (('tp', 'tpq'),)


def test_single_rank_mesh_needs_no_process_group():
    mesh = mesh_lib.Mesh(np.zeros((1, 1), np.int64), ('tp', 'tpq'))
    assert mesh.size == 1 and mesh.group('tp') is None
    assert mesh.axis_index(('tp', 'tpq')) == 0
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(coll.ring_all_gather(x, mesh, 'tp'), x[None])
    red, res = coll.pipelined_psum(x, mesh, ('tp', 'tpq'), chunks=2,
                                   on_chunk=lambda c, lo, s: (c, lo))
    assert torch.equal(red, x) and res == [(0, 0), (1, 2)]
    with pytest.raises(RuntimeError, match='init_process_group'):
        mesh_lib.Mesh(np.arange(2).reshape(2, 1), ('tp', 'tpq'))


# ---- 4 gloo rank processes ---------------------------------------------------

@pytest.fixture(scope='module')
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _in_order(x, order):
    return [x[r] for r in order]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_collectives_bitwise_against_one_process(pool, dtype):
    outs = pool.run('collectives_case', seed=3, shape=(8, 10), dtype=dtype,
                    axes_sizes={'dp': 2, 'tp': 2}, chunks_list=[1, 2, 3, 4])
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(o['x']).to(tdt) for o in outs]
    coords = [tuple(o['coords']) for o in outs]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]

    def rank_at(c):
        return coords.index(c)

    for r, o in enumerate(outs):
        dp_i, tp_i = coords[r]
        fibers = {'dp': [rank_at((i, tp_i)) for i in range(2)],
                  'tp': [rank_at((dp_i, j)) for j in range(2)]}
        for ax, fiber in fibers.items():
            stack = torch.stack([xs[p] for p in fiber])
            got = torch.from_numpy(o[f'gather/{ax}']).to(tdt)
            assert torch.equal(got, stack), ax
            tiled = torch.from_numpy(o[f'gather_tiled/{ax}']).to(tdt)
            assert torch.equal(tiled, stack.reshape(-1, 10)), ax
            # ring order: d+1, d+2, ..., d.
            d, n, c = fiber.index(r), 2, 4
            acc = xs[fiber[(d + 1) % n]][d * c:(d + 1) * c]
            for t in range(2, n + 1):
                acc = acc + xs[fiber[(d + t) % n]][d * c:(d + 1) * c]
            got = torch.from_numpy(o[f'scatter/{ax}']).to(tdt)
            assert torch.equal(got, acc), ax
        acc = xs[0]
        for p in range(1, 4):
            acc = acc + xs[p]
        got = torch.from_numpy(o['allreduce']).to(tdt)
        assert torch.equal(got, acc)
        for c in (1, 2, 3, 4):
            assert torch.equal(torch.from_numpy(o[f'psum/{c}']).to(tdt), acc)
            bounds = coll.chunk_bounds(10, c)
            assert o[f'psum_chunks/{c}'] == [
                (i, lo, hi - lo) for i, (lo, hi) in enumerate(bounds)]


@pytest.mark.parametrize('tp,dp,n_kv,shape', [
    (4, 1, 4, {'tp': 4, 'tpq': 1}),
    (4, 1, 2, {'tp': 2, 'tpq': 2}),
    (2, 2, 4, {'dp': 2, 'tp': 2, 'tpq': 1}),
    (4, 1, 1, {'tp': 1, 'tpq': 4}),
])
def test_make_tp_mesh_layout(pool, tp, dp, n_kv, shape):
    outs = pool.run('mesh_case', tp=tp, dp=dp, n_kv_heads=n_kv)
    want = np.arange(4).reshape(tuple(shape.values()))
    for r, o in enumerate(outs):
        assert o['shape'] == shape
        assert tuple(np.argwhere(want == r)[0]) == tuple(o['coords'])
        block = r // tp
        assert o['fiber_model'] == list(range(block * tp, (block + 1) * tp))
        if dp > 1:
            assert o['fiber_dp'] == [r % tp + i * tp for i in range(dp)]
    # The reference lays its devices out the same way.
    j = j_tp.make_tp_mesh(tp, n_kv_heads=n_kv, devices=jax.devices()[:4],
                          dp=dp)
    assert dict(zip(j.axis_names, j.devices.shape)) == shape


@pytest.mark.parametrize('dp,fsdp,tp,slices', [
    (2, 1, 2, 1), (2, 1, 2, 2), (4, 1, 1, 2), (2, 2, 1, 2)])
def test_multislice_layout_matches_reference(pool, dp, fsdp, tp, slices):
    """dp spans the slices slice-major; fsdp and tp stay inside one."""
    outs = pool.run('layout_case', configs=[(dp, fsdp, tp, slices)])
    cfg = j_mesh.MeshConfig(dp=dp, fsdp=fsdp, tp=tp)
    devices = jax.devices()[:4]
    want = j_mesh.make_multislice_mesh(cfg, slices, devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(want.devices)
    for r, out in enumerate(outs):
        got = np.asarray(out[0]['ranks'])
        assert np.array_equal(got, ids)
        assert tuple(np.argwhere(got == r)[0]) == tuple(out[0]['coords'])
