"""Tensor-parallel serving of the port (infer/tp.py, the sharded pooled
steps of infer/llama_infer.py, Generator and ContinuousBatcher with
``mesh=``) on the CPU, held against the JAX package.

The port runs one gloo process a rank (tests/_torch_ranks.py, two pools
of 2 and 4 ranks started once); the JAX package runs its GSPMD mesh on
the 8-device CPU mesh of tests/conftest.py.  At the reference's test
config (f32, 8 heads over 4 KV heads, tests/test_mesh_decode.py) what
must hold:
- greedy tokens at tp=2, tp=4, dp=2 x tp=2 and the GQA overshard (2 KV
  heads at tp=4) equal the JAX Generator's with make_tp_mesh and
  without a mesh, and the prefill logits agree to 1e-4 (f32; the
  partial products round per shard);
- the same for the batcher, for speculative verify, the fused step,
  int8 KV, int8 weights (quantized before the cut) and MoE at tp=2;
- the overlapped combines at 2, 3 and 4 chunks sum bitwise as the
  synchronous path does, and give its greedy tokens and the JAX overlap
  path's; the last hidden states agree to OVERLAP_ATOL (the factorised
  norm rounds its products differently from K3 and whole products);
- init_sharded_params' blocks put together are the full init, and
  load_hf_model_sharded's blocks are load_hf_model's, sliced;
- graphs=True under a gloo mesh on a card raises with the reason, and
  set_collective_share moves time into the 'collective' phase;
- the legacy planes ('paged' with K7's plain version per shard,
  'inplace', 'scan', 'unroll'; head_dim 128, which the JAX 'paged'
  kernel needs) at tp=2, tp=4 and dp=2 x tp=2: the Generator's greedy
  tokens equal the JAX mesh Generator's and the JAX Generator's without
  a mesh, over an f32 and an int8 cache, with the slot cache migrated
  between buckets; the batcher's (chunked prefill, the prefix cache)
  equal the JAX batcher's; a bf16 model gives every rank the same
  tokens and the prefill logits within BF16_LOGITS_ATOL of tp 1's.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import llama_infer as j_llama_infer  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.infer import tp as j_tp  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.models import moe as j_moe  # noqa: E402
from skypilot_tpu_torch.infer import tp as tp_lib  # noqa: E402
from skypilot_tpu_torch.models import llama, moe  # noqa: E402
from skypilot_tpu_torch.parallel import sharding  # noqa: E402

from _torch_ranks import RankPool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=8,
              n_kv_heads=4, d_ff=128, max_seq_len=128, remat=False)
GEN_KW = dict(max_seq_len=64, batch_size=2, temperature=0.0,
              prompt_buckets=[16])
PROMPTS = [[5, 9, 2, 7], [11, 3]]
LOGITS_ATOL = 1e-4


@pytest.fixture(scope='module')
def pool2():
    p = RankPool(2)
    yield p
    p.close()


@pytest.fixture(scope='module')
def pool4():
    p = RankPool(4)
    yield p
    p.close()


def _jax_cfg(kind='llama', **kw):
    kw = dict(CFG_KW, **kw)
    if kind == 'moe':
        return j_moe.MoeConfig(dtype=jnp.float32, **kw)
    return j_llama.LlamaConfig(dtype=jnp.float32, **kw)


def _jax_params(cfg, seed=1, kind='llama'):
    init = j_moe.init_params if kind == 'moe' else j_llama.init_params
    return init(cfg, jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _jax_generate(p, cfg, gen_kw, mesh=None, prompts=PROMPTS, n=12):
    return j_engine.Generator(p, cfg, j_engine.GeneratorConfig(**gen_kw),
                              mesh=mesh).generate(prompts, max_new_tokens=n)


def _jax_prefill_logits(p, cfg, prompts=PROMPTS):
    bucket = max(len(q) for q in prompts)
    tokens = np.zeros((len(prompts), bucket), np.int32)
    for i, q in enumerate(prompts):
        tokens[i, :len(q)] = q
    cache = j_llama_infer.init_cache(cfg, len(prompts), bucket)
    logits, _ = j_llama_infer.prefill(
        p, jnp.asarray(tokens), cfg, cache,
        jnp.asarray([len(q) for q in prompts], jnp.int32))
    return np.asarray(logits)


def _jax_batcher(p, cfg, gen_kw, requests, mesh=None, decode_chunk=8):
    b = j_serving.ContinuousBatcher(p, cfg, j_engine.GeneratorConfig(**gen_kw),
                                    decode_chunk=decode_chunk, mesh=mesh)
    rids = [b.submit(list(q), max_new_tokens=n) for q, n in requests]
    b.run_until_idle()
    return [b.result(r) for r in rids]


def _all_equal(outs, key):
    first = outs[0][key]
    for o in outs[1:]:
        assert o[key] == first, 'ranks disagree'
    return first


# ---- Generator -----------------------------------------------------------------

@pytest.mark.parametrize('tp,dp,n_kv,world', [
    (2, 1, 4, 2), (4, 1, 4, 4), (2, 2, 4, 4), (4, 1, 2, 4),
], ids=['tp2', 'tp4', 'dp2xtp2', 'tp4-overshard'])
def test_generator_mesh_parity_with_jax(pool2, pool4, tp, dp, n_kv, world):
    pool = pool2 if world == 2 else pool4
    cfg = _jax_cfg(n_kv_heads=n_kv)
    p = _jax_params(cfg)
    base = _jax_generate(p, cfg, GEN_KW)
    jmesh = j_tp.make_tp_mesh(tp, n_kv_heads=n_kv,
                              devices=jax.devices()[:tp * dp], dp=dp)
    assert _jax_generate(p, cfg, GEN_KW, jmesh) == base
    outs = pool.run('generate_case', tree=_np_tree(p),
                    cfg_kw=dict(CFG_KW, n_kv_heads=n_kv), kind='llama',
                    gen_kw=GEN_KW, tp=tp, dp=dp, prompts=PROMPTS,
                    max_new=12)
    assert _all_equal(outs, 'tokens') == base
    want = _jax_prefill_logits(p, cfg)
    for o in outs:
        np.testing.assert_allclose(o['logits'], want, atol=LOGITS_ATOL,
                                   rtol=0)
        assert np.array_equal(o['logits'], outs[0]['logits'])
    # Each rank holds its heads only: wq (L, d, heads / (tp x tpq) * hd).
    tp_kv = min(tp, n_kv)
    hd = CFG_KW['d_model'] // CFG_KW['n_heads']
    assert outs[0]['shapes']['wq'] == (2, 64, 8 // tp * hd)
    assert outs[0]['shapes']['wk'] == (2, 64, n_kv // tp_kv * hd)


def test_generator_takes_pre_cut_shards(pool2):
    cfg = _jax_cfg()
    p = _jax_params(cfg)
    outs = pool2.run('generate_case', tree=_np_tree(p), cfg_kw=CFG_KW,
                     kind='llama', gen_kw=GEN_KW, tp=2, dp=1,
                     prompts=PROMPTS, max_new=8, shards=True)
    assert _all_equal(outs, 'tokens') == _jax_generate(p, cfg, GEN_KW, n=8)


def test_moe_generator_tp2_parity(pool2):
    kw = dict(n_experts=4, top_k=2, router_impl='dense')
    cfg = _jax_cfg('moe', **kw)
    p = _jax_params(cfg, seed=2, kind='moe')
    base = _jax_generate(p, cfg, GEN_KW, n=10)
    outs = pool2.run('generate_case', tree=_np_tree(p),
                     cfg_kw=dict(CFG_KW, **kw), kind='moe', gen_kw=GEN_KW,
                     tp=2, dp=1, prompts=PROMPTS, max_new=10)
    assert _all_equal(outs, 'tokens') == base
    assert outs[0]['overlap'] is None   # MoE: the synchronous path
    for o in outs:
        np.testing.assert_allclose(o['logits'], _jax_prefill_logits(p, cfg),
                                   atol=LOGITS_ATOL, rtol=0)


# ---- ContinuousBatcher -----------------------------------------------------------

REQUESTS = [([5, 9, 2, 7], 10), ([11, 3], 10), ([7, 7, 1], 6)]
LONG = list(range(2, 26))


@pytest.mark.parametrize('case', [
    dict(tp=4, dp=1, n_kv=4),
    dict(tp=2, dp=2, n_kv=4),
    dict(tp=4, dp=1, n_kv=2),
    dict(tp=4, dp=1, n_kv=4, gen=dict(spec_k=2)),
    dict(tp=2, dp=2, n_kv=4, gen=dict(batch_size=4, prompt_buckets=[8, 32],
                                      prefill_chunk=8, fuse_budget=6)),
    dict(tp=4, dp=1, n_kv=4, gen=dict(kv_cache_dtype='int8')),
    dict(tp=4, dp=1, n_kv=4, gen=dict(weights_dtype='int8')),
    dict(tp=4, dp=1, n_kv=4, gen=dict(prefill_chunk=8,
                                      prompt_buckets=[8, 32])),
], ids=['tp4', 'dp2xtp2', 'overshard', 'spec', 'fused', 'int8kv',
        'int8w', 'chunked'])
def test_batcher_mesh_parity_with_jax(pool4, case):
    cfg = _jax_cfg(n_kv_heads=case['n_kv'])
    p = _jax_params(cfg)
    gen_kw = dict(GEN_KW, **case.get('gen', {}))
    requests = list(REQUESTS)
    if 'prefill_chunk' in gen_kw:
        requests.append((LONG, 6))
    base = _jax_batcher(p, cfg, gen_kw, requests)
    outs = pool4.run('batcher_case', tree=_np_tree(p),
                     cfg_kw=dict(CFG_KW, n_kv_heads=case['n_kv']),
                     kind='llama', gen_kw=gen_kw, tp=case['tp'],
                     dp=case['dp'], requests=requests)
    assert _all_equal(outs, 'results') == base
    assert all(len(r) == n for r, (_, n) in zip(base, requests))
    if gen_kw.get('fuse_budget'):
        assert outs[0]['fused_steps'] > 0
    if gen_kw.get('spec_k'):
        assert outs[0]['spec_proposed'] > 0
    # d_model 64: one chunk of >= 256 columns, so the synchronous path.
    assert outs[0]['overlap'] is None


def test_batcher_mesh_matches_jax_mesh_and_moe(pool2):
    cfg = _jax_cfg()
    p = _jax_params(cfg)
    jmesh = j_tp.make_tp_mesh(2, n_kv_heads=4, devices=jax.devices()[:2])
    want = _jax_batcher(p, cfg, GEN_KW, REQUESTS, mesh=jmesh)
    assert want == _jax_batcher(p, cfg, GEN_KW, REQUESTS)
    outs = pool2.run('batcher_case', tree=_np_tree(p), cfg_kw=CFG_KW,
                     kind='llama', gen_kw=GEN_KW, tp=2, dp=1,
                     requests=REQUESTS)
    assert _all_equal(outs, 'results') == want
    kw = dict(n_experts=4, top_k=2, router_impl='dense')
    mcfg = _jax_cfg('moe', **kw)
    mp = _jax_params(mcfg, seed=2, kind='moe')
    outs = pool2.run('batcher_case', tree=_np_tree(mp),
                     cfg_kw=dict(CFG_KW, **kw), kind='moe', gen_kw=GEN_KW,
                     tp=2, dp=1, requests=REQUESTS)
    assert _all_equal(outs, 'results') == _jax_batcher(mp, mcfg, GEN_KW,
                                                       REQUESTS)


# ---- overlapped combines ----------------------------------------------------------

# The overlapped path's last hidden states against the synchronous
# path's, f32: the factorised norm ((x * g) @ W summed over f32 span
# products, the rsqrt last) rounds differently from K3 then one product.
OVERLAP_ATOL = 1e-5


def test_combine_then_project_sums_bitwise(pool4):
    outs = pool4.run('combine_project_case', seed=3, rows=8, d_model=64,
                     widths=[32, 16, 16], chunks_list=[2, 3, 4])
    for o in outs:
        assert np.array_equal(o['sync']['h'], outs[0]['sync']['h'])
        for c in (2, 3, 4):
            # The combine itself: bitwise the synchronous sum.
            assert np.array_equal(o[c]['h'], o['sync']['h']), c
            for y, want in zip(o[c]['y'], o['sync']['y']):
                np.testing.assert_allclose(y, want, atol=OVERLAP_ATOL,
                                           rtol=0)


@pytest.mark.parametrize('tp,dp', [(4, 1), (2, 2)], ids=['tp4', 'dp2xtp2'])
def test_overlap_chunks_give_the_sync_tokens(pool4, tp, dp):
    cfg = _jax_cfg()
    p = _jax_params(cfg)
    outs = pool4.run('overlap_case', tree=_np_tree(p), cfg_kw=CFG_KW,
                     gen_kw=GEN_KW, tp=tp, dp=dp, prompts=PROMPTS,
                     max_new=12, chunks=[1, 2, 3, 4])
    sync = outs[0][1]
    assert sync['overlap'] is None
    for o in outs:
        # Hidden rows are the rank's dp replica's: each rank against its
        # own synchronous run.
        own = o[1]
        for c in (2, 3, 4):
            run = o[c]
            assert run['overlap'] == c
            assert run['tokens'] == sync['tokens'], c
            assert len(run['hidden']) == len(own['hidden']) > 3
            for a, b in zip(run['hidden'], own['hidden']):
                np.testing.assert_allclose(a, b, atol=OVERLAP_ATOL, rtol=0)
    base = _jax_generate(p, cfg, GEN_KW)
    assert sync['tokens'] == base
    if dp > 1:   # the JAX overlap path: once, at tp 4
        return
    jmesh = j_tp.make_tp_mesh(tp, n_kv_heads=4, devices=jax.devices()[:tp])
    for c in (2, 3, 4):
        ovl = _jax_generate(p, cfg, dict(GEN_KW, overlap_collectives=True,
                                         overlap_chunks=c), jmesh)
        assert ovl == sync['tokens'], c


def test_batcher_overlap_agrees_with_jax(pool4):
    cfg = _jax_cfg()
    p = _jax_params(cfg)
    fuse = dict(GEN_KW, batch_size=4, prompt_buckets=[8, 32],
                prefill_chunk=8, fuse_budget=6, spec_k=2,
                overlap_collectives=True, overlap_chunks=2)
    requests = REQUESTS + [(LONG, 6)]
    outs = pool4.run('batcher_case', tree=_np_tree(p), cfg_kw=CFG_KW,
                     kind='llama', gen_kw=fuse, tp=4, dp=1,
                     requests=requests)
    got = _all_equal(outs, 'results')
    assert outs[0]['overlap'] == 2 and outs[0]['fused_steps'] > 0
    base = dict(fuse, overlap_collectives=None, overlap_chunks=None)
    assert got == _jax_batcher(p, cfg, base, requests)


# ---- shards ---------------------------------------------------------------------

@pytest.mark.parametrize('kind,tp,n_kv,world', [
    ('llama', 2, 4, 2), ('llama', 4, 2, 4), ('moe', 2, 4, 2)],
    ids=['tp2', 'overshard', 'moe'])
def test_init_sharded_params_blocks_make_the_full_init(pool2, pool4, kind,
                                                       tp, n_kv, world):
    pool = pool2 if world == 2 else pool4
    kw = dict(CFG_KW, n_kv_heads=n_kv, attn_bias=kind == 'llama')
    if kind == 'moe':
        kw = dict(CFG_KW, n_experts=4, top_k=2, router_impl='dense')
        cfg = moe.MoeConfig(dtype=torch.float32, **kw)
        full = moe.init_params(cfg, torch.Generator().manual_seed(7), 'cpu')
    else:
        cfg = llama.LlamaConfig(dtype=torch.float32, **kw)
        full = llama.init_params(cfg, torch.Generator().manual_seed(7),
                                 'cpu')
    outs = pool.run('init_case', cfg_kw=kw, kind=kind, seed=7, tp=tp,
                    n_kv_heads=n_kv)
    tp_kv = min(tp, n_kv)
    tpq = tp // tp_kv

    def check(node, path, blocks):
        if isinstance(node, dict):
            for k in node:
                check(node[k], f'{path}/{k}' if path else k,
                      [b[k] for b in blocks])
            return
        spec = tp_lib.param_spec(path)
        full_np = node.numpy()
        for r, blk in enumerate(blocks):
            coords = {'tp': r // tpq, 'tpq': r % tpq}
            sizes = {'tp': tp_kv, 'tpq': tpq}
            index = []
            for dim, size in enumerate(full_np.shape):
                entry = spec[dim] if dim < len(spec) else None
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                n, i = 1, 0
                for a in axes:
                    n, i = n * sizes[a], i * sizes[a] + coords[a]
                step = size // n
                index.append(slice(i * step, (i + 1) * step))
            want = full_np[tuple(index)]
            assert blk.shape == want.shape, path
            assert np.array_equal(blk, want), path
            assert blk.shape == sharding.local_shape(
                spec, full_np.shape, _FakeMesh(coords, sizes)), path
    check(full, '', outs)


class _FakeMesh:
    def __init__(self, coords, sizes):
        self._c, self._s = coords, sizes

    def axis_size(self, axes):
        return int(np.prod([self._s.get(a, 1) for a in axes]))

    def axis_index(self, axes):
        i = 0
        for a in axes:
            i = i * self._s.get(a, 1) + self._c.get(a, 0)
        return i


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize('tied', [True, False])
def test_load_hf_model_sharded_is_load_hf_model_sliced(pool2, tmp_path,
                                                       tied):
    from skypilot_tpu_torch.models import convert
    cs = _chip_smoke()
    hf = dict(cs.QWEN25_1_5B, vocab_size=256, hidden_size=64,
              intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=2,
              tie_word_embeddings=tied)
    cs.write_hf_checkpoint(str(tmp_path), hf, lambda name, shape:
                           cs.draw_hf_tensor(name, shape, 0, torch.bfloat16,
                                             'cpu'), shard_bytes=40000)
    full, cfg = convert.load_hf_model(str(tmp_path), device='cpu')
    outs = pool2.run('hf_case', model_dir=str(tmp_path), tp=2,
                     n_kv_heads=2)

    def check(node, path, blocks):
        if isinstance(node, dict):
            for k in node:
                check(node[k], f'{path}/{k}' if path else k,
                      [b[k] for b in blocks])
            return
        spec = tp_lib.param_spec(path)
        for r, blk in enumerate(blocks):
            mesh = _FakeMesh({'tp': r}, {'tp': 2})
            want = sharding.shard_tensor(node, spec, mesh).float().numpy()
            assert blk.shape == want.shape, path
            assert np.array_equal(blk, want), path
            if any(e is not None for e in spec):
                assert blk.size < node.numel(), path
    check(full, '', [o['params'] for o in outs])
    assert outs[0]['n_layers'] == 2


# ---- graphs and telemetry ---------------------------------------------------------

def test_graphs_under_gloo_mesh_raise_with_the_reason(pool2):
    out = pool2.run('graphs_case')[0]
    assert 'gloo' in out['cuda'] and 'cannot' in out['cuda']
    assert out['cuda_nomesh'] is None


def test_collective_share_moves_time_to_the_collective_phase(pool2):
    cfg = _jax_cfg()
    p = _jax_params(cfg)
    outs = pool2.run('collective_share_case', tree=_np_tree(p),
                     cfg_kw=CFG_KW, gen_kw=GEN_KW, tp=2, share=0.5)
    for o in outs:
        assert o['collective'] > 0
        assert o['counter'] == pytest.approx(o['collective'])
        assert o['devices'] == {'tp': 2, 'tpq': 1}
        assert o['per_shard'] is not None and o['per_shard'] >= 0
        assert len(o['result']) == 6


# ---- the legacy planes under a mesh ------------------------------------------------

LEGACY_KW = dict(CFG_KW, head_dim_override=128)
LEGACY_GEN = dict(max_seq_len=128, batch_size=2, temperature=0.0,
                  prompt_buckets=[16, 64], decode_chunk=4)
LEGACY_PROMPTS = [[5, 9, 2, 7], [11, 3] * 20]
# bf16 prefill logits of a mesh against tp 1: each shard rounds its
# partial products to bf16 before the combine.
BF16_LOGITS_ATOL = 0.05


def _legacy_jax(gen_kw, tp, dp, n=30):
    import warnings
    cfg = _jax_cfg(head_dim_override=128)
    p = _jax_params(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        base = _jax_generate(p, cfg, gen_kw, prompts=LEGACY_PROMPTS, n=n)
        jmesh = j_tp.make_tp_mesh(tp, n_kv_heads=4,
                                  devices=jax.devices()[:tp * dp], dp=dp)
        got = _jax_generate(p, cfg, gen_kw, jmesh, prompts=LEGACY_PROMPTS,
                            n=n)
    return p, base, got


@pytest.mark.parametrize('plane,tp,dp,kv', [
    ('paged', 2, 1, None), ('paged', 4, 1, None), ('paged', 2, 2, None),
    ('paged', 2, 1, 'int8'), ('inplace', 2, 1, None),
    ('inplace', 4, 1, 'int8'), ('inplace', 2, 2, None), ('scan', 2, 1, None),
    ('unroll', 4, 1, None)],
    ids=['paged-tp2', 'paged-tp4', 'paged-dp2xtp2', 'paged-tp2-int8',
         'inplace-tp2', 'inplace-tp4-int8', 'inplace-dp2xtp2', 'scan-tp2',
         'unroll-tp4'])
def test_legacy_generator_mesh_parity_with_jax(pool2, pool4, plane, tp, dp,
                                               kv):
    """30 greedy tokens after a 40-token prompt cross the 64-row bucket:
    the slot cache of every rank migrates, as one card's does."""
    gen_kw = dict(LEGACY_GEN, decode_impl=plane, kv_cache_dtype=kv)
    p, base, jax_mesh = _legacy_jax(gen_kw, tp, dp)
    assert jax_mesh == base
    outs = (pool2 if tp * dp == 2 else pool4).run(
        'generate_case', tree=_np_tree(p), cfg_kw=LEGACY_KW, kind='llama',
        gen_kw=gen_kw, tp=tp, dp=dp, prompts=LEGACY_PROMPTS, max_new=30)
    assert _all_equal(outs, 'tokens') == base
    assert outs[0]['migrations']['grow'] >= 1
    assert outs[0]['cache_heads'] == 4 // tp


@pytest.mark.parametrize('plane,gen', [
    ('paged', {}), ('inplace', dict(prefill_chunk=8,
                                    prompt_buckets=[8, 32])),
    ('paged', dict(prefix_cache_mb=1, prefix_block=8)),
    ('unroll', dict(kv_cache_dtype='int8'))],
    ids=['paged', 'inplace-chunked', 'paged-prefix', 'unroll-int8'])
def test_legacy_batcher_mesh_parity_with_jax(pool4, plane, gen):
    import warnings
    cfg = _jax_cfg(head_dim_override=128)
    p = _jax_params(cfg)
    gen_kw = dict(LEGACY_GEN, decode_impl=plane, **gen)
    requests = list(REQUESTS) + [(LONG, 6), (LONG + [9], 5)]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        base = _jax_batcher(p, cfg, gen_kw, requests, decode_chunk=4)
    outs = pool4.run('batcher_case', tree=_np_tree(p), cfg_kw=LEGACY_KW,
                     kind='llama', gen_kw=gen_kw, tp=4, dp=1,
                     requests=requests, decode_chunk=4)
    assert _all_equal(outs, 'results') == base


def test_legacy_planes_in_bf16_agree_on_every_rank(pool2):
    """bf16 weights and cache, 'paged' and 'inplace' at tp 2: every rank
    the same tokens, and the prefill logits within BF16_LOGITS_ATOL of
    tp 1's (the port's one-card Generator on the same weights)."""
    import _torch_ranks
    cfg = _jax_cfg(head_dim_override=128)
    tree = _np_tree(_jax_params(cfg))
    kw = dict(LEGACY_KW, dtype='bfloat16')
    for plane in ('paged', 'inplace'):
        gen_kw = dict(LEGACY_GEN, decode_impl=plane)
        outs = pool2.run('generate_case', tree=tree, cfg_kw=kw,
                         kind='llama', gen_kw=gen_kw, tp=2, dp=1,
                         prompts=LEGACY_PROMPTS, max_new=12)
        tokens = _all_equal(outs, 'tokens')
        one = _torch_ranks.generate_case(tree, kw, 'llama', gen_kw, 1, 1,
                                         LEGACY_PROMPTS, 12)
        assert [len(t) for t in tokens] == [12, 12]
        np.testing.assert_allclose(outs[0]['logits'], one['logits'],
                                   atol=BF16_LOGITS_ATOL, rtol=0)
