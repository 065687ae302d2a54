"""The port's radix prefix cache (skypilot_tpu_torch/infer/prefix_cache.py)
and its warm paths in the Generator and the ContinuousBatcher, on the
CPU, held against the JAX package (tests/test_prefix_cache.py's cases).

What must hold:
- the trie: the same sequence of match/commit/insert/evict/forget calls
  gives the same hits, misses, tokens saved, eviction victims and node
  sets in both packages;
- legacy install/extract are exact copies (both KV layouts) that survive
  the source cache's bucket migrations, and write the cache in place;
- warm against cold: greedy tokens of the Generator and the batcher, on
  the pooled and 'paged' planes, f32 and int8 KV, chunked and not,
  across a bucket migration and after evictions, equal between warm and
  cold runs and equal to the JAX package's, with the same hit counts;
- a warm hit on the pooled plane dispatches no install or extract copy
  and makes exactly the cold run's host syncs (tests/test_block_pool.py
  :253), and the port's registry counts it;
- the drafter is seeded with the trie's continuation (spec_k);
- the pool is sized with the prefix budget, as the JAX engines size it.

At LLAMA_DEBUG (2 layers, f32, head_dim 128), weights from one JAX draw
(llama.params_from_numpy).  Tolerances: tokens identical (greedy, f32);
copied blocks bitwise.  Warm and cold runs are held to identical tokens,
not identical bits: a short cold prompt prefills through the grouped
prefill (K2's plain version here) where a warm hit's suffix takes the
window einsum, and f32 sums in another order are not the same bits.
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import prefix_cache as j_pc  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu_torch.infer import engine, llama_infer  # noqa: E402
from skypilot_tpu_torch.infer import prefix_cache as pc_mod  # noqa: E402
from skypilot_tpu_torch.infer.engine import (  # noqa: E402
    Generator, GeneratorConfig)
from skypilot_tpu_torch.infer.prefix_cache import (  # noqa: E402
    PrefixCache, make_prefix_cache)
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.telemetry.metrics import REGISTRY  # noqa: E402

CFG = llama.LLAMA_DEBUG
METRICS = ('skytpu_infer_prefix_hits_total',
           'skytpu_infer_prefix_tokens_saved_total',
           'skytpu_infer_pool_prefix_block_shares_total')
J_CFG = j_llama.LLAMA_DEBUG
# Two prompts sharing a 16-token head (2 prefix blocks of 8) with
# distinct tails: the second row of the very first batch already hits.
HEAD = [((5 * i) % 500) + 1 for i in range(16)]
PROMPTS = [HEAD + [501, 502], HEAD + [503]]


@pytest.fixture(autouse=True)
def _one_thread():
    """The engines run many small ops: with several test workers on the
    host's cores, torch's intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def models():
    jp = j_llama.init_params(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, llama.params_from_numpy(tree, CFG, 'cpu')


def _kw(**kw):
    # decode_chunk 8: the Generators' chunks (their default, 32, would
    # run 32 steps for 12 tokens; the batchers take their own).
    base = dict(max_seq_len=128, batch_size=2, temperature=0.0,
                prompt_buckets=[32], decode_chunk=8)
    base.update(kw)
    return base


def _both(**kw):
    """(JAX GeneratorConfig, port GeneratorConfig) of the same kwargs."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        return j_engine.GeneratorConfig(**_kw(**kw)), GeneratorConfig(
            **_kw(**kw))


def _run_batch(b, prompts, max_new=8):
    rids = [b.submit(p, max_new_tokens=max_new) for p in prompts]
    b.run_until_idle()
    return [b.result(r) for r in rids]


# ---- the trie, call for call against the JAX package ----------------------

def _tiny(val, jax_side):
    """An extractor of one 16-byte block: (L=1, block=4, 1, 1) f32."""
    if jax_side:
        return lambda start: {'k': jnp.full((1, 4, 1, 1), float(val))}
    return lambda start: {'k': torch.full((1, 4, 1, 1), float(val))}


def _nodes(pc):
    """The trie's node keys, depth-first, as token-prefix tuples."""
    out, stack = [], [(pc._root, ())]
    while stack:
        node, prefix = stack.pop()
        for key, child in node.children.items():
            out.append(prefix + key)
            stack.append((child, prefix + key))
    return sorted(out)


def _counters(pc):
    return (pc.hits, pc.misses, pc.tokens_saved, pc.evictions, pc.bytes,
            pc.node_count)


def _script(P, jax_side):
    """One sequence of trie calls (match/commit/insert/evict/forget);
    returns what each package observed along the way."""
    seen = []
    pc = P(block=4, capacity_bytes=32)
    pc.insert([1, 2, 3, 4], _tiny(1, jax_side))              # A
    pc.insert([5, 6, 7, 8], _tiny(2, jax_side))              # B
    m_a = pc.match([1, 2, 3, 4, 0])                          # pin A
    pc.commit(m_a)
    seen.append(('after B', _nodes(pc), _counters(pc)))
    pc.insert([9, 10, 11, 12], _tiny(3, jax_side))           # evicts B
    seen.append(('after C', _nodes(pc), _counters(pc)))
    miss = pc.match([5, 6, 7, 8, 0])
    pc.commit(miss)
    miss.release()
    m_a.release()
    toks = list(range(1, 10))
    pc.insert(toks, _tiny(4, jax_side))                      # 2-node chain
    seen.append(('chain', _nodes(pc), _counters(pc)))
    m = pc.match(toks + [99])
    seen.append(('match', m.tokens))
    pc.commit(m)
    m.release()
    seen.append(('continuation', pc.cached_continuation([1, 2, 3], 6)))
    seen.append(('forget', pc.forget(toks)))
    seen.append(('end', _nodes(pc), _counters(pc)))
    for cap in (4, 3, 1):
        m = pc.match([1, 2, 3, 4, 5, 6, 7, 8, 9][:cap + 4])
        seen.append(('cap', cap, m.tokens))
        m.release()
    return seen


def test_trie_call_sequence_matches_jax():
    assert _script(PrefixCache, False) == _script(j_pc.PrefixCache, True)


def test_match_caps_one_suffix_token():
    pc = PrefixCache(block=4, capacity_bytes=1 << 20)
    toks = list(range(1, 9))                    # exactly 2 blocks
    assert pc.insert(toks, _tiny(1, False)) == 2
    m = pc.match(toks)                          # len 8 -> at most 1 block
    assert m.tokens == 4
    m.release()
    m = pc.match(toks + [99])
    assert m.tokens == 8
    m.release()
    assert pc.match([1, 2, 3, 4]).tokens == 0   # len == block: no match


def test_eviction_leaves_only_then_exposes_parent():
    for P, jax_side in ((PrefixCache, False), (j_pc.PrefixCache, True)):
        pc = P(block=4, capacity_bytes=16)      # one block
        pc.insert(list(range(1, 10)), _tiny(1, jax_side))
        assert pc.node_count == 1 and pc.bytes == 16
        m = pc.match(list(range(1, 10)))
        assert m.tokens == 4
        m.release()
        pc.insert([90, 91, 92, 93], _tiny(2, jax_side))
        assert pc.bytes <= 16 and pc.evictions >= 2


def test_pooled_trie_matches_jax():
    """Pooled mode: the same inserts, matches, splices and evictions give
    the same refcounts, free blocks, shares and victims in both
    packages."""
    from skypilot_tpu.infer import block_pool as j_bp
    from skypilot_tpu_torch.infer import block_pool as bp
    out = []
    for side in ('jax', 'torch'):
        if side == 'jax':
            pool, P = j_bp.BlockPool(J_CFG, 12, 4), j_pc.PrefixCache
        else:
            pool, P = bp.BlockPool(CFG, 12, 4, device='cpu'), PrefixCache
        pc = P(block=8, capacity_bytes=1, pool=pool)
        pc.capacity_bytes = 3 * 2 * pc._pool_block_nbytes  # 3 nodes
        log = []
        for p in (list(range(1, 18)), list(range(1, 9)) + [70] * 9,
                  list(range(30, 47))):
            m = pc.match(p)
            pc.commit(m)
            shared = pc.splice(m)
            m.release()
            row = shared + pool.alloc(-(-len(p) // 4) - len(shared))
            pc.insert(p, blocks=row)
            pool.release(row)
            log.append((m.tokens, _nodes(pc), _counters(pc),
                        pool.free_blocks(), pool.prefix_shares))
        log.append(pc.evict_for_pool(pool.free_blocks() + 2))
        log.append((_nodes(pc), pool.free_blocks()))
        pool.check_invariant()
        out.append(log)
    assert out[0] == out[1]


def test_make_prefix_cache_disabled_by_default():
    assert make_prefix_cache(GeneratorConfig()) is None
    pc = make_prefix_cache(GeneratorConfig(prefix_cache_mb=2,
                                           prefix_block=8))
    assert pc is not None and pc.block == 8
    assert pc.capacity_bytes == 2 * 1024 * 1024


# ---- legacy install / extract ---------------------------------------------

@pytest.mark.parametrize('int8', [False, True], ids=['f32', 'int8'])
def test_extract_install_roundtrip_in_place(int8):
    """A block extracted from slot 1 and installed into slot 0 lands
    bitwise, into the destination's own tensors; untouched rows stay
    zero; the extracted block is a copy."""
    cfg = CFG
    cache = llama_infer.init_cache(cfg, 2, 32, kv_dtype='int8' if int8
                                   else None, device='cpu')
    gen = torch.Generator().manual_seed(7)
    for t in cache.values():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-120, 120, t.shape, generator=gen))
        else:
            t.copy_(torch.randn(t.shape, generator=gen))
    pc = PrefixCache(block=8, capacity_bytes=1 << 24)
    toks = list(range(1, 17))
    assert pc.insert(toks, functools.partial(pc.extract, cache, 1)) == 2
    want = {k: v[:, 1, :16].clone() for k, v in cache.items()}
    for t in cache.values():
        t[:, 1] = 0                            # the blocks are copies
    dst = llama_infer.init_cache(cfg, 2, 32, kv_dtype='int8' if int8
                                 else None, device='cpu')
    ptrs = {k: v.data_ptr() for k, v in dst.items()}
    m = pc.match(toks + [99])
    assert m.tokens == 16
    assert pc.install(dst, 0, m) is dst
    m.release()
    assert {k: v.data_ptr() for k, v in dst.items()} == ptrs
    for key in cache:
        assert torch.equal(dst[key][:, 0, :16], want[key]), key
        assert not dst[key][:, 0, 16:].any() and not dst[key][:, 1].any()


def test_blocks_survive_bucket_migration_of_source():
    gen = torch.Generator().manual_seed(0)
    cache = {k: torch.randn(v.shape, generator=gen)
             for k, v in llama_infer.init_cache(CFG, 2, 32,
                                                device='cpu').items()}
    pc = PrefixCache(block=8, capacity_bytes=1 << 24)
    toks = list(range(1, 17))
    pc.insert(toks, functools.partial(pc.extract, cache, 1))
    want = {k: v[:, 1, :16].clone() for k, v in cache.items()}
    cache = llama_infer.resize_cache(cache, 16)
    cache = llama_infer.resize_cache(cache, 64)
    del cache
    m = pc.match(toks + [99])
    dst = llama_infer.init_cache(CFG, 2, 32, device='cpu')
    pc.install(dst, 0, m)
    m.release()
    for key, ref in want.items():
        assert torch.equal(dst[key][:, 0, :16], ref), key


# ---- Generator: warm against cold, against JAX ----------------------------

@pytest.mark.parametrize('extra', [
    {}, dict(kv_cache_dtype='int8'), dict(spec_k=3),
    dict(decode_impl='paged'),
], ids=['pooled', 'int8', 'spec', 'paged'])
def test_generator_warm_cold_parity_matches_jax(models, extra):
    """Cold (trie empty), warm (every head block cached) and a no-cache
    reference give IDENTICAL greedy tokens, equal to the JAX Generator's,
    with the JAX Generator's hit counts (spec_k: the drafter is seeded
    with the trie's continuation)."""
    jp, tp = models
    jc_ref, tc_ref = _both(**extra)
    ref = Generator(tp, CFG, tc_ref, device='cpu').generate(
        PROMPTS, max_new_tokens=12)
    jc, tc = _both(prefix_cache_mb=4, prefix_block=8, **extra)
    jgen = j_engine.Generator(jp, J_CFG, jc)
    gen = Generator(tp, CFG, tc, device='cpu')
    want = [jgen.generate(PROMPTS, max_new_tokens=12) for _ in range(2)]
    cold = gen.generate(PROMPTS, max_new_tokens=12)
    hits_after_cold = gen.prefix.hits
    warm = gen.generate(PROMPTS, max_new_tokens=12)
    assert cold == ref and warm == ref
    assert [cold, warm] == want
    assert hits_after_cold >= 1
    assert gen.prefix.hits >= hits_after_cold + 2
    assert (gen.prefix.hits, gen.prefix.misses, gen.prefix.tokens_saved) \
        == (jgen.prefix.hits, jgen.prefix.misses, jgen.prefix.tokens_saved)
    if gen.pooled:
        gen.pool.check_invariant()
        assert gen.pool.n_blocks == jgen.pool.n_blocks


@pytest.mark.parametrize('impl', ['pooled', 'paged'])
def test_generator_parity_across_migration_and_eviction(models, impl):
    """Long enough to migrate the legacy cache (64 -> 128 rows) after
    prefix blocks were installed; and a budget under one prompt's blocks
    that evicts on every insert: tokens never change (the JAX side of
    these planes: test_generator_warm_cold_parity_matches_jax)."""
    _, tp = models
    kw = dict(cache_buckets=[64, 128], decode_impl=impl)
    _, tc_ref = _both(**kw)
    ref = Generator(tp, CFG, tc_ref, device='cpu').generate(
        PROMPTS, max_new_tokens=50)
    _, tc = _both(prefix_cache_mb=4, prefix_block=8, **kw)
    gen = Generator(tp, CFG, tc, device='cpu')
    got = [gen.generate(PROMPTS, max_new_tokens=50) for _ in range(2)]
    assert got == [ref, ref]
    if impl == 'paged':
        assert gen.migrations['grow'] > 0
    # One 8-token block of this config's cache is 16 KiB: a budget of
    # ~1.5 blocks evicts on every insert.
    _, tc = _both(prefix_cache_mb=0.024, prefix_block=8, **kw)
    gen = Generator(tp, CFG, tc, device='cpu')
    for _ in range(3):
        assert gen.generate(PROMPTS, max_new_tokens=12) == [
            r[:12] for r in ref]
    assert gen.prefix.evictions > 0
    assert gen.prefix.bytes <= gen.prefix.capacity_bytes


# ---- ContinuousBatcher: warm against cold, against JAX --------------------

@pytest.mark.parametrize('kv,chunk,impl', [
    (None, None, 'pooled'), (None, 8, 'pooled'), ('int8', None, 'pooled'),
    ('int8', 8, 'pooled'), (None, None, 'paged'), (None, 8, 'paged'),
    ('int8', None, 'paged'),
])
def test_batcher_warm_cold_parity_matches_jax(models, kv, chunk, impl):
    """Admission through the prefix-hit path (and the chunked path when
    prefill_chunk is set) gives a no-cache batcher's tokens cold and
    warm, equal to the JAX batcher's, with its hit counts."""
    jp, tp = models
    kw = dict(kv_cache_dtype=kv, prefill_chunk=chunk, decode_impl=impl)
    _, tc_ref = _both(**kw)
    ref = _run_batch(ContinuousBatcher(tp, CFG, tc_ref, device='cpu'),
                     PROMPTS)
    jc, tc = _both(prefix_cache_mb=4, prefix_block=8, **kw)
    jb = j_serving.ContinuousBatcher(jp, J_CFG, jc)
    b = ContinuousBatcher(tp, CFG, tc, device='cpu')
    want = [_run_batch(jb, PROMPTS), _run_batch(jb, PROMPTS)]
    got = [_run_batch(b, PROMPTS), _run_batch(b, PROMPTS)]
    assert got == [ref, ref] == want
    assert b._prefix.hits >= 2 and b._prefix.tokens_saved >= 32
    assert _counters(b._prefix)[:4] == _counters(jb._prefix)[:4]
    if b.pooled:
        b.pool.check_invariant()
        assert b.pool.stats()['blocks_live'] == jb.pool.stats()[
            'blocks_live'] > 0           # the trie keeps its blocks
        assert b.pool.n_blocks == jb.pool.n_blocks


@pytest.mark.parametrize('impl', ['pooled', 'paged'])
def test_batcher_parity_after_eviction_matches_jax(models, impl):
    jp, tp = models
    kw = dict(decode_impl=impl)
    _, tc_ref = _both(**kw)
    ref = _run_batch(ContinuousBatcher(tp, CFG, tc_ref, device='cpu'),
                     PROMPTS)
    jc, tc = _both(prefix_cache_mb=0.024, prefix_block=8, **kw)
    jb = j_serving.ContinuousBatcher(jp, J_CFG, jc)
    b = ContinuousBatcher(tp, CFG, tc, device='cpu')
    for _ in range(3):
        assert _run_batch(b, PROMPTS) == ref == _run_batch(jb, PROMPTS)
    assert b._prefix.evictions == jb._prefix.evictions > 0
    assert b._prefix.bytes <= b._prefix.capacity_bytes


def test_batcher_spec_drafts_from_the_trie_continuation(models):
    """spec_k with the prefix cache: a request whose prompt stops inside
    a block that an earlier prompt cached has its drafter seeded with
    the rest of that block (the trie's continuation); tokens equal
    JAX's."""
    jp, tp = models
    ext = [7 * i + 3 for i in range(8)]
    long, short = HEAD + ext + [11], HEAD + ext[:3]
    jc, tc = _both(prefix_cache_mb=4, prefix_block=8, spec_k=3)
    jb = j_serving.ContinuousBatcher(jp, J_CFG, jc)
    b = ContinuousBatcher(tp, CFG, tc, device='cpu')
    seen = []
    reset = b._drafter.reset
    b._drafter.reset = lambda slot, toks, cont=(): (
        seen.append(list(cont)), reset(slot, toks, cont))[1]
    for prompt in (long, short):
        assert _run_batch(b, [prompt], 12) == _run_batch(jb, [prompt], 12)
    assert seen == [[], ext[3:]]


def test_batcher_warm_prefix_hit_zero_copies(models, monkeypatch):
    """A warm hit on the pooled plane dispatches no install or extract
    copy, shares blocks instead, and makes exactly the cold run's host
    syncs (the JAX package's tests/test_block_pool.py:253)."""
    _, tp = models
    b = ContinuousBatcher(tp, CFG, GeneratorConfig(**_kw(
        prefix_cache_mb=1.0, prefix_block=16,
        prompt_buckets=[16, 32, 64])), device='cpu')
    head = list(range(2, 34))              # two prefix blocks
    syncs0 = engine.host_fetch.calls
    r = b.submit(head + [40, 41], max_new_tokens=8)
    b.run_until_idle()
    cold = b.result(r)
    cold_syncs = engine.host_fetch.calls - syncs0

    def boom(*a, **k):
        raise AssertionError('KV device copy on the pooled warm path')

    shares0 = b.pool.prefix_shares
    reg0 = [REGISTRY.get_sample_value(name) or 0.0 for name in METRICS]
    monkeypatch.setattr(pc_mod, 'install_prefix', boom)
    monkeypatch.setattr(pc_mod, 'extract_block', boom)
    syncs0 = engine.host_fetch.calls
    r = b.submit(head + [40, 41], max_new_tokens=8)
    b.run_until_idle()
    warm = b.result(r)
    assert warm == cold
    assert b._prefix.hits == 1
    assert b.pool.prefix_shares > shares0
    assert engine.host_fetch.calls - syncs0 == cold_syncs
    # The port's registry counts the hit, the 32 tokens and the 2 shares.
    assert [(REGISTRY.get_sample_value(name) or 0.0) - r0
            for name, r0 in zip(METRICS, reg0)] == [1, 32, 2]
