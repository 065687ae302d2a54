"""The port's host KV tier (skypilot_tpu_torch/infer/kv_tier.py) and its
wiring in the ContinuousBatcher, on the CPU, held against the JAX package
(tests/test_kv_tier.py's cases).

What must hold:
- the copy engine's bounded queue rejects instead of blocking; a failed
  job keeps its unwind for the scheduler thread and the thread lives on;
  its thread has a name of its own (the JAX package's tests look for
  live threads named exactly 'kv-tier-copy') and close() joins it;
- spill -> host -> prefetch round-trips bitwise for f32, bf16 and int8
  (+ f32 scales) arenas, into the arena's own tensors, with the pool's
  conservation law intact;
- the host store is LRU within its budget and never evicts an entry
  whose copy is in flight;
- an injected copy error unwinds and re-raises on drain;
- no tier means no host buffers, no thread and inert hints;
- tier-on and tier-off batchers give equal greedy tokens under eviction,
  equal to the JAX package's, with the same spill, prefetch and hit
  counts; a hinted prefetch after churn turns the revisit into a hit;
- graph safety: with a stand-in for the card's ChunkGraphs, a drain, a
  prefix install and a handoff ingest leave the arena's (and the slot
  cache's) data_ptr unchanged and clear no graph.

At LLAMA_DEBUG (2 layers, f32), weights from one JAX draw.  Tolerances:
tokens identical (greedy, f32); copied bytes bitwise.
"""
import dataclasses
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu_torch.infer import engine, kv_tier  # noqa: E402
from skypilot_tpu_torch.infer.block_pool import BlockPool  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.kv_tier import (  # noqa: E402
    AsyncCopyEngine, KVTier)
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402

CFG = llama.LLAMA_DEBUG
J_CFG = j_llama.LLAMA_DEBUG
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


@pytest.fixture
def closing():
    """Collects batchers and tiers; closes (joins) each at teardown, so
    no copy thread outlives its test."""
    made = []
    yield made.append
    for obj in made:
        obj.close()


def _kw(**kw):
    base = dict(max_seq_len=128, batch_size=2, temperature=0.0,
                prompt_buckets=[32])
    base.update(kw)
    return base


def _run_batch(b, prompts, max_new=8):
    rids = [b.submit(p, max_new_tokens=max_new) for p in prompts]
    b.run_until_idle()
    return [b.result(r) for r in rids]


# ---- copy engine --------------------------------------------------------

def test_engine_bounded_queue_rejects_instead_of_blocking():
    eng = AsyncCopyEngine(max_pending=1)
    gate, started = threading.Event(), threading.Event()

    def blocker():
        started.set()
        gate.wait(10)

    assert eng.try_submit(blocker)
    started.wait(10)
    assert eng.try_submit(lambda: None)      # fills the 1-slot queue
    assert not eng.try_submit(lambda: None)  # full -> reject, no block
    names = [t.name for t in threading.enumerate()]
    assert kv_tier.COPY_THREAD_NAME in names and 'kv-tier-copy' not in names
    gate.set()
    eng.wait_until_finished()
    assert eng.pop_errors() == []
    eng.close()
    assert not eng.try_submit(lambda: None)  # closed -> reject
    assert kv_tier.COPY_THREAD_NAME not in [
        t.name for t in threading.enumerate()]


def test_engine_collects_errors_with_unwind_and_survives():
    eng = AsyncCopyEngine(max_pending=2)
    unwound = []

    def bad():
        raise RuntimeError('copy failed')

    assert eng.try_submit(bad, on_error=lambda: unwound.append('u'))
    eng.wait_until_finished()
    errors = eng.pop_errors()
    assert len(errors) == 1 and isinstance(errors[0][0], RuntimeError)
    assert unwound == []                    # NOT run on the copy thread
    errors[0][1]()
    assert unwound == ['u']
    ran = threading.Event()
    assert eng.try_submit(ran.set)
    eng.wait_until_finished()
    assert ran.is_set() and eng.pop_errors() == []
    eng.close()


# ---- KVTier on a real pool ----------------------------------------------

DTYPES = {'f32': (CFG, None),
          'bf16': (dataclasses.replace(CFG, dtype=torch.bfloat16), None),
          'int8': (CFG, 'int8')}


def _mk_tier(closing, kv='f32', host_nodes=4, n_blocks=8, block=4,
             max_pending=2):
    cfg, kv_dtype = DTYPES[kv]
    pool = BlockPool(cfg, n_blocks, block, kv_dtype=kv_dtype, device='cpu')
    tier = KVTier(pool, host_bytes=host_nodes * pool.block_nbytes,
                  ids_per_node=1, tokens_per_node=block,
                  max_pending=max_pending)
    closing(tier)
    return pool, tier


def _fill_block(pool, bid, seed):
    """Random rows into arena block `bid` in place; returns them."""
    gen = torch.Generator().manual_seed(seed)
    expect = {}
    for comp, arr in pool.arena.items():
        shape = (arr.shape[0],) + tuple(arr.shape[2:])
        if arr.dtype == torch.int8:
            row = torch.randint(-120, 120, shape, generator=gen,
                                dtype=torch.int8)
        else:
            row = torch.randn(shape, generator=gen).to(arr.dtype)
        arr[:, bid] = row
        expect[comp] = row
    return expect


def _spill(pool, tier, key, seed):
    """alloc + fill + spill + release one block under `key`."""
    src = pool.alloc(1)
    expect = _fill_block(pool, src[0], seed)
    assert tier.accept_spill(key, src)
    pool.release(src)          # exactly what PrefixCache._drop does
    return expect


class _Node:
    tier = 'loading'


@pytest.mark.parametrize('kv', ['f32', 'bf16', 'int8'])
def test_spill_prefetch_roundtrip_bitwise(closing, kv):
    pool, tier = _mk_tier(closing, kv)
    ptrs = {c: a.data_ptr() for c, a in pool.arena.items()}
    key = (1, 2, 3, 4)
    expect = _spill(pool, tier, key, seed=7)
    tier.flush()
    entry = tier._entries[key]
    assert entry.state == 'host'
    for comp, row in expect.items():
        assert torch.equal(tier._host[comp][entry.host_ids[0]], row)
    assert tier.spill_bytes == tier.node_nbytes
    chain = tier.host_continuation([1, 2, 3, 4, 9], 0)
    assert chain == [entry]
    dev = pool.alloc_for_prefetch(1)
    assert dev is not None and dev[0] in pool.inflight_blocks()
    node = _Node()
    tier.start_prefetch(chain, dev, [node])
    tier.flush()
    assert node.tier == 'device' and not pool.inflight_blocks()
    for comp, row in expect.items():
        assert torch.equal(pool.arena[comp][:, dev[0]], row), comp
    assert {c: a.data_ptr() for c, a in pool.arena.items()} == ptrs
    assert tier.prefetch_bytes == tier.node_nbytes
    pool.release(dev)
    pool.check_invariant()


def test_prefetch_never_takes_reserved_blocks(closing):
    pool, _ = _mk_tier(closing)
    assert pool.reserve(pool.free_blocks() - 1)
    assert pool.alloc_for_prefetch(2) is None
    ids = pool.alloc_for_prefetch(1)
    assert pool.inflight_blocks() == set(ids)
    assert pool.stats()['inflight'] == 1
    pool.check_invariant()
    pool.clear_inflight(ids)
    pool.release(ids)
    pool.check_invariant()
    ids = pool.alloc_for_prefetch(1)
    with pytest.raises(AssertionError, match='in-flight'):
        pool.release(ids)          # the copy's destination, freed early


def test_host_lru_eviction_and_inflight_never_victim(closing):
    pool, tier = _mk_tier(closing, host_nodes=2)
    for i in (1, 2, 3):
        _spill(pool, tier, (i,), seed=i)
        tier.flush()
    assert tier.host_evictions == 1
    assert set(tier._entries) == {(2,), (3,)}
    # A 1-node budget whose only entry is mid-spill: that entry is not
    # evictable, so the second spill is REJECTED.
    pool2, tier2 = _mk_tier(closing, host_nodes=1)
    gate = threading.Event()
    real = kv_tier._complete_copy
    kv_tier._complete_copy = lambda pending: (gate.wait(10), real(pending))[1]
    try:
        src = pool2.alloc(1)
        _fill_block(pool2, src[0], seed=4)
        assert tier2.accept_spill((1,), src)   # 'spilling', undrained
        pool2.release(src)
        rejects = tier2.spill_rejects
        src2 = pool2.alloc(1)
        assert not tier2.accept_spill((2,), src2)
        assert tier2.spill_rejects == rejects + 1
        pool2.release(src2)
    finally:
        gate.set()
        kv_tier._complete_copy = real
    tier2.flush()
    assert set(tier2._entries) == {(1,)}
    pool2.check_invariant()


def test_spill_error_unwinds_and_reraises_on_drain(closing, monkeypatch):
    pool, tier = _mk_tier(closing)

    def boom(_):
        raise RuntimeError('host copy died')

    monkeypatch.setattr(kv_tier, '_complete_copy', boom)
    _spill(pool, tier, (1, 2), seed=5)
    tier.wait_pending()
    with pytest.raises(RuntimeError, match='host copy died'):
        tier.drain()
    assert (1, 2) not in tier._entries
    assert tier.host_resident_blocks() == 0
    assert not tier.in_flight()
    pool.check_invariant()


def test_prefetch_error_unwinds_blocks_and_nodes(closing, monkeypatch):
    pool, tier = _mk_tier(closing)
    _spill(pool, tier, (1, 2, 3, 4), seed=3)
    tier.flush()
    chain = tier.host_continuation([1, 2, 3, 4, 5], 0)
    dev = pool.alloc_for_prefetch(1)
    node = _Node()
    # The staging copy fails on the copy thread.
    monkeypatch.setattr(tier, '_staging', [None] * len(tier._staging))
    tier.start_prefetch(chain, dev, [node])
    tier.wait_pending()
    with pytest.raises(TypeError):
        tier.drain()
    assert node.tier == 'failed' and chain[0].state == 'host'
    assert not pool.inflight_blocks() and pool.live_blocks() == 0
    pool.check_invariant()


# ---- batcher level --------------------------------------------------------

def test_no_tier_is_exactly_the_old_batcher(models, closing):
    _, tp = models
    for kw in ({}, {'host_tier_mb': 0},
               {'host_tier_mb': None, 'prefix_cache_mb': 4,
                'prefix_block': 8}):
        b = ContinuousBatcher(tp, CFG, GeneratorConfig(**_kw(**kw)),
                              device='cpu')
        closing(b)
        assert b._tier is None
        assert not b.prefetch_hint(PROMPTS[0])
        b.tier_flush()
        b.close()
    assert not any(t.name in (kv_tier.COPY_THREAD_NAME, 'kv-tier-copy')
                   for t in threading.enumerate())


def test_gen_config_validation_matches_jax():
    for kw, match in ((dict(host_tier_mb=4.0), 'prefix_cache_mb'),
                      (dict(host_tier_mb=4.0, prefix_cache_mb=4,
                            prefix_block=8, decode_impl='inplace'),
                       'pooled'),
                      (dict(host_tier_mb=-1.0), 'host_tier_mb')):
        with pytest.raises(ValueError, match=match):
            j_engine.GeneratorConfig(**_kw(**kw))
        with pytest.raises(ValueError, match=match):
            GeneratorConfig(**_kw(**kw))


def _tier_counts(b):
    s = b._tier.stats()
    return {k: s[k] for k in ('spills', 'prefetches', 'host_hits',
                              'device_hits', 'misses', 'prefetch_late',
                              'host_evictions', 'spill_bytes',
                              'prefetch_bytes')}


@pytest.mark.parametrize('kv,budget', [(None, 0.024), ('int8', 0.006)],
                         ids=['f32', 'int8'])
def test_batcher_tier_parity_under_eviction_matches_jax(models, closing,
                                                        kv, budget):
    """An eviction-forcing device budget with the tier on: every evict
    spills and revisits prefetch; greedy tokens equal the tier-off
    batcher's and the JAX batcher's, with the JAX tier's counts."""
    jp, tp = models
    ref = _run_batch(ContinuousBatcher(tp, CFG, GeneratorConfig(**_kw(
        kv_cache_dtype=kv)), device='cpu'), PROMPTS)
    kw = _kw(kv_cache_dtype=kv, prefix_cache_mb=budget, prefix_block=8,
             host_tier_mb=2.0)
    jb = j_serving.ContinuousBatcher(jp, J_CFG, j_engine.GeneratorConfig(
        **kw))
    closing(jb)
    b = ContinuousBatcher(tp, CFG, GeneratorConfig(**kw), device='cpu')
    closing(b)
    off = ContinuousBatcher(tp, CFG, GeneratorConfig(**{
        **kw, 'host_tier_mb': None}), device='cpu')
    for _ in range(3):
        got = _run_batch(b, PROMPTS)
        assert got == ref == _run_batch(jb, PROMPTS) == _run_batch(
            off, PROMPTS)
        b.tier_flush()
        jb.tier_flush()
    assert b._prefix.evictions > 0 and b._tier.spills > 0
    assert _tier_counts(b) == {k: jb._tier.stats()[k]
                               for k in _tier_counts(b)}
    assert (b._prefix.hits, b._prefix.misses) == (jb._prefix.hits,
                                                  jb._prefix.misses)
    b.pool.check_invariant()


def test_hinted_prefetch_restores_warm_hits_after_churn(models, closing):
    """Populate -> churn past the device budget -> hint -> resubmit: the
    revisit is served from the host tier (a hit, not a miss), its tokens
    those of the first pass, and the counts the JAX tier's."""
    jp, tp = models
    kw = _kw(prefix_cache_mb=0.024, prefix_block=8, host_tier_mb=2.0)
    filler = [[((7 * i + j) % 500) + 1 for j in range(12)]
              for i in range(4)]
    results = []
    for side in ('jax', 'torch'):
        if side == 'jax':
            b = j_serving.ContinuousBatcher(jp, J_CFG,
                                            j_engine.GeneratorConfig(**kw))
        else:
            b = ContinuousBatcher(tp, CFG, GeneratorConfig(**kw),
                                  device='cpu')
        closing(b)
        first = _run_batch(b, [PROMPTS[0]])
        b.tier_flush()
        _run_batch(b, filler)
        b.tier_flush()
        assert b._tier.spills > 0
        pre_missed = b._tier.misses
        assert b.prefetch_hint(PROMPTS[0])
        b.tier_flush()
        again = _run_batch(b, [PROMPTS[0]])
        b.tier_flush()
        assert again == first
        assert b._tier.prefetches > 0
        assert b._tier.host_hits + b._tier.device_hits > 0
        assert b._tier.misses == pre_missed
        b.pool.check_invariant()
        results.append((first, {k: b._tier.stats()[k]
                                for k in _tier_counts(b)}))
    assert results[0] == results[1]


def test_parked_request_waits_for_its_prefetch(models, closing):
    """Without a hint, a revisit parks on the prefetch it triggers
    (prefetch_late) and is admitted once the blocks land."""
    _, tp = models
    b = ContinuousBatcher(tp, CFG, GeneratorConfig(**_kw(
        prefix_cache_mb=0.024, prefix_block=8, host_tier_mb=2.0)),
        device='cpu')
    closing(b)
    first = _run_batch(b, [PROMPTS[0]])
    _run_batch(b, [[((7 * i + j) % 500) + 1 for j in range(12)]
                   for i in range(4)])
    b.tier_flush()
    assert _run_batch(b, [PROMPTS[0]]) == first
    assert b._tier.prefetch_late == 1 and b._tier.host_hits == 1
    b.pool.check_invariant()


# ---- graph safety -----------------------------------------------------------

class _Graphs:
    """In place of the card's ChunkGraphs: runs each chunk eagerly and
    records a clear()."""

    def __init__(self):
        self.cleared = 0

    def run(self, key, body):
        return body()

    def clear(self):
        self.cleared += 1


def test_drain_install_ingest_keep_addresses_and_graphs(models, closing):
    """A tier drain (spills and a prefetch scatter), a legacy prefix
    install and a handoff ingest write in place: no arena or slot-cache
    tensor moves, and no graph is dropped."""
    _, tp = models
    kw = _kw(prefix_cache_mb=0.024, prefix_block=8, host_tier_mb=2.0)
    b = ContinuousBatcher(tp, CFG, GeneratorConfig(**kw), device='cpu')
    closing(b)
    b.graphs = _Graphs()
    ptrs = {c: a.data_ptr() for c, a in b.pool.arena.items()}
    first = _run_batch(b, [PROMPTS[0]])
    _run_batch(b, [[((7 * i + j) % 500) + 1 for j in range(12)]
                   for i in range(4)])
    b.tier_flush()
    assert b.prefetch_hint(PROMPTS[0])
    b.tier_flush()
    assert b._tier.prefetches > 0
    assert _run_batch(b, [PROMPTS[0]]) == first
    # A handoff ingest into a second batcher.
    dec = ContinuousBatcher(tp, CFG, GeneratorConfig(**kw), device='cpu')
    closing(dec)
    dec.graphs = _Graphs()
    dec_ptrs = {c: a.data_ptr() for c, a in dec.pool.arena.items()}
    res = b.export_handoff(PROMPTS[0])
    assert dec.ingest_handoff(PROMPTS[0], res['payload']) > 0
    dec.tier_flush()
    assert _run_batch(dec, [PROMPTS[0]]) == first
    assert {c: a.data_ptr() for c, a in b.pool.arena.items()} == ptrs
    assert {c: a.data_ptr() for c, a in dec.pool.arena.items()} == dec_ptrs
    assert b._cache is b.pool.arena and dec._cache is dec.pool.arena
    # The legacy plane's install writes the slot cache in place.
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        leg = ContinuousBatcher(tp, CFG, GeneratorConfig(**_kw(
            decode_impl='inplace', prefix_cache_mb=4, prefix_block=8,
            cache_buckets=[64, 128])), device='cpu')
    leg.graphs = _Graphs()
    _run_batch(leg, [PROMPTS[0]])
    cache_ptrs = {c: a.data_ptr() for c, a in leg._cache.items()}
    _run_batch(leg, [PROMPTS[1]])
    assert leg._prefix.hits == 1
    assert {c: a.data_ptr() for c, a in leg._cache.items()} == cache_ptrs
    assert b.graphs.cleared == dec.graphs.cleared == leg.graphs.cleared == 0
