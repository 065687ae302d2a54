"""The port's serving data plane (skypilot_tpu_torch/infer: block_pool,
engine, serving, replica) on the CPU, held against the JAX package.

What must hold:
- BlockPool keeps the JAX pool's accounting (test_block_pool.py cases);
- GeneratorConfig raises the JAX config's validation errors, and
  NotImplementedError naming the ROADMAP.md item for deferred options
  (int8, spec_k and fuse_budget are carried: tests/test_torch_int8.py,
  tests/test_torch_spec_fused.py); the prefix cache and host tier build
  where the JAX package builds them (their behaviour:
  tests/test_torch_prefix_cache.py, test_torch_kv_tier.py,
  test_torch_disagg.py);
- on a mixed-length workload (one chunked prompt, more requests than
  slots) the port's ContinuousBatcher gives the JAX batcher's greedy
  tokens exactly, at LLAMA_DEBUG in f32, with the pool invariant after
  every step;
- pool exhaustion is admission backpressure;
- a decode chunk makes exactly one host fetch and no other host sync;
- the HTTP replica answers /health, returns the batcher's tokens from
  /generate and a 400 for a malformed body.
"""
import json
import os
import select
import subprocess
import sys
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from skypilot_tpu.infer import block_pool as j_block_pool  # noqa: E402
from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu_torch.infer import engine, replica  # noqa: E402
from skypilot_tpu_torch.infer.block_pool import (  # noqa: E402
    GARBAGE_BLOCK, BlockPool, PoolExhaustedError, block_nbytes, init_arena)
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402

CFG = llama.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=128, max_seq_len=128,
                        dtype=torch.float32)


@pytest.fixture(scope='module')
def params():
    return llama.init_params(CFG, torch.Generator().manual_seed(0), 'cpu')


def _gc(**kw):
    base = dict(max_seq_len=128, batch_size=2, temperature=0.0,
                prompt_buckets=[16, 32])
    base.update(kw)
    return GeneratorConfig(**base)


def _drain(batcher, max_ticks=500):
    """run_until_idle with the pool invariant checked after every step."""
    for _ in range(max_ticks):
        if not (batcher.num_active or batcher.num_queued):
            return
        batcher.step()
        batcher.pool.check_invariant()
    raise AssertionError('batcher did not go idle')


# ---- pool accounting ------------------------------------------------------

def test_pool_accounting_guards():
    pool = BlockPool(CFG, 4, 8, device='cpu')
    ids = pool.alloc(2)
    assert GARBAGE_BLOCK not in ids
    with pytest.raises(PoolExhaustedError):
        pool.alloc(2)                      # only 1 free
    assert pool.reserve(2) is False        # no side effects on failure
    assert pool.available() == 1
    assert pool.reserve(1) and pool.available() == 0
    pool.unreserve(1)
    with pytest.raises(AssertionError):
        pool.release([GARBAGE_BLOCK])
    pool.release(ids)
    with pytest.raises(AssertionError):
        pool.release([ids[0]])             # double free
    with pytest.raises(AssertionError):
        pool.share([ids[0]])               # share of a free block
    assert pool.free_blocks() + pool.live_blocks() == pool.n_blocks - 1
    pool.check_invariant()


def test_shared_blocks_survive_until_every_owner_releases():
    """A block with two owners returns to the free list only when both
    have released it (the refcount law the prefix cache relies on)."""
    pool = BlockPool(CFG, 9, 8, device='cpu')
    a = pool.alloc(4)
    pool.share(a, prefix=True)
    assert pool.prefix_shares == 4
    pool.release(a)
    assert pool.free_blocks() == 4 and all(pool.refcount(b) == 1 for b in a)
    pool.check_invariant()
    pool.release(a)
    assert pool.live_blocks() == 0 and pool.free_blocks() == 8
    pool.check_invariant()


def test_arena_layout_and_block_bytes():
    arena = init_arena(CFG, 5, 8, device='cpu')
    shape = (CFG.n_layers, 5, 8, CFG.n_kv_heads, CFG.head_dim)
    assert arena['k'].shape == shape and arena['v'].shape == shape
    assert arena['k'].dtype == CFG.dtype and not arena['k'].any()
    assert block_nbytes(CFG, 8) == 2 * 2 * 8 * 2 * 16 * 4
    with pytest.raises(ValueError, match='>= 2 blocks'):
        BlockPool(CFG, 1, 8, device='cpu')
    # int8: int8 k/v plus (L, NB, BS, KV) f32 scales, as the JAX arena.
    arena = init_arena(CFG, 5, 8, kv_dtype='int8', device='cpu')
    assert arena['k'].dtype == torch.int8 and arena['k'].shape == shape
    for key in ('k_scale', 'v_scale'):
        assert arena[key].dtype == torch.float32
        assert arena[key].shape == shape[:-1]
    j_cfg = j_llama.LlamaConfig(vocab_size=256, d_model=64, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=128,
                                max_seq_len=128)
    assert block_nbytes(CFG, 8, 'int8') == \
        j_block_pool.block_nbytes(j_cfg, 8, 'int8')
    with pytest.raises(ValueError, match='kv_dtype'):
        init_arena(CFG, 5, 8, kv_dtype='fp8', device='cpu')


# ---- GeneratorConfig ------------------------------------------------------

@pytest.mark.parametrize('kwargs,match', [
    (dict(fuse_budget=0, prefill_chunk=8), 'fuse_budget must be >= 1'),
    (dict(fuse_budget=4), 'set prefill_chunk'),
    (dict(host_tier_mb=-1.0), 'host_tier_mb must be >= 0'),
    (dict(host_tier_mb=1.0), 'set prefix_cache_mb'),
    (dict(overlap_chunks=0), 'overlap_chunks must be >= 1'),
    (dict(spec_k=-1), 'spec_k must be >= 0'),
    (dict(spec_k=8, max_seq_len=8), 'leaves no room'),
    (dict(kv_block_size=0), 'kv_block_size must be >= 1'),
    (dict(pool_blocks=1), 'pool_blocks must be >= 2'),
    (dict(prefix_cache_mb=1.0, prefix_block=48, kv_block_size=32),
     'must be a multiple of kv_block_size'),
])
def test_generator_config_validation_matches_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        j_engine.GeneratorConfig(**kwargs)
    with pytest.raises(ValueError, match=match):
        GeneratorConfig(**kwargs)


@pytest.mark.parametrize('kwargs', [
    dict(decode_impl='paged', max_seq_len=128, prompt_buckets=[64]),
    dict(decode_impl='inplace', max_seq_len=128),
], ids=['paged', 'inplace'])
def test_legacy_planes_take_a_mesh(kwargs):
    """A mesh on a legacy plane (K7 per shard) builds, as every mesh
    option does now: both engines on a one-rank mesh give the tokens of
    the same engine without one (tests/test_torch_tp.py holds tp 2, tp 4
    and dp 2 x tp 2 to the JAX package)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    j_engine.GeneratorConfig(**kwargs)       # valid for the JAX package
    gen = GeneratorConfig(batch_size=2, **kwargs)
    mesh = mesh_lib.Mesh(np.zeros((1, 1), np.int64), ('tp', 'tpq'))
    tp = llama.init_params(llama.LLAMA_DEBUG, torch.Generator(), 'cpu')
    prompts = [[5, 9, 2], [7, 1]]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        got = engine.Generator(tp, llama.LLAMA_DEBUG, gen, mesh=mesh,
                               device='cpu').generate(prompts, 6)
        want = engine.Generator(tp, llama.LLAMA_DEBUG, gen,
                                device='cpu').generate(prompts, 6)
        assert got == want and [len(t) for t in got] == [6, 6]
        b = ContinuousBatcher(tp, llama.LLAMA_DEBUG, gen, mesh=mesh,
                              device='cpu')
        rids = [b.submit(p, max_new_tokens=6) for p in prompts]
        b.run_until_idle()
        assert [b.result(r) for r in rids] == want


@pytest.mark.parametrize('kwargs', [
    dict(prefix_cache_mb=1.0),
    dict(prefix_cache_mb=1.0, host_tier_mb=1.0),
    dict(decode_impl='paged', prefix_cache_mb=1.0),
    dict(decode_impl='inplace', prefix_cache_mb=1.0),
], ids=['pooled', 'tier', 'paged', 'inplace'])
def test_prefix_and_tier_options_build_like_jax(kwargs):
    """The prefix cache and the host tier (ROADMAP.md Queue A item 9)
    build wherever the JAX package builds them: the same pool size,
    prefix block and budget, ids and bytes a node, and (tier) host rows;
    the Generator carries the same prefix cache."""
    jp = j_llama.init_params(j_llama.LLAMA_DEBUG, jax.random.PRNGKey(0))
    tp = llama.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
        llama.LLAMA_DEBUG, 'cpu')
    kw = dict(max_seq_len=128, batch_size=2, prompt_buckets=[32], **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jb = j_serving.ContinuousBatcher(jp, j_llama.LLAMA_DEBUG,
                                         j_engine.GeneratorConfig(**kw))
        b = ContinuousBatcher(tp, llama.LLAMA_DEBUG, GeneratorConfig(**kw),
                              device='cpu')
        gen = engine.Generator(tp, llama.LLAMA_DEBUG, GeneratorConfig(**kw),
                               device='cpu')
    try:
        assert (b._prefix.block, b._prefix.capacity_bytes) == (
            jb._prefix.block, jb._prefix.capacity_bytes)
        assert (gen.prefix.block, gen.prefix.capacity_bytes) == (
            jb._prefix.block, jb._prefix.capacity_bytes)
        assert (b.pool is None) == (jb.pool is None)
        if b.pool is not None:
            assert b.pool.n_blocks == gen.pool.n_blocks == jb.pool.n_blocks
            assert (b._prefix._ids_per_node, b._prefix._pool_block_nbytes) \
                == (jb._prefix._ids_per_node, jb._prefix._pool_block_nbytes)
        assert (b._tier is None) == (jb._tier is None)
        if b._tier is not None:
            assert (b._tier.host_blocks, b._tier.node_nbytes,
                    b._tier.ids_per_node, b._tier.tokens_per_node) == (
                jb._tier.host_blocks, jb._tier.node_nbytes,
                jb._tier.ids_per_node, jb._tier.tokens_per_node)
    finally:
        b.close()
        jb.close()


def test_block_size_and_buckets_match_jax():
    for kw in (dict(), dict(max_seq_len=32), dict(kv_block_size=16),
               dict(prompt_buckets=[8, 100], max_seq_len=100)):
        assert GeneratorConfig(**kw).derive_block_size() == \
            j_engine.GeneratorConfig(**kw).derive_block_size()
        assert engine.derive_buckets(GeneratorConfig(**kw)) == \
            j_engine.derive_buckets(j_engine.GeneratorConfig(**kw))
    with pytest.raises(ValueError, match='exceeds max_seq_len'):
        engine.derive_buckets(GeneratorConfig(prompt_buckets=[4096]))
    with pytest.raises(ValueError, match='context ceiling'):
        ContinuousBatcher({}, CFG, GeneratorConfig(max_seq_len=256),
                          device='cpu')


# ---- ContinuousBatcher vs the JAX batcher ---------------------------------

def test_mixed_workload_tokens_match_jax_batcher():
    """Batch 4, decode_chunk 4, prefill_chunk 24 (the 30-token prompt is
    chunked), five requests of mixed lengths and budgets through four
    slots: greedy tokens identical to the JAX ContinuousBatcher given
    the same weights, pool invariant after every step."""
    jp = j_llama.init_params(j_llama.LLAMA_DEBUG, jax.random.PRNGKey(0))
    tp = llama.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
        llama.LLAMA_DEBUG, 'cpu')
    kw = dict(max_seq_len=128, batch_size=4, prompt_buckets=[16, 32],
              prefill_chunk=24, kv_block_size=16)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, 512, size=n)]
               for n in (5, 12, 30, 3, 9)]
    budgets = [10, 6, 8, 12, 5]

    jb = j_serving.ContinuousBatcher(jp, j_llama.LLAMA_DEBUG,
                                     j_engine.GeneratorConfig(**kw),
                                     decode_chunk=4)
    j_rids = [jb.submit(p, max_new_tokens=n)
              for p, n in zip(prompts, budgets)]
    jb.run_until_idle()
    want = [jb.result(r) for r in j_rids]

    tb = ContinuousBatcher(tp, llama.LLAMA_DEBUG, GeneratorConfig(**kw),
                           decode_chunk=4, device='cpu')
    rids = [tb.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    _drain(tb)
    got = [tb.result(r) for r in rids]
    assert got == want
    assert [len(o) for o in got] == budgets
    st = tb.pool.stats()
    assert st['blocks_live'] == 0 and st['reserved'] == 0
    assert st['blocks_free'] == st['blocks_total'] - 1


def test_eos_and_sampled_requests(params):
    """EOS freezes a slot mid-chunk; sampled (temperature > 0) requests
    draw from the batcher's generator and stay in the vocabulary."""
    b = ContinuousBatcher(params, CFG, _gc(batch_size=2), decode_chunk=4,
                          device='cpu')
    r = b.submit([5, 6, 7], max_new_tokens=12)
    _drain(b)
    greedy = b.result(r)
    eos = greedy[5]
    stop = greedy.index(eos) + 1
    b = ContinuousBatcher(params, CFG, _gc(batch_size=2, eos_token=eos),
                          decode_chunk=4, device='cpu')
    r = b.submit([5, 6, 7], max_new_tokens=12)
    s = b.submit([9, 9], max_new_tokens=7, temperature=0.9, top_p=0.8)
    _drain(b)
    assert b.result(r) == greedy[:stop]
    sampled = b.result(s)
    assert 1 <= len(sampled) <= 7
    assert all(0 <= t < CFG.vocab_size for t in sampled)


def test_batcher_exhaustion_backpressure(params):
    """Free-list exhaustion keeps requests QUEUED (no exception, no
    fabricated blocks); they admit as finished sequences free blocks."""
    b = ContinuousBatcher(params, CFG, _gc(
        batch_size=3, kv_block_size=64, pool_blocks=3), device='cpu')
    r1 = b.submit([1, 2, 3], max_new_tokens=30)
    r2 = b.submit([4, 5, 6], max_new_tokens=30)
    r3 = b.submit([7, 8, 9], max_new_tokens=4)
    b.step()
    # Three slots exist, but the pool covers two requests: r3 is held
    # back by the block reservation, not by slot count.
    assert b.num_active == 2 and b.num_queued == 1
    _drain(b)
    for r in (r1, r2, r3):
        assert b.result(r) is not None
    st = b.pool.stats()
    assert st['blocks_live'] == 0 and st['reserved'] == 0
    assert st['blocks_free'] == st['blocks_total'] - 1
    # A request whose worst case exceeds the whole pool fails at submit.
    small = ContinuousBatcher(params, CFG, _gc(
        kv_block_size=64, pool_blocks=2), device='cpu')
    with pytest.raises(PoolExhaustedError, match='pool_blocks'):
        small.submit([1] * 20, max_new_tokens=100)


def test_one_host_fetch_per_decode_chunk(params, monkeypatch):
    """After admission every tick is one decode chunk: exactly one
    host_fetch, and no .item()/.tolist()/.cpu() anywhere inside it."""
    b = ContinuousBatcher(params, CFG, _gc(batch_size=2), decode_chunk=4,
                          device='cpu')
    rids = [b.submit([3, 4, 5], max_new_tokens=17),
            b.submit([7, 8], max_new_tokens=17)]
    b.step()                                # admission + first chunk

    def no_sync(*args, **kwargs):
        raise AssertionError('host sync inside a decode chunk')

    for name in ('item', 'tolist', 'cpu'):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    ticks = 0
    calls0 = engine.host_fetch.calls
    while b.num_active:
        before = [len(b.partial(r)) for r in rids]
        b.step()
        ticks += 1
        assert engine.host_fetch.calls - calls0 == ticks
        assert all(len(b.partial(r)) - n in (4, 17 - n)
                   for r, n in zip(rids, before))
    assert ticks == 3                       # 1 + 3 * 4 + 4 = 17 tokens
    assert [len(b.result(r)) for r in rids] == [17, 17]


def test_cancel_releases_everything(params):
    b = ContinuousBatcher(params, CFG, _gc(batch_size=1, prefill_chunk=8),
                          decode_chunk=2, device='cpu')
    active = b.submit([1, 2, 3], max_new_tokens=20)
    queued = b.submit([4, 5], max_new_tokens=20)
    b.step()
    assert b.num_active == 1 and b.num_queued == 1
    assert b.cancel(queued) == []
    out = b.cancel(active)
    assert len(out) == 3                     # first token + one chunk
    long_prompt = b.submit(list(range(1, 21)), max_new_tokens=5)
    b.step()                                 # one 8-token window
    assert b.num_queued == 1 and b.num_active == 0
    b.cancel(long_prompt)
    b.pool.check_invariant()
    st = b.pool.stats()
    assert st['blocks_live'] == 0 and st['reserved'] == 0
    with pytest.raises(ValueError, match='Unknown request'):
        b.cancel(active)


def test_entry_points_need_a_card_or_an_explicit_device(params):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(params, CFG, _gc())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(CFG, torch.Generator())


# ---- HTTP replica ---------------------------------------------------------

def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_replica_health_generate_and_400(params):
    prompt = [11, 12, 13, 14]
    direct = ContinuousBatcher(params, CFG, _gc(batch_size=2),
                               decode_chunk=4, device='cpu')
    rid = direct.submit(prompt, max_new_tokens=9)
    _drain(direct)
    want = direct.result(rid)

    batcher = ContinuousBatcher(params, CFG, _gc(batch_size=2),
                                decode_chunk=4, device='cpu')
    server, thread = replica.serve(batcher, '127.0.0.1', 0, 'tiny')
    url = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        with urllib.request.urlopen(f'{url}/health', timeout=30) as r:
            assert json.loads(r.read()) == {'status': 'ok', 'model': 'tiny'}
        status, body = _post(f'{url}/generate',
                             {'prompt_ids': prompt, 'max_new_tokens': 9,
                              'seed': 3})
        assert status == 200
        assert body['output_ids'] == want and body['num_generated'] == 9
        assert body['seed_ignored'] is True and body['ttft_s'] >= 0
        for bad in (b'{not json', b'[1, 2]', {'prompt_ids': 'abc'},
                    {'prompt_ids_typo': [1]}, {'prompt_ids': [1, 9999]},
                    {'prompt_ids': []}, {'prompt_ids': [1] * 200},
                    {'prompt_ids': [1], 'max_new_tokens': 'x'}):
            status, body = _post(f'{url}/generate', bad)
            assert status == 400, (bad, body)
            assert 'error' in body
        status, _ = _post(f'{url}/nope', {})
        assert status == 404
    finally:
        replica.shutdown_replica(server, thread)
    assert not thread.is_alive()
    batcher.pool.check_invariant()


def test_replica_command_line_serves_on_cpu():
    """`python -m skypilot_tpu_torch.infer.replica` builds random
    weights, warms the path, prints its port and answers requests."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.infer.replica',
         '--model', 'debug', '--device', 'cpu', '--host', '127.0.0.1',
         '--port', '0', '--batch-size', '2', '--max-seq-len', '128'],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 180)
        assert ready, 'replica printed no banner within 180 s'
        banner = json.loads(proc.stdout.readline())
        url = f'http://127.0.0.1:{banner["port"]}'
        with urllib.request.urlopen(f'{url}/health', timeout=30) as r:
            assert json.loads(r.read())['model'] == 'debug'
        status, body = _post(f'{url}/generate',
                             {'prompt_ids': [1, 2, 3], 'max_new_tokens': 5})
        assert status == 200 and body['num_generated'] == 5
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        finally:
            proc.stdout.close()
            proc.stderr.close()
    assert proc.returncode is not None
