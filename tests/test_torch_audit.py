"""The port's compile-budget audit (skypilot_tpu_torch/analysis/audit.py)
on the CPU, held against the JAX package.

What must hold:
- ``run_audit(device='cpu')`` reports every check ``ok`` but
  mesh_decode's, a ``skip`` with its reason (no process group here);
  the entries are the reference REGISTRY's, in its order, and each
  entry's check names are the reference's (audit.py of the JAX package,
  read off its source: its jaxpr walk cannot run on this jax);
- over the same runs and the same weights (``llama.params_from_numpy``
  of the JAX package's PRNGKey(0) tree), the port's key, shape and call
  counts equal the JAX engines' ``_cache_size()`` values (decode chunk,
  batcher decode, verify, fused, prefill, prefix install, tier gather and
  scatter), and the hits, spills, prefetches, fused steps and greedy
  tokens equal theirs;
- each negative case fails its own check, and run_audit reports it
  instead of crashing: two stray decode keys (compile_per_bucket), an
  injected ``int(token[0])`` (no_callbacks, naming
  ``_local_scalar_dense``), an f64 cast (no_f64), a shadow arena copy
  (donation), an exception (trace), and on a pool of 2 gloo ranks an
  extra all-reduce a layer (collective_budget), where the clean run
  gives 2 all-reduces a layer and the overlap pin;
- graph_budgets (chip_smoke.py phase 20's read-off of served batchers)
  holds on pooled spec+fused and legacy traffic and catches a key
  captured twice in one visit and a moved buffer;
- ``python -m skypilot_tpu_torch.analysis --audit --json --device cpu``
  exits 0 with ``ok``.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from skypilot_tpu_torch.analysis import audit  # noqa: E402
from skypilot_tpu_torch.infer.engine import ChunkGraphs  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Tiny shapes: one torch thread a test worker (eight threads in
    each of six workers turn seconds into minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# The reference's check names per entry, in order (skypilot_tpu/analysis/
# audit.py: each entry's _check calls, _jaxpr_dtype_and_callback_checks =
# no_callbacks + no_f64, _donation_check = donation, _sharding_check =
# output_sharding).
GRAPH = ['no_callbacks', 'no_f64']
REFERENCE_CHECKS = {
    'generator_decode': ['compile_per_bucket', 'donation'] + GRAPH
    + ['output_sharding'],
    'batcher_decode': ['compile_per_bucket', 'donation'] + GRAPH
    + ['output_sharding'],
    'prefill': GRAPH,
    'prefix_cache': ['decode_compile_per_bucket', 'warm_run_hits',
                     'zero_copy_splice', 'pool_refcount_invariant'],
    'block_pool': ['decode_compile_budget', 'prefill_compile_budget',
                   'donation', 'prefill_donation'] + GRAPH
    + ['free_list_balance'],
    'spec_decode': ['verify_compile_budget', 'decode_compile_budget',
                    'donation'] + GRAPH + ['output_sharding'],
    'fused_step': ['fused_steps_ran', 'fused_compile_budget', 'donation']
    + GRAPH + ['output_sharding'],
    'kv_tier': ['tier_exercised', 'copy_compile_budget',
                'decode_compile_budget', 'gather_no_callbacks',
                'gather_no_f64', 'scatter_no_callbacks', 'scatter_no_f64',
                'pool_refcount_invariant'],
    'disagg': [f'{layout}_{name}' for layout in ('model', 'int8')
               for name in ('export_nonempty', 'prefill_pool_released',
                            'greedy_parity', 'ingest_exercised',
                            'copy_compile_budget', 'decode_pool_invariant',
                            'export_gather_no_callbacks',
                            'export_gather_no_f64',
                            'ingest_scatter_no_callbacks',
                            'ingest_scatter_no_f64', 'scatter_donation')],
    'mesh_decode': ['compile_per_bucket', 'donation', 'collective_budget',
                    'no_arena_allgather', 'verify_compile_budget',
                    'ring_collective_pin'],
    'trainer_step': ['donation'] + GRAPH,
    'ckpt_reshard': ['reshard_restore', 'roundtrip_bit_exact', 'no_f64',
                     'bounded_compiles'] + GRAPH,
    'ring_attention': GRAPH,
}


@pytest.fixture(scope='module')
def report():
    return audit.run_audit(device='cpu')


def test_run_audit_on_the_cpu_is_green_with_the_reference_names(report):
    from skypilot_tpu.analysis import audit as j_audit
    assert [e['entry'] for e in report['entries']] == list(j_audit.REGISTRY)
    assert list(audit.REGISTRY) == list(j_audit.REGISTRY)
    by_entry = {e['entry']: e for e in report['entries']}
    for name, checks in by_entry.items():
        statuses = {c['name']: c['status'] for c in checks['checks']}
        if name == 'mesh_decode':
            (check,) = checks['checks']
            assert check['status'] == 'skip' and 'process group' in \
                check['detail'], check
            continue
        assert [c['name'] for c in checks['checks']] == \
            REFERENCE_CHECKS[name], name
        bad = {k: v for k, v in statuses.items()
               if v != 'ok' and k != 'output_sharding'}
        assert not bad, (name, checks['checks'])
        if 'output_sharding' in statuses:
            assert statuses['output_sharding'] == 'skip'
    assert report['ok']
    for entry in report['entries']:
        for check in entry['checks']:
            assert set(check) == {'name', 'status', 'detail'}
            assert check['status'] in ('ok', 'fail', 'skip')


def test_budget_details_say_what_counted(report):
    by_entry = {e['entry']: e for e in report['entries']}
    budget = by_entry['generator_decode']['checks'][0]
    assert 'key-recording stand-in' in budget['detail']
    assert by_entry['generator_decode']['compiles'] == 1
    assert by_entry['generator_decode']['buckets'] == ['arena']


def test_quick_summary_shape():
    summary = audit.quick_summary(device='cpu')
    assert summary == {'decode_compiles': 1, 'cache_buckets': ['arena'],
                       'compile_budget_ok': True, 'cache_donated': True,
                       'failures': 0}


# ---- count parity with the JAX engines --------------------------------------

@pytest.fixture(scope='module')
def weights():
    jax = pytest.importorskip('jax')
    from skypilot_tpu.analysis import audit as j_audit
    from skypilot_tpu.models import llama as j_llama
    jcfg = j_audit._tiny_config()
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    cfg = audit._tiny_config('cpu')
    return jp, jcfg, llama.params_from_numpy(tree, cfg, 'cpu')


def _kv_tier_churn(batcher, vocab):
    """audit_kv_tier's run (both packages' batchers take these calls),
    each tick started once the tier's copy engine has run every queued
    copy: until a tick's drain sees a spill complete it holds one of the
    engine's two slots, so which evictions spill would otherwise depend
    on the copy thread's timing (in either package)."""
    step = batcher.step

    def settled():
        batcher._tier.wait_pending()
        step()

    batcher.step = settled
    rng = np.random.default_rng(0)
    head = [int(t) for t in rng.integers(1, vocab, size=24)]
    out = []
    rid = batcher.submit(head, max_new_tokens=8)
    batcher.run_until_idle()
    out.append(list(batcher.result(rid)))
    for _ in range(8):
        p = [int(t) for t in rng.integers(1, vocab, size=24)]
        r = batcher.submit(p, max_new_tokens=4)
        batcher.run_until_idle()
        out.append(list(batcher.result(r)))
    batcher.tier_flush()
    batcher.prefetch_hint(head)
    batcher.tier_flush()
    rid = batcher.submit(head, max_new_tokens=8)
    batcher.run_until_idle()
    out.append(list(batcher.result(rid)))
    batcher.tier_flush()
    return out


def _serve(batcher, prompts, extra=()):
    rids = [batcher.submit(list(p), max_new_tokens=audit._AUDIT_MAX_NEW)
            for p in prompts]
    rids += [batcher.submit(list(p), max_new_tokens=n) for p, n in extra]
    batcher.run_until_idle()
    return [list(batcher.result(r)) for r in rids]


@pytest.fixture(scope='module')
def jax_counts(weights):
    """The JAX engines over the audit's runs: their jit cache sizes, stats
    and greedy tokens."""
    from skypilot_tpu.analysis import audit as j_audit
    from skypilot_tpu.infer.serving import ContinuousBatcher as JBatcher
    jp, jcfg, _ = weights
    out = {}
    gen = j_audit.make_tiny_generator()
    out['gen_tokens'] = gen.generate(audit._AUDIT_PROMPTS,
                                     max_new_tokens=audit._AUDIT_MAX_NEW)
    out['gen_decode'] = gen._decode_chunk._cache_size()

    b = JBatcher(jp, jcfg, j_audit._tiny_gen_config(), decode_chunk=8)
    out['batcher_tokens'] = _serve(b, audit._AUDIT_PROMPTS)
    out['batcher_decode'] = b._decode._cache_size()

    g = j_audit.make_tiny_generator(prefix_cache_mb=4, prefix_block=8,
                                    prompt_buckets=[32])
    out['prefix_tokens'] = [
        g.generate(audit._PREFIX_PROMPTS, max_new_tokens=audit._AUDIT_MAX_NEW)
        for _ in range(2)]
    out['prefix'] = dict(
        decode=g._decode_chunk._cache_size(),
        install=g.prefix._install._cache_size(),
        prefill=g._prefill._cache_size(), hits=g.prefix.hits,
        misses=g.prefix.misses, tokens_saved=g.prefix.tokens_saved,
        shares=g.pool.prefix_shares)

    s = j_audit.make_tiny_generator(spec_k=3)
    out['spec_tokens'] = [
        s.generate(audit._SPEC_PROMPTS, max_new_tokens=audit._AUDIT_MAX_NEW)
        for _ in range(2)]
    out['spec'] = dict(verify=s._verify_chunk._cache_size(),
                       decode=s._decode_chunk._cache_size())

    f = JBatcher(jp, jcfg, j_audit._tiny_gen_config(
        batch_size=4, prompt_buckets=[8, 32], prefill_chunk=8,
        fuse_budget=6), decode_chunk=4)
    out['fused_tokens'] = _serve(f, audit._AUDIT_PROMPTS,
                                 [(list(range(2, 26)), 8)])
    out['fused'] = dict(fused=f._fused._cache_size(),
                        steps=f._fuse_policy.stats.steps)

    t = JBatcher(jp, jcfg, j_audit._tiny_gen_config(
        prefix_cache_mb=0.02, prefix_block=8, prompt_buckets=[32],
        host_tier_mb=4.0), decode_chunk=8)
    out['tier_tokens'] = _kv_tier_churn(t, jcfg.vocab_size)
    st = t._tier.stats()
    out['tier'] = dict(gather=t._tier._gather._cache_size(),
                       scatter=t._tier._scatter._cache_size(),
                       decode=t._decode._cache_size(), spills=st['spills'],
                       prefetches=st['prefetches'])
    t.close()
    return out


def test_generator_and_batcher_decode_keys_equal_the_jax_compiles(
        weights, jax_counts):
    _, _, params = weights
    gen = audit.make_tiny_generator(device='cpu', params=params)
    assert gen.generate(audit._AUDIT_PROMPTS,
                        max_new_tokens=audit._AUDIT_MAX_NEW) == \
        jax_counts['gen_tokens']
    assert len(gen.graphs.distinct('decode')) == jax_counts['gen_decode'] == 1
    rep = audit.audit_generator_decode(device='cpu', params=params)
    assert rep['compiles'] == jax_counts['gen_decode']

    b = audit.make_tiny_batcher(device='cpu', params=params)
    assert _serve(b, audit._AUDIT_PROMPTS) == jax_counts['batcher_tokens']
    assert len(b.graphs.distinct('decode')) == jax_counts['batcher_decode']
    rep = audit.audit_batcher_decode(device='cpu', params=params)
    assert rep['compiles'] == jax_counts['batcher_decode']


def test_prefix_cache_and_block_pool_counts_equal_the_jax_engine(
        weights, jax_counts):
    from skypilot_tpu_torch.infer import prefix_cache
    _, _, params = weights
    g = audit._prefix_generator('cpu', None, params)
    with audit._calls(prefix_cache, 'install_prefix') as installs, \
            audit._calls(g, '_prefill') as prefills:
        tokens = [g.generate(audit._PREFIX_PROMPTS,
                             max_new_tokens=audit._AUDIT_MAX_NEW)
                  for _ in range(2)]
    want = jax_counts['prefix']
    assert tokens == jax_counts['prefix_tokens']
    assert dict(decode=len(g.graphs.distinct('decode')),
                install=len(installs),
                prefill=len({a[0].shape[-1] for a in prefills}),
                hits=g.prefix.hits, misses=g.prefix.misses,
                tokens_saved=g.prefix.tokens_saved,
                shares=g.pool.prefix_shares) == want
    assert want['hits'] > 0 and want['shares'] > 0 and want['install'] == 0
    rep = audit.audit_prefix_cache(device='cpu', params=params)
    assert (rep['decode_compiles'], rep['install_compiles']) == \
        (want['decode'], want['install'])
    rep = audit.audit_block_pool(device='cpu', params=params)
    assert (rep['decode_compiles'], rep['prefill_compiles']) == \
        (want['decode'], want['prefill'])
    assert rep['pool']['prefix_shares'] == want['shares']


def test_spec_and_fused_counts_equal_the_jax_engines(weights, jax_counts):
    _, _, params = weights
    s = audit.make_tiny_generator(device='cpu', params=params, spec_k=3)
    tokens = [s.generate(audit._SPEC_PROMPTS,
                         max_new_tokens=audit._AUDIT_MAX_NEW)
              for _ in range(2)]
    assert tokens == jax_counts['spec_tokens']
    assert dict(verify=len(s.graphs.distinct('verify')),
                decode=len(s.graphs.distinct('decode'))) == \
        jax_counts['spec']
    rep = audit.audit_spec_decode(device='cpu', params=params)
    assert (rep['verify_compiles'], rep['decode_compiles']) == \
        (jax_counts['spec']['verify'], jax_counts['spec']['decode'])

    f = audit.make_tiny_batcher(
        device='cpu', params=params, decode_chunk=4, batch_size=4,
        prompt_buckets=[8, 32], prefill_chunk=8, fuse_budget=6)
    assert _serve(f, audit._AUDIT_PROMPTS, [(list(range(2, 26)), 8)]) == \
        jax_counts['fused_tokens']
    assert dict(fused=len(f.graphs.distinct('decode', phase='fused')),
                steps=f._fuse_policy.stats.steps) == jax_counts['fused']
    rep = audit.audit_fused_step(device='cpu', params=params)
    assert (rep['compiles'], rep['fused_steps']) == \
        (jax_counts['fused']['fused'], jax_counts['fused']['steps'])


def test_kv_tier_and_disagg_counts_equal_the_jax_engines(weights,
                                                         jax_counts):
    _, _, params = weights
    b = audit.make_tiny_batcher(
        device='cpu', params=params, prefix_cache_mb=0.02, prefix_block=8,
        prompt_buckets=[32], host_tier_mb=4.0)
    try:
        assert _kv_tier_churn(b, b.config.vocab_size) == \
            jax_counts['tier_tokens']
        st = b._tier.stats()
        got = dict(gather=len(b._tier.copy_shapes['gather']),
                   scatter=len(b._tier.copy_shapes['scatter']),
                   decode=len(b.graphs.distinct('decode')),
                   spills=st['spills'], prefetches=st['prefetches'])
    finally:
        b.close()
    assert got == jax_counts['tier']
    assert got['spills'] > 0 and got['prefetches'] > 0
    rep = audit.audit_kv_tier(device='cpu', params=params)
    assert (rep['gather_compiles'], rep['scatter_compiles'],
            rep['decode_compiles']) == (got['gather'], got['scatter'],
                                        got['decode'])
    rep = audit.audit_disagg(device='cpu', params=params)
    assert all(c['status'] == 'ok' for c in rep['checks']), rep['checks']
    for layout in ('model', 'int8'):
        counts = rep['layouts'][layout]
        assert (counts['gather_compiles'], counts['scatter_compiles']) == \
            (1, 1)
        assert counts['exported_tokens'] == 16


def test_disagg_greedy_tokens_equal_the_jax_handoff(weights):
    """audit_disagg's greedy parity check compares the port's handoff to
    its own single-pool run; here the single-pool tokens also equal the
    JAX batcher's, for both layouts."""
    from skypilot_tpu.analysis import audit as j_audit
    from skypilot_tpu.infer.serving import ContinuousBatcher as JBatcher
    jp, jcfg, params = weights
    rng = np.random.default_rng(7)
    prompt = [int(t) for t in rng.integers(1, jcfg.vocab_size, size=24)]
    for kv in (None, 'int8'):
        kw = dict(prefix_cache_mb=0.5, prefix_block=8, prompt_buckets=[32],
                  host_tier_mb=4.0, kv_cache_dtype=kv)
        j = JBatcher(jp, jcfg, j_audit._tiny_gen_config(**kw),
                     decode_chunk=8)
        p = audit.make_tiny_batcher(device='cpu', params=params, **kw)
        try:
            want = _serve(j, [prompt])
            assert _serve(p, [prompt]) == want, kv
        finally:
            j.close()
            p.close()


# ---- negative cases ---------------------------------------------------------

def test_two_stray_decode_keys_breach_the_budget():
    gen = audit.make_tiny_generator(device='cpu')
    for stray_n in (3, 5):
        gen._chunk(gen.pool.arena, stray_n)
    report = audit.audit_generator_decode(gen)
    by_name = {c['name']: c for c in report['checks']}
    assert report['compiles'] == 3
    assert by_name['compile_per_bucket']['status'] == 'fail'
    assert all(c['status'] != 'fail' for c in report['checks']
               if c['name'] != 'compile_per_bucket')


def _broken_generator(monkeypatch, defect):
    real = audit.make_tiny_generator

    def make(*args, **kwargs):
        gen = real(*args, **kwargs)
        impl = gen._decode_chunk_impl

        def bad(token, cache, *rest):
            defect(token, cache)
            return impl(token, cache, *rest)
        gen._decode_chunk_impl = bad
        return gen
    monkeypatch.setattr(audit, 'make_tiny_generator', make)
    report = audit.run_audit(['generator_decode'], device='cpu')
    assert not report['ok']
    (entry,) = report['entries']
    return {c['name']: c for c in entry['checks'] if c['status'] == 'fail'}


def test_a_host_read_in_the_chunk_fails_no_callbacks(monkeypatch):
    fails = _broken_generator(monkeypatch,
                              lambda token, cache: int(token[0]))
    assert set(fails) == {'no_callbacks'}
    assert '_local_scalar_dense' in fails['no_callbacks']['detail']


def test_a_host_constant_read_is_not_a_host_read():
    """The taint: .item() of a tensor made from host values inside the
    region (the optimizer's _in_dtype does this) reads nothing off the
    device."""
    x = torch.ones(3)
    with audit.checked([x]) as trace:
        torch.tensor(0.5).item()
        (x * 2).sum()
    assert not trace.host_reads
    with audit.checked([x]) as trace:
        (x * 2).sum().item()
    assert trace.host_reads == ['aten._local_scalar_dense.default']


def test_an_f64_cast_fails_no_f64(monkeypatch):
    fails = _broken_generator(monkeypatch,
                              lambda token, cache: token.to(torch.float64))
    assert set(fails) == {'no_f64'}


def test_a_shadow_arena_copy_fails_donation(monkeypatch):
    fails = _broken_generator(monkeypatch,
                              lambda token, cache: cache['k'].clone())
    assert set(fails) == {'donation'}
    assert 'shadow' in fails['donation']['detail']


def test_run_audit_turns_an_exception_into_a_failed_trace(monkeypatch):
    def boom(**kwargs):
        raise RuntimeError('engine refused')
    monkeypatch.setattr(audit, 'make_tiny_batcher', boom)
    report = audit.run_audit(['batcher_decode', 'ring_attention'],
                             device='cpu')
    assert not report['ok']
    first, second = report['entries']
    assert first['checks'] == [{
        'name': 'trace', 'status': 'fail',
        'detail': 'entry point failed to run: RuntimeError: engine '
                  'refused'}]
    assert all(c['status'] == 'ok' for c in second['checks'])


@pytest.fixture(scope='module')
def pool2():
    from _torch_ranks import RankPool
    p = RankPool(2)
    yield p
    p.close()


def test_mesh_decode_on_two_ranks_and_an_extra_all_reduce(pool2, weights):
    import _torch_ranks
    cfg = audit._tiny_config('cpu')
    cfg_kw = dict(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                  n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                  n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                  max_seq_len=cfg.max_seq_len, remat=False)
    tree = _torch_ranks._tree_np(weights[2])
    clean = pool2.run('audit_mesh_case', tree=tree, cfg_kw=cfg_kw)
    for rep in clean:
        assert [c['name'] for c in rep['checks']] == \
            REFERENCE_CHECKS['mesh_decode']
        assert all(c['status'] == 'ok' for c in rep['checks']), rep['checks']
        assert rep['allreduce_per_layer'] == 2
        assert rep['ring_collective_permutes_per_layer'] == 4
        assert rep['compiles'] == 1 and rep['verify_compiles'] == 1
    broken = pool2.run('audit_mesh_case', tree=tree, cfg_kw=cfg_kw,
                       extra_combine=True)
    for rep in broken:
        status = {c['name']: c['status'] for c in rep['checks']}
        assert status['collective_budget'] == 'fail'
        assert rep['allreduce_per_layer'] == 3
        assert [k for k, v in status.items() if v == 'fail'] == \
            ['collective_budget']


# ---- graph_budgets: chip_smoke.py's read-off of served batchers -------------

def _serve_mixed(b):
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, 100, size=n)]
               for n in (5, 12, 30, 3)]
    rids = [b.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, (10, 6, 8, 12))]
    b.run_until_idle()
    return [b.result(r) for r in rids]


def test_graph_budgets_of_served_batchers():
    b = audit.make_tiny_batcher(device='cpu', decode_chunk=4, batch_size=3,
                                spec_k=3, fuse_budget=8, prefill_chunk=16,
                                prompt_buckets=[16, 32])
    before = audit.addresses(b)
    _serve_mixed(b)
    got = audit.graph_budgets(b, before)
    assert got['ok'], got
    assert got['verify_keys'] == 1 and 1 <= got['decode_keys'] <= 2
    assert 1 <= got['fused_keys'] <= 2 and got['moved'] == []

    legacy = audit.make_tiny_batcher(device='cpu', decode_chunk=4,
                                     decode_impl='inplace',
                                     prompt_buckets=[16, 32])
    before = audit.addresses(legacy)
    _serve_mixed(legacy)
    got = audit.graph_budgets(legacy, before)
    assert got['ok'], got
    migrations = sum(legacy.migrations.values())
    assert migrations > 0 and got['visits'] == migrations + 1
    assert max(got['decode_keys_per_visit']) <= 2


def test_graph_budgets_catch_a_recapture_and_a_moved_buffer():
    b = audit.make_tiny_batcher(device='cpu', decode_chunk=4,
                                prompt_buckets=[16, 32])
    before = audit.addresses(b)
    _serve_mixed(b)
    b.graphs._keys.clear()          # graphs lost without a clear
    _serve_mixed(b)
    got = audit.graph_budgets(b, before)
    assert not got['ok'] and 'captured twice' in got['failures'][0]
    b._tables_dev = b._tables_dev.clone()
    got = audit.graph_budgets(b, before)
    assert got['moved'] == ['tables']


def test_key_log_over_chunk_graphs_counts_captures_and_seeds_keys():
    class Card:
        def eager(self, body):
            return body()

        def capture(self, body):
            out = body()
            return types.SimpleNamespace(replay=lambda: None), out

        def clear(self):
            pass

    graphs = ChunkGraphs(torch.device('cpu'), backend=Card())
    graphs.run(('decode', 4), lambda: torch.zeros(1))
    log = audit.KeyLog(graphs)
    assert 'ChunkGraphs' in log.counted_by
    log.run(('decode', 4), lambda: torch.zeros(1))
    log.run(('verify',), lambda: torch.zeros(1))
    assert [e[0] for e in log.events] == ['seed', 'replay', 'capture']
    assert log.distinct('decode') == [('decode', 4)]
    assert log.captures == graphs.captures == 2 and log.replays == 1


# ---- the entry point --------------------------------------------------------

def test_cli_json_run_as_a_child():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.analysis', '--audit',
         '--json', '--device', 'cpu'],
        capture_output=True, text=True, cwd=ROOT, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout)
    assert out['ok'] and out['new'] == []
    assert [e['entry'] for e in out['audit']['entries']] == \
        list(audit.REGISTRY)
