"""The port's serving telemetry (skypilot_tpu_torch/telemetry: trace,
spans, metrics; the batcher's and the Generator's instrumentation) on the
CPU, held against the JAX package.

What must hold:
- the copies behave as the reference modules on the same calls:
  SpanBuffer (records, ring wrap, Perfetto events, the merged export file
  byte for byte), the span gate, StepProfiler on a tick clock (phases,
  nesting, reattribute), trace_scope and propagation_envs;
  telemetry/spans.py imports without the ``filelock`` package;
- the port's INFER_* and ACCT_* families (INFER_MESH_* included) have
  the reference's names, types, labels and buckets, and
  histogram_quantile gives the reference's estimates;
- the JAX and port Generator and ContinuousBatcher move the same metric
  deltas on the same workload (generated tokens, host syncs, prefill and
  decode-chunk counts, queue waits, occupancy back to 0);
- the two batchers emit the same spans, name for name and request for
  request, with the same attributes, on pooled, spec, fused, chunked and
  prefix-hit traffic;
- greedy tokens and host syncs a decode chunk are the same with spans
  and a ledger on as with them off.

At LLAMA_DEBUG (2 layers, f32), weights from one JAX draw
(llama.params_from_numpy); tokens identical (greedy, f32).  The metric
registries are process-global: every check reads deltas.
"""
import collections
import itertools
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.metrics import REGISTRY as J_REGISTRY  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.telemetry import metrics as j_metrics  # noqa: E402
from skypilot_tpu.telemetry import spans as j_spans  # noqa: E402
from skypilot_tpu.telemetry import trace as j_trace  # noqa: E402
from skypilot_tpu_torch.infer import engine  # noqa: E402
from skypilot_tpu_torch.infer.engine import (  # noqa: E402
    Generator, GeneratorConfig)
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.telemetry import accounting  # noqa: E402
from skypilot_tpu_torch.telemetry import metrics  # noqa: E402
from skypilot_tpu_torch.telemetry import spans  # noqa: E402
from skypilot_tpu_torch.telemetry import trace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = llama.LLAMA_DEBUG
J_CFG = j_llama.LLAMA_DEBUG
# A shared 16-token head (prefix hits) and mixed lengths: 40 > the
# chunked-prefill window of 16.
HEAD = [((7 * i) % 500) + 3 for i in range(16)]
PROMPTS = [[5, 9, 2, 7], HEAD + [11, 12], [((3 * i) % 400) + 1
                                           for i in range(40)],
           HEAD + [13], [21, 22, 23]]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def models():
    jp = j_llama.init_params(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, llama.params_from_numpy(tree, CFG, 'cpu')


def _both(**kw):
    base = dict(max_seq_len=128, batch_size=2, temperature=0.0,
                prompt_buckets=[16, 32, 64], decode_chunk=4)
    base.update(kw)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        return j_engine.GeneratorConfig(**base), GeneratorConfig(**base)


def _run(b, prompts=PROMPTS, max_new=6, tenants=None):
    rids = [b.submit(p, max_new_tokens=max_new,
                     **({'tenant': tenants[i]} if tenants else {}))
            for i, p in enumerate(prompts)]
    b.run_until_idle()
    return [b.result(r) for r in rids]


def _tick_clock():
    ticks = itertools.count(1)
    return lambda: float(next(ticks))


# ---- the copied modules, call for call -------------------------------------

def _span_script(mod, path):
    buf = mod.SpanBuffer(capacity=3, clock=_tick_clock(), pid=7, tid=1)
    buf.record('a', 1.0, 2.0, trace_id='t1', request_id=4, k=3)
    buf.record('b', 0.5, 0.5)
    with buf.span('c', trace_id='t2', mode='cold'):
        pass
    buf.record('d', 9.0, 9.5, request_id=0)     # wraps: 'a' drops
    n = buf.export(path)
    n += buf.export(path, extra_events=[
        {'name': 'x', 'ph': 'X', 'ts': 1.0, 'dur': 2.0, 'pid': 1,
         'tid': 0}])
    return buf.snapshot(), buf.events(), buf.dropped, len(buf), n


def test_span_buffer_matches_reference(tmp_path):
    got = _span_script(spans, str(tmp_path / 'port' / 'trace.json'))
    want = _span_script(j_spans, str(tmp_path / 'jax' / 'trace.json'))
    assert got == want
    assert (tmp_path / 'port' / 'trace.json').read_bytes() == \
        (tmp_path / 'jax' / 'trace.json').read_bytes()
    assert (tmp_path / 'port' / 'trace.json.lock').exists()
    with pytest.raises(ValueError):
        spans.SpanBuffer(capacity=0)


def test_span_gate_and_flush_match_reference(monkeypatch, tmp_path):
    for mod in (spans, j_spans):
        monkeypatch.delenv(mod.ENV_VAR, raising=False)
        monkeypatch.delenv(mod.TIMELINE_ENV_VAR, raising=False)
    assert (spans.ENV_VAR, spans.TIMELINE_ENV_VAR) == \
        (j_spans.ENV_VAR, j_spans.TIMELINE_ENV_VAR)
    assert spans.enabled() is j_spans.enabled() is False
    monkeypatch.setenv('SKYTPU_SPANS', '1')
    assert spans.enabled() and j_spans.enabled()
    spans.set_enabled(False)
    try:
        assert not spans.enabled()
        spans.record('off', 0.0, 1.0)            # gated: dropped
        assert len(spans.default_buffer()) == 0
    finally:
        spans.set_enabled(None)
    path = tmp_path / 'timeline.json'
    monkeypatch.setenv('SKYTPU_TIMELINE_FILE', str(path))
    with spans.span('on', request_id=3):
        pass
    spans.flush()
    spans.flush()                                # drained: no duplicate
    events = json.loads(path.read_text())['traceEvents']
    assert [e['name'] for e in events] == ['on']
    assert len(spans.default_buffer()) == 0


def _profile(mod):
    prof = mod.StepProfiler(clock=_tick_clock())
    with prof.phase('outside'):             # inert before start()
        pass
    prof.start()
    with prof.phase('admit'):
        with prof.phase('prefill'):
            with prof.phase('host_fetch'):
                pass
    with prof.phase('decode'):
        pass
    with prof.phase('decode'):
        with prof.phase('host_fetch'):
            pass
    moved = prof.reattribute('decode', 'collective', 0.25)
    none = prof.reattribute('fused', 'collective', 0.5)
    phases = prof.finish()
    return phases, prof.last_wall, moved, none, prof.finish()


def test_step_profiler_matches_reference_on_a_tick_clock():
    assert _profile(spans) == _profile(j_spans)
    assert spans.STEP_PHASES == j_spans.STEP_PHASES


def test_trace_context_matches_reference(monkeypatch, tmp_path):
    assert (trace.ENV_VAR, trace.TRACE_HEADER, trace.PAYLOAD_KEY) == \
        (j_trace.ENV_VAR, j_trace.TRACE_HEADER, j_trace.PAYLOAD_KEY)
    for var in (trace.ENV_VAR, 'SKYTPU_TIMELINE_FILE', 'SKYTPU_PROFILE_DIR'):
        monkeypatch.delenv(var, raising=False)
    assert trace.propagation_envs() == j_trace.propagation_envs() == {}
    monkeypatch.setenv('SKYTPU_TIMELINE_FILE', 'rel/trace.json')
    monkeypatch.setenv('SKYTPU_PROFILE_DIR', '~/prof')
    with trace.trace_scope('abc123'), j_trace.trace_scope('abc123'):
        assert trace.propagation_envs() == j_trace.propagation_envs()
        assert trace.propagation_envs()[trace.ENV_VAR] == 'abc123'
    monkeypatch.setenv(trace.ENV_VAR, 'from-env')
    with trace.trace_scope('outer'):
        with trace.trace_scope(None):
            assert trace.get_trace_id() == 'outer'
    assert trace.get_trace_id() == j_trace.get_trace_id() == 'from-env'
    assert len(trace.new_trace_id()) == len(j_trace.new_trace_id()) == 16


def test_spans_module_imports_without_filelock():
    code = ('import sys\n'
            "sys.modules['filelock'] = None\n"
            'from skypilot_tpu_torch.telemetry import spans\n'
            "print(spans.SpanBuffer().export.__name__)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'export'


# ---- metric families ---------------------------------------------------------

def _families(mod, prefixes):
    return {n: getattr(mod, n) for n in dir(mod)
            if n.startswith(prefixes) and hasattr(getattr(mod, n), '_name')}


def test_infer_and_acct_families_match_reference():
    got = _families(metrics, ('INFER_', 'ACCT_'))
    want = _families(j_metrics, ('INFER_', 'ACCT_'))
    assert sorted(got) == sorted(want)
    for name, fam in got.items():
        ref = want[name]
        assert (fam._name, fam._type, fam._labelnames) == \
            (ref._name, ref._type, ref._labelnames), name
        assert getattr(fam, '_upper_bounds', None) == \
            getattr(ref, '_upper_bounds', None), name
    for family in metrics.REGISTRY.collect():
        assert family.name.startswith('skytpu_'), family.name


def test_histogram_quantile_matches_reference():
    import prometheus_client
    hists = []
    for mod in (metrics, j_metrics):
        reg = prometheus_client.CollectorRegistry()
        h = prometheus_client.Histogram('q_test_seconds', 'q', ['k'],
                                        buckets=(0.01, 0.05, 0.25, 1),
                                        registry=reg)
        for v, k in ((0.01, 'a'), (0.02, 'a'), (0.02, 'b'), (0.2, 'a'),
                     (7.0, 'b')):
            h.labels(k=k).observe(v)
        hists.append((mod, h))
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        for labels in (None, {'k': 'a'}, {'k': 'b'}, {'k': 'none'}):
            got, want = (mod.histogram_quantile(h, q, labels)
                         for mod, h in hists)
            assert got == want, (q, labels)


# ---- metric deltas of the engines --------------------------------------------

def _sample(registry, name, labels=None):
    return registry.get_sample_value(name, labels or {}) or 0.0


ENGINE_SAMPLES = (
    ('skytpu_infer_generated_tokens_total', None),
    ('skytpu_infer_host_syncs_total', None),
    ('skytpu_infer_decode_chunk_duration_seconds_count', None),
    ('skytpu_infer_prefill_duration_seconds_count', {'bucket': '16'}),
    ('skytpu_infer_prefill_duration_seconds_count', {'bucket': '64'}),
    ('skytpu_infer_decode_bucket_chunks_total', {'bucket': '128'}),
    ('skytpu_infer_queue_wait_seconds_count', None),
    ('skytpu_infer_spec_proposed_tokens_total', None),
    ('skytpu_infer_spec_accepted_tokens_total', None),
    ('skytpu_infer_fuse_steps_total', None),
    ('skytpu_infer_fuse_prefill_tokens_total', None),
    ('skytpu_infer_fuse_ttft_seconds_count', {'mode': 'cold'}),
    ('skytpu_infer_fuse_ttft_seconds_count', {'mode': 'fused'}),
    ('skytpu_infer_step_phase_seconds_count', {'phase': 'decode'}),
    ('skytpu_infer_step_phase_seconds_count', {'phase': 'prefill'}),
    ('skytpu_infer_step_phase_seconds_count', {'phase': 'host_fetch'}),
    ('skytpu_infer_step_phase_seconds_count', {'phase': 'admit'}),
    ('skytpu_infer_step_phase_seconds_count', {'phase': 'fused'}),
    ('skytpu_infer_step_phase_seconds_count', {'phase': 'spec_verify'}),
    ('skytpu_infer_cache_migrations_total', {'direction': 'grow'}),
    ('skytpu_infer_cache_migrations_total', {'direction': 'shrink'}),
)


def _deltas(registry, run):
    before = [_sample(registry, n, l) for n, l in ENGINE_SAMPLES]
    out = run()
    after = [_sample(registry, n, l) for n, l in ENGINE_SAMPLES]
    return out, {f'{n}{l or ""}': a - b for (n, l), a, b in
                 zip(ENGINE_SAMPLES, after, before)}


@pytest.mark.parametrize('kw', [dict(), dict(decode_impl='paged'),
                                dict(spec_k=3)],
                         ids=['pooled', 'paged', 'spec'])
def test_generator_moves_the_reference_metric_deltas(models, kw):
    jp, tp = models
    jc, tc = _both(batch_size=4, **kw)
    prompts = [[5, 9, 2, 7], [11, 3], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jgen = j_engine.Generator(jp, J_CFG, jc)
        gen = Generator(tp, CFG, tc, device='cpu')
        want, jd = _deltas(J_REGISTRY, lambda: jgen.generate(
            prompts, max_new_tokens=9))
        got, d = _deltas(metrics.REGISTRY, lambda: gen.generate(
            prompts, max_new_tokens=9))
    assert got == want
    assert d == jd
    assert d['skytpu_infer_generated_tokens_total'] == \
        sum(map(len, got)) == gen.last_stats['generated_tokens']
    assert d['skytpu_infer_host_syncs_total'] == \
        gen.last_stats['host_fetches']
    assert _sample(metrics.REGISTRY,
                   'skytpu_infer_steady_tokens_per_second') > 0


BATCHER_CASES = {
    'pooled': dict(),
    'chunked': dict(prefill_chunk=16),
    'spec': dict(spec_k=3),
    'fused': dict(prefill_chunk=16, fuse_budget=8),
    'prefix': dict(prefix_cache_mb=4, prefix_block=8),
    'paged': dict(decode_impl='paged', prefill_chunk=16),
}


@pytest.mark.parametrize('case', sorted(BATCHER_CASES))
def test_batcher_moves_the_reference_metric_deltas(models, case):
    jp, tp = models
    jc, tc = _both(**BATCHER_CASES[case])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jb = j_serving.ContinuousBatcher(jp, J_CFG, jc, decode_chunk=4)
        b = ContinuousBatcher(tp, CFG, tc, decode_chunk=4, device='cpu')
        want, jd = _deltas(J_REGISTRY, lambda: _run(jb))
        got, d = _deltas(metrics.REGISTRY, lambda: _run(b))
    b.close()
    assert got == want
    assert d == jd
    assert d['skytpu_infer_queue_wait_seconds_count'] == len(PROMPTS)
    assert d['skytpu_infer_generated_tokens_total'] == sum(map(len, got)) \
        - len(PROMPTS)                 # the first tokens come from prefill
    assert _sample(metrics.REGISTRY,
                   'skytpu_infer_slot_occupancy_ratio') == 0.0
    if b.pooled:
        assert _sample(metrics.REGISTRY, 'skytpu_infer_pool_blocks_total') \
            == b.pool.n_blocks
        assert b.backpressure_retries == jb.backpressure_retries


# ---- spans of the two batchers ------------------------------------------------

def _span_record(buf):
    """Each span as (name, request id, trace id, attrs), in order."""
    return [(s['name'], s.get('request_id'), s.get('trace_id'),
             json.dumps(s.get('attrs', {}), sort_keys=True))
            for s in buf.snapshot()]


@pytest.mark.parametrize('case', sorted(BATCHER_CASES))
def test_batchers_emit_the_same_spans(models, case):
    jp, tp = models
    jc, tc = _both(**BATCHER_CASES[case])
    jbuf = j_spans.SpanBuffer(clock=_tick_clock())
    buf = spans.SpanBuffer(clock=_tick_clock())
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jb = j_serving.ContinuousBatcher(jp, J_CFG, jc, decode_chunk=4,
                                         span_buffer=jbuf,
                                         span_clock=jbuf.clock)
        b = ContinuousBatcher(tp, CFG, tc, decode_chunk=4, device='cpu',
                              span_buffer=buf, span_clock=buf.clock)
        with trace.trace_scope('req-trace'), \
                j_trace.trace_scope('req-trace'):
            want = _run(jb)
            got = _run(b)
    b.close()
    assert got == want
    assert _span_record(buf) == _span_record(jbuf)
    per_request = collections.defaultdict(collections.Counter)
    for s in buf.snapshot():
        if s.get('request_id') is not None:
            per_request[s['request_id']][s['name']] += 1
    chunk = BATCHER_CASES[case].get('prefill_chunk')
    for rid, names in per_request.items():
        assert names['queue_wait'] == names['delivery'] == 1, names
        prompt = PROMPTS[rid - 1]
        if case == 'pooled' or (case == 'chunked' and len(prompt) <= chunk):
            assert names['prefill_chunk'] == 1
        elif case == 'chunked':
            assert names['prefill_chunk'] == -(-len(prompt) // chunk)
    assert all(s.get('trace_id') == 'req-trace' for s in buf.snapshot()
               if s.get('request_id') is not None)


def test_spans_and_ledger_change_no_token_and_no_sync(models):
    """Greedy tokens and the host fetches a decode chunk are the same
    with a span buffer and a cost ledger attached as without."""
    _, tp = models
    _, tc = _both(prefill_chunk=16, spec_k=3)
    runs = []
    for on in (False, True):
        extra = (dict(span_buffer=spans.SpanBuffer(),
                      ledger=accounting.CostLedger()) if on else {})
        b = ContinuousBatcher(tp, CFG, tc, decode_chunk=4, device='cpu',
                              **extra)
        calls0 = engine.host_fetch.calls
        chunks0 = _sample(metrics.REGISTRY,
                          'skytpu_infer_decode_chunk_duration_seconds_count')
        out = _run(b, tenants=['a', 'b', 'a', 'b', 'a'])
        chunks = _sample(
            metrics.REGISTRY,
            'skytpu_infer_decode_chunk_duration_seconds_count') - chunks0
        runs.append((out, engine.host_fetch.calls - calls0, chunks))
        if on:
            assert len(extra['span_buffer']) > 0
            assert extra['ledger'].steps > 0
    assert runs[0] == runs[1]


def test_collective_share_names_its_roadmap_item(models):
    """set_collective_share (ROADMAP item 10) is carried: it checks its
    range as the reference's does, and without a mesh of more than one
    rank it moves nothing (its effect on a sharded batcher:
    tests/test_torch_tp.py)."""
    jp, tp = models
    jc, tc = _both()
    b = ContinuousBatcher(tp, CFG, tc, device='cpu')
    jb = j_serving.ContinuousBatcher(jp, J_CFG, jc)
    for batcher in (b, jb):
        with pytest.raises(ValueError, match=r'must be in \[0, 1\]'):
            batcher.set_collective_share(1.5)
        batcher.set_collective_share(0.3)
    rid = b.submit([5, 9, 2], max_new_tokens=3)
    b.run_until_idle()
    assert 'collective' not in b._profiler.last_phases
    assert len(b.result(rid)) == 3
