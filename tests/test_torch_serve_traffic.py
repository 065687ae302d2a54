"""The port's fleet modules on the CPU, held against the JAX package on
the same seeds and inputs: utils/backoff.py, serve/serve_state.py's
ReplicaStatus, serve/traffic/hashring.py and generator.py,
serve/load_balancing_policies.py, serve/slo.py, serve/failover.py,
serve/autoscalers.py, serve/disagg.py's HandoffScheduler and
RoleAwareSLOAutoscaler, and the fleet's metric families.

What must hold (exactly, unless stated):
- stable_hash, and ring owner walks over joins, leaves and removals;
- generate_trace, arrival for arrival, for several seeds, with tenants
  and burst_session_share among them;
- each policy's selection sequence under the same route seed and the same
  in-flight updates, prefix_affinity's churn remap among them;
- SLOMonitor burn rates over one scripted sample stream, within 1e-12;
- each autoscaler's decisions, info and dump/load over one scripted
  report stream, given the JAX package's ServiceSpec;
- the breaker's transitions and the journal's replay specs over fault
  plans drawn by tests/chaos/serve_faults.py;
- the Backoff schedule, with and without jitter;
- HandoffScheduler targets and RoleAwareSLOAutoscaler decisions;
- the new metric families' names, types, labels and buckets.

Both packages' policies and Backoff draw from the module ``random``: each
side runs after random.seed(the same seed).
"""
import dataclasses
import random
import types

import pytest

pytest.importorskip('torch')

from skypilot_tpu.serve import autoscalers as j_asc  # noqa: E402
from skypilot_tpu.serve import disagg as j_disagg  # noqa: E402
from skypilot_tpu.serve import failover as j_failover  # noqa: E402
from skypilot_tpu.serve import load_balancing_policies as j_lbp  # noqa: E402
from skypilot_tpu.serve import serve_state as j_state  # noqa: E402
from skypilot_tpu.serve import slo as j_slo  # noqa: E402
from skypilot_tpu.serve.service_spec import ServiceSpec  # noqa: E402
from skypilot_tpu.serve.traffic import generator as j_gen  # noqa: E402
from skypilot_tpu.serve.traffic import hashring as j_ring  # noqa: E402
from skypilot_tpu.telemetry import metrics as j_metrics  # noqa: E402
from skypilot_tpu.utils import backoff as j_backoff  # noqa: E402
from skypilot_tpu_torch.serve import autoscalers as asc  # noqa: E402
from skypilot_tpu_torch.serve import disagg  # noqa: E402
from skypilot_tpu_torch.serve import failover  # noqa: E402
from skypilot_tpu_torch.serve import \
    load_balancing_policies as lbp  # noqa: E402
from skypilot_tpu_torch.serve import serve_state  # noqa: E402
from skypilot_tpu_torch.serve import slo  # noqa: E402
from skypilot_tpu_torch.serve import traffic  # noqa: E402
from skypilot_tpu_torch.serve.traffic import generator as gen  # noqa: E402
from skypilot_tpu_torch.serve.traffic import hashring as ring  # noqa: E402
from skypilot_tpu_torch.telemetry import metrics  # noqa: E402
from skypilot_tpu_torch.utils import backoff  # noqa: E402
from tests.chaos import serve_faults  # noqa: E402


def _both(fn, seed=0):
    """fn(jax_modules) and fn(port_modules), each after random.seed."""
    j = types.SimpleNamespace(lbp=j_lbp, ring=j_ring, gen=j_gen, slo=j_slo,
                              asc=j_asc, failover=j_failover,
                              backoff=j_backoff, disagg=j_disagg,
                              state=j_state)
    p = types.SimpleNamespace(lbp=lbp, ring=ring, gen=gen, slo=slo, asc=asc,
                              failover=failover, backoff=backoff,
                              disagg=disagg, state=serve_state)
    state = random.getstate()
    try:
        random.seed(seed)
        want = fn(j)
        random.seed(seed)
        got = fn(p)
    finally:
        random.setstate(state)
    return got, want


# ---- hash ring ----------------------------------------------------------

def test_stable_hash_equal():
    keys = ['', 'abc', 'replica-0#3', ','.join(map(str, range(64)))]
    keys += [f'prompt-{i}' for i in range(200)]
    keys += [b'\x00\x01', bytes(range(256))]
    assert [ring.stable_hash(k) for k in keys] == \
        [j_ring.stable_hash(k) for k in keys]
    assert ring.DEFAULT_VNODES == j_ring.DEFAULT_VNODES == 64


def test_ring_walks_equal_over_joins_leaves_and_removals():
    def walk(m):
        r = m.ring.ConsistentHashRing()
        keys = [m.ring.stable_hash(f'k{i}') for i in range(300)]
        log = []

        def snap():
            log.append((r.members, [r.primary(k) for k in keys],
                        [list(r.owners(k)) for k in keys[:40]],
                        [r.prefetch_target(k, exclude={'r1', 'r4'})
                         for k in keys[:40]]))
        r.set_members([f'r{i}' for i in range(6)])
        snap()
        r.set_members([f'r{i}' for i in range(7)])       # join
        snap()
        r.remove_member('r3')                              # death
        snap()
        r.remove_member('r3')                              # unknown: no-op
        r.add_member('r3')                                 # heal
        snap()
        r.set_members(['r0', 'r2', 'r5'])                  # leaves
        snap()
        small = m.ring.ConsistentHashRing(vnodes=8)
        small.set_members(['a', 'b', 'c', 'd'])
        h = m.ring.stable_hash('head')
        log.append((small.prefetch_target(h, exclude={'a', 'b', 'c', 'd'}),
                    small.prefetch_target(h), list(small.owners(h))))
        return log
    got, want = _both(walk)
    assert got == want


# ---- traffic generator --------------------------------------------------

TRACES = [dict(seed=0), dict(seed=3, duration_s=20.0),
          dict(seed=5, duration_s=30.0, session_share=0.75),
          dict(seed=11, duration_s=10.0, base_rps=8.0, num_sessions=8,
               num_heads=6, head_tokens=64, session_share=0.85),
          dict(seed=11, duration_s=10.0, base_rps=6.0, num_sessions=9,
               num_heads=6, head_tokens=48,
               tenants=('default', 'default', 'heavy')),
          dict(seed=13, duration_s=20.0, base_rps=4.0, session_share=0.6,
               burst_session_share=0.1, singleton_median=96,
               max_prompt_tokens=128)]


@pytest.mark.parametrize('kw', TRACES,
                         ids=[f'seed{k["seed"]}-{i}'
                              for i, k in enumerate(TRACES)])
def test_trace_equal_arrival_for_arrival(kw):
    got = gen.generate_trace(gen.TrafficConfig(**kw))
    want = j_gen.generate_trace(j_gen.TrafficConfig(**kw))
    assert len(got) == len(want) > 0
    assert [dataclasses.asdict(a) for a in got] == \
        [dataclasses.asdict(a) for a in want]


def test_traffic_validation_and_reexports():
    for bad in (dict(duration_s=0), dict(session_share=1.5),
                dict(burst_session_share=-0.1),
                dict(head_tokens=120, max_prompt_tokens=120),
                dict(tenants=())):
        with pytest.raises(ValueError):
            gen.TrafficConfig(**bad)
        with pytest.raises(ValueError):
            j_gen.TrafficConfig(**bad)
    assert traffic.generate_trace is gen.generate_trace
    assert traffic.stable_hash is ring.stable_hash
    assert traffic.SimConfig().policy == 'least_load'


# ---- load-balancing policies ---------------------------------------------

def _policy_script(m, name):
    if name == 'prefix_affinity':
        p = m.lbp.PrefixAffinityPolicy(prefix_block=8, load_factor=1.25)
    else:
        p = m.lbp.LoadBalancingPolicy.make(name)
    heads = [[i * 17 + j for j in range(8)] for i in range(12)]
    log = []
    p.set_ready_replicas([f'r{i}' for i in range(4)])
    rng = random.Random(7)        # the script's own draws, not the policy's
    for step in range(120):
        prompt = heads[rng.randrange(len(heads))] + [step]
        if step % 9 == 0:
            prompt = [1, 2, 3]    # no whole block: no fingerprint
        url = p.select_replica({'prompt': prompt},
                               exclude={'r2'} if step % 13 == 0 else None)
        log.append(url)
        if url is not None:
            p.pre_execute_hook(url)
        if step % 3 == 2:
            done = log[-3]
            if done is not None:
                p.post_execute_hook(done)
        if step == 60:            # churn: one joins, one leaves
            p.set_ready_replicas(['r0', 'r1', 'r3', 'r4'])
            log.append('churn')
        if step == 90:
            p.set_ready_replicas([f'r{i}' for i in range(6)])
    log.append(p.select_replica())
    extra = {}
    if name == 'prefix_affinity':
        extra = dict(hits=p.affinity_hits, misses=p.affinity_misses,
                     fp=[p.fingerprint(h) for h in heads],
                     text=(p.fingerprint('x' * 32), p.fingerprint('x' * 31)))
    if hasattr(p, 'load_map'):
        extra['load'] = dict(p.load_map)
    return log, extra


@pytest.mark.parametrize('name', ['round_robin', 'least_load',
                                  'prefix_affinity'])
@pytest.mark.parametrize('seed', [0, 5])
def test_policy_selection_sequences_equal(name, seed):
    got, want = _both(lambda m: _policy_script(m, name), seed)
    assert got == want
    assert len(set(u for u in got[0] if u not in (None, 'churn'))) > 1


def test_prefix_affinity_churn_remap_equal():
    def remap(m):
        p = m.lbp.PrefixAffinityPolicy(prefix_block=8)
        p.set_ready_replicas([f'r{i}' for i in range(4)])
        heads = [[i * 17 + j for j in range(8)] for i in range(200)]
        before = [p.select_replica({'prompt': h}) for h in heads]
        p.set_ready_replicas([f'r{i}' for i in range(5)])
        after = [p.select_replica({'prompt': h}) for h in heads]
        return before, after
    got, want = _both(remap)
    assert got == want
    moved = sum(1 for b, a in zip(*got) if b != a)
    assert 0 < moved / len(got[0]) < 0.5
    assert sorted(lbp.LB_POLICIES) == sorted(j_lbp.LB_POLICIES)
    assert lbp.DEFAULT_LB_POLICY == j_lbp.DEFAULT_LB_POLICY


# ---- SLO monitor ----------------------------------------------------------

def test_slo_burn_rates_equal():
    def script(m):
        mon = m.slo.SLOMonitor(m.slo.SLOConfig(
            ttft_target_s=0.5, tpot_target_s=0.05, objective=0.99,
            fast_window_s=5.0, slow_window_s=30.0))
        rng = random.Random(3)
        rates = []
        now = 0.0
        for i in range(400):
            now += rng.expovariate(8.0)
            if i % 3:
                mon.observe_ttft(rng.lognormvariate(-1.0, 0.8), now)
            else:
                mon.observe_tpot(rng.lognormvariate(-3.2, 0.5), now)
            if i % 7 == 0:
                rates.append(mon.burn_rates(now))
        rates.append(mon.burn_rates(now + 100.0))      # windows drained
        return rates, mon.samples_total, mon.violations_total
    (got, n, bad), (want, jn, jbad) = _both(script)
    assert (n, bad) == (jn, jbad) and bad > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert abs(g[k] - w[k]) <= 1e-12
    assert any(r['fast'] > 0 for r in got)
    assert slo.FAST_WINDOW_S == j_slo.FAST_WINDOW_S
    assert slo.SLOW_WINDOW_S == j_slo.SLOW_WINDOW_S


# ---- autoscalers ------------------------------------------------------------

def _infos(m, ready, failed=0, draining=0, spot=0):
    st = m.state.ReplicaStatus
    out = [{'replica_id': i + 1, 'status': st.READY, 'launched_at': float(i),
            'is_spot': i < spot, 'draining': i < draining}
           for i in range(ready)]
    out += [{'replica_id': 100 + i, 'status': st.FAILED,
             'launched_at': 50.0 + i, 'is_spot': False}
            for i in range(failed)]
    out += [{'replica_id': 200, 'status': st.STARTING, 'launched_at': 90.0,
             'is_spot': True}]
    return out


SPECS = {
    'fixed': dict(min_replicas=3),
    'rate': dict(min_replicas=1, max_replicas=4, target_qps_per_replica=1.0,
                 upscale_delay_seconds=20, downscale_delay_seconds=40),
    'slo': dict(min_replicas=1, max_replicas=4, target_p99_ttft_ms=500,
                upscale_delay_seconds=40, downscale_delay_seconds=40,
                target_queue_depth_per_replica=3),
    'fallback': dict(min_replicas=2, max_replicas=5,
                     target_qps_per_replica=1.0,
                     base_ondemand_fallback_replicas=1,
                     dynamic_ondemand_fallback=True),
    'fallback_fixed': dict(min_replicas=2, base_ondemand_fallback_replicas=1),
}


def _decisions(ds):
    return [(d.operator.value, d.target) for d in ds]


def _autoscaler_script(m, kind, now):
    spec = ServiceSpec(**SPECS[kind])
    a = m.asc.Autoscaler.from_spec('svc', spec)
    rng = random.Random(11)
    log = [type(a).__name__]
    for step in range(14):
        report = {'timestamps': [now - rng.uniform(0.0, 30.0)
                                 for _ in range(rng.randrange(0, 120))],
                  'ttft_ms': [rng.uniform(100.0, 1500.0)
                              for _ in range(rng.randrange(0, 20))],
                  'queue_depth': rng.choice([None, 0, 3, 16]),
                  'prefix_hit_ratio': rng.choice([None, 0.2, 0.9])}
        a.collect_request_information(report)
        ready = 1 + step % 4
        infos = _infos(m, ready, failed=step % 2, draining=step % 3 == 0,
                       spot=ready // 2)
        log.append((_decisions(a.generate_scaling_decisions(infos)),
                    a.target_num_replicas, a.get_decision_interval(),
                    a.info()))
        if step == 7:
            states = a.dump_dynamic_states()
            b = m.asc.Autoscaler.from_spec('svc', spec)
            b.load_dynamic_states(states)
            log.append((states, b.dump_dynamic_states()))
            a = b
    return log


@pytest.mark.parametrize('kind', sorted(SPECS))
def test_autoscaler_decisions_and_states_equal(kind, monkeypatch):
    now = 1_700_000_000.0
    clock = types.SimpleNamespace(time=lambda: now)
    monkeypatch.setattr(asc, 'time', clock)
    monkeypatch.setattr(j_asc, 'time', clock)
    got, want = _both(lambda m: _autoscaler_script(m, kind, now))
    assert got == want
    assert any(step[0] for step in got[1:] if isinstance(step[0], list))


def test_alive_capacity_and_victims_equal():
    for args in ((3, 1, 1, 0), (4, 0, 2, 2), (1, 2, 0, 1)):
        got, want = _both(lambda m: (
            [r['replica_id'] for r in m.asc.alive_capacity(_infos(m, *args))],
            m.asc.select_replicas_to_scale_down(_infos(m, *args), 2)))
        assert got == want
    assert [s.value for s in serve_state.ReplicaStatus] == \
        [s.value for s in j_state.ReplicaStatus]
    assert [s.value for s in
            serve_state.ReplicaStatus.scale_down_decision_order()] == \
        [s.value for s in j_state.ReplicaStatus.scale_down_decision_order()]
    for s in serve_state.ReplicaStatus:
        js = j_state.ReplicaStatus(s.value)
        assert (s.is_terminal(), s.is_failed()) == \
            (js.is_terminal(), js.is_failed())


# ---- breaker and journal over drawn fault plans -----------------------------

def _chaos_script(m, plan, n_replicas, duration):
    """A probe loop over `plan`: each tick every replica reports healthy
    or not, open circuits probe on the backoff schedule, and an opened
    circuit replays its sessions through the journal onto survivors."""
    cb = m.failover.CircuitBreaker(failure_threshold=2)
    journal = m.failover.SessionJournal()
    urls = [f'replica-{i}' for i in range(n_replicas)]
    for sid in range(2 * n_replicas):
        journal.open(sid, [sid, sid + 1, sid + 2], 90,
                     urls[sid % n_replicas])
    log = []
    t = 0.0
    while t < duration + 6.0:
        t = round(t + 0.25, 6)
        for i, url in enumerate(urls):
            bad = False
            for ev in plan:
                if ev.replica != i or t < ev.t:
                    continue
                if ev.kind == 'kill' or t < ev.t + ev.duration_s:
                    bad = True
            if _preempting(plan, i, t):
                cb.note_backpressure(url, t, 1.0)
            if cb.is_open(url):
                if cb.probe_due(url, t):
                    log.append(('probe', t, url, cb.note_success(url)
                                if not bad else cb.note_failure(url, t)))
                continue
            if not bad:
                cb.note_success(url)
            elif cb.note_failure(url, t):
                alive = [u for u in cb.routable(urls, t) if u != url]
                for sid in sorted(journal.sessions_on(url)):
                    spec = journal.replay_spec(sid)
                    log.append(('replay', t, sid, spec))
                    if alive:
                        journal.reassign(sid, alive[sid % len(alive)])
        for sid in range(2 * n_replicas):
            rec = journal.record(sid)
            if not rec.done and not cb.is_open(rec.replica):
                journal.commit(sid, [int(t * 4) % 97])
                if journal.replay_spec(sid) is None:
                    journal.close(sid)
        log.append((t, cb.snapshot(), cb.opens_total,
                    cb.routable(urls, t), cb.routable(urls, t, True)))
    log.append([(journal.record(s).committed, journal.record(s).replica,
                 journal.record(s).failovers, journal.record(s).done)
                for s in range(2 * n_replicas)])
    return log


def _preempting(plan, i, t):
    return any(ev.replica == i and ev.kind == 'preempt'
               and ev.t <= t < ev.t + 0.5 for ev in plan)


@pytest.mark.parametrize('seed', [1, 7, 19, 23])
def test_breaker_and_journal_equal_over_drawn_fault_plans(seed):
    plan = serve_faults.draw_fault_plan(seed, 20.0, 4, n_faults=3)
    got, want = _both(lambda m: _chaos_script(m, plan, 4, 20.0))
    assert got == want
    assert any(step[0] == 'replay' for step in got if len(step) == 4)


def test_breaker_and_journal_edge_cases_equal():
    def script(m):
        cb = m.failover.CircuitBreaker(failure_threshold=1)
        out = [cb.note_failure('r0', 0.0), cb.probe_due('r0', 0.4),
               cb.probe_due('r0', 0.5), cb.note_failure('r0', 0.5),
               cb.probe_due('r0', 1.4), cb.probe_due('r0', 1.5),
               cb.note_success('r0'), cb.snapshot()]
        cb.note_failure('r1', 0.0)
        cb.observe_members(['r2'])
        out.append(cb.snapshot())
        j = m.failover.SessionJournal()
        j.open('s', prompt=[1, 2, 3], max_new_tokens=10, replica='r0')
        j.commit('s', [7, 8])
        out.append(j.replay_spec('s'))
        j.commit('s', [0] * 8)
        out.append(j.replay_spec('s'))
        for call in (lambda: m.failover.CircuitBreaker(failure_threshold=0),
                     lambda: j.open('s', [1], 1, 'r0')):
            with pytest.raises(ValueError):
                call()
        j.close('s')
        with pytest.raises(ValueError):
            j.commit('s', [1])
        return out
    got, want = _both(script)
    assert got == want


# ---- backoff ----------------------------------------------------------------

@pytest.mark.parametrize('kw', [dict(initial=0.5, cap=8.0, jitter=0.0),
                                dict(initial=0.2, cap=5.0),
                                dict(initial=0.1, cap=3.0, multiplier=3.0,
                                     jitter=0.5)])
def test_backoff_schedule_equal(kw):
    def script(m):
        b = m.backoff.Backoff(**kw)
        out = [b.next_delay() for _ in range(9)]
        b.reset()
        out += [b.attempt, b.next_delay(), b.attempt]
        return out
    got, want = _both(script, seed=4)
    assert got == want
    for bad in (dict(initial=0), dict(initial=1.0, cap=0.5),
                dict(multiplier=1.0), dict(jitter=1.0)):
        with pytest.raises(ValueError):
            backoff.Backoff(**bad)


# ---- disagg policies --------------------------------------------------------

def test_handoff_scheduler_targets_equal():
    def script(m):
        d = m.disagg
        s = d.HandoffScheduler(vnodes=16)
        s.set_members({'p0': d.ROLE_PREFILL, 'p1': d.ROLE_PREFILL,
                       'd0': d.ROLE_DECODE, 'd1': d.ROLE_DECODE,
                       'd2': d.ROLE_DECODE})
        out = [[s.choose(f'prompt-{i}', exporter=e) for i in range(64)]
               for e in ('p0', 'd1', None)]
        out.append(s.choose(12345, exporter='p1'))
        s.remove_member('d1')
        s.add_member('d3', d.ROLE_DECODE)
        out.append([s.choose(f'prompt-{i}', exporter='p0')
                    for i in range(64)])
        out.append((s.members(), s.members(d.ROLE_DECODE), s.roles))
        lone = d.HandoffScheduler(vnodes=8)
        lone.set_members({'p0': d.ROLE_PREFILL})
        out.append(lone.choose('x', exporter='p0'))
        with pytest.raises(ValueError, match='role'):
            lone.add_member('x', 'training')
        return out
    got, want = _both(script)
    assert got == want
    assert all(t in {'d0', 'd1', 'd2'} for t in got[0])
    assert (disagg.ROLE_PREFILL, disagg.ROLE_DECODE) == \
        (j_disagg.ROLE_PREFILL, j_disagg.ROLE_DECODE)


def test_role_aware_autoscaler_decisions_equal():
    spec = ServiceSpec(min_replicas=3, max_replicas=6, prefill_replicas=1,
                       disagg_cold_prompt_tokens=64,
                       target_p99_ttft_ms=500.0, target_p99_tpot_ms=50.0,
                       upscale_delay_seconds=20, downscale_delay_seconds=40)

    def script(m):
        ras = m.disagg.RoleAwareSLOAutoscaler('svc', spec)
        rng = random.Random(5)
        out = [ras.info(), ras.get_decision_interval()]
        for step in range(10):
            ras.collect_request_information({
                'prefill': {'ttft_ms': [rng.uniform(100, 1200)
                                        for _ in range(rng.randrange(8))],
                            'queue_depth': rng.choice([0, 2, 9])},
                'decode': {'tpot_ms': [rng.uniform(10, 150)
                                       for _ in range(rng.randrange(12))],
                           'queue_depth': rng.choice([0, 1, 12]),
                           'prefix_hit_ratio': 0.7}})
            dec = ras.generate_scaling_decisions(
                _infos(m, 1 + step % 2)[:-1], _infos(m, 2 + step % 3)[:-1])
            out.append({role: _decisions(ds) for role, ds in dec.items()})
            out.append(ras.info())
        return out
    got, want = _both(script)
    assert got == want
    with pytest.raises(ValueError, match='tpot'):
        disagg.RoleAwareSLOAutoscaler('svc', dataclasses.replace(
            spec, target_p99_tpot_ms=None))


# ---- metric families --------------------------------------------------------

FAMILIES = ['SERVE_LB_SELECTIONS', 'SERVE_REPLICA_INFLIGHT',
            'SERVE_AFFINITY_HITS', 'SERVE_AFFINITY_MISSES',
            'SERVE_AUTOSCALER_DECISIONS', 'SERVE_FAILOVER_SESSIONS',
            'SERVE_FAILOVER_LATENCY_SECONDS',
            'SERVE_FAILOVER_REPLAYED_TOKENS',
            'SERVE_FAILOVER_CIRCUIT_TRANSITIONS',
            'SERVE_FAILOVER_BACKPRESSURE_DIVERTS', 'SERVE_CHAOS_FAULTS',
            'SERVE_DISAGG_HANDOFFS', 'SERVE_DISAGG_EXPORT_BYTES',
            'SERVE_DISAGG_INGEST_BYTES', 'SERVE_DISAGG_TRANSFER_SECONDS',
            'SERVE_DISAGG_POOL_REPLICAS', 'SERVE_SLO_BURN_RATE',
            'DOCTOR_INCIDENTS']


def _family(m):
    return (m._name, m._type, tuple(m._labelnames),
            tuple(getattr(m, '_upper_bounds', ())), m._documentation)


@pytest.mark.parametrize('name', FAMILIES)
def test_metric_family_equal(name):
    assert _family(getattr(metrics, name)) == \
        _family(getattr(j_metrics, name))
    collected = [f.name for f in metrics.REGISTRY.collect()]
    assert getattr(metrics, name)._name in collected


def test_autoscaler_decisions_land_on_the_port_registry():
    def value():
        return metrics.REGISTRY.get_sample_value(
            'skytpu_serve_autoscaler_decisions_total',
            {'service': 'port-fleet-test', 'operator': 'scale_up'}) or 0.0
    before = value()
    a = asc.FixedSizeAutoscaler('port-fleet-test', ServiceSpec(min_replicas=2))
    assert len(a.generate_scaling_decisions([])) == 2
    assert value() == before + 2
