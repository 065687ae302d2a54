"""The port's FleetSimulator (skypilot_tpu_torch/serve/traffic/simulator.py)
over the port's batchers on the CPU, held against the JAX package's
FleetSimulator on the same configs (tests/test_serve_traffic.py's
paired runs, tests/test_serve_chaos.py's fault plans, tests/test_disagg.py's
disagg arm, tests/test_accounting_doctor.py's two-tenant arm).

What must hold:
- the SERVE_SUMMARY is equal as a dict for least_load and
  prefix_affinity, kill + preempt, stall + partition, disagg with
  model-dtype (f32 and bf16) and int8 KV, the two-tenant ledger arm, and
  test_serve_traffic.py's SLO-autoscaler scale-up (each package's
  SLOAutoscaler over the JAX package's ServiceSpec);
- the chaos runs' session_outputs() equal the JAX runs' and the
  fault-free runs', and the disagg runs' equal the single-pool run's;
- the card gate's premise: an f32 config with 4 KV heads (4x the bytes a
  token) and every byte budget and link rate scaled by 4 gives
  LLAMA_DEBUG's summary except in the fields that count bytes (and, with
  handoffs, in the times the images' fixed-size headers shift);
- close() leaves no kv-tier-copy-torch thread alive and no reference
  cycle through the simulator (its replicas' batchers free without a
  cyclic collection), and the simulator raises without a card unless
  device='cpu' is given.

The JAX runs live in one module-scoped cache, so each configuration runs
once.  The paired-run and chaos trace is the reference fixtures' with
duration_s cut from 10 to 7 s (the faults still land at 2-5.5 s, inside
the trace); every other setting is the reference's.  The JAX
simulator's parameters (LLAMA_DEBUG, model_seed 0) are carried across
with llama.params_from_numpy.  Tolerances: none — summaries, tokens and
outputs are compared exactly.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.serve import autoscalers as j_asc  # noqa: E402
from skypilot_tpu.serve.service_spec import ServiceSpec  # noqa: E402
from skypilot_tpu.serve.traffic import generator as j_gen  # noqa: E402
from skypilot_tpu.serve.traffic import simulator as j_sim  # noqa: E402
from skypilot_tpu_torch.infer import kv_tier  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.serve import autoscalers as asc  # noqa: E402
from skypilot_tpu_torch.serve.traffic import generator as gen  # noqa: E402
from skypilot_tpu_torch.serve.traffic import simulator as sim  # noqa: E402

# test_serve_traffic.py's paired_runs / test_serve_chaos.py's _TRAFFIC and
# _SIM, duration cut 10 -> 7 s.
TRAFFIC = dict(seed=11, duration_s=7.0, base_rps=8.0, num_sessions=8,
               num_heads=6, head_tokens=64, session_share=0.85)
SIM = dict(num_replicas=3, batch_size=2, decode_chunk=4, slo_ttft_s=1.5,
           prefill_cost_per_token_s=4e-3, prefix_cache_mb=0.25)
KILL_PREEMPT = (('kill', 3.5, 0, 0.0), ('preempt', 5.5, 1, 0.0))
STALL_PARTITION = (('stall', 2.0, 0, 5.0), ('partition', 3.0, 1, 4.0))
# test_disagg.py's _sim_run.
DISAGG_TRAFFIC = dict(seed=13, duration_s=5.0, base_rps=4.0,
                      session_share=0.5, num_sessions=4, num_heads=2,
                      head_tokens=40, tail_median=6, singleton_median=96,
                      singleton_sigma=0.2, max_prompt_tokens=128,
                      out_median=12, out_sigma=0.3, max_out_tokens=20,
                      min_out_tokens=4)
DISAGG_SIM = dict(policy='least_load', num_replicas=3, slo_ttft_s=1.0,
                  batch_size=4, decode_chunk=4, max_seq_len=256,
                  prefix_cache_mb=2.0, prefix_block=64, prefill_chunk=16,
                  host_tier_mb=4.0)
SPLIT = dict(prefill_replicas=1, disagg_cold_prompt_tokens=65)
# test_accounting_doctor.py's two-tenant arm.
TENANT_TRAFFIC = dict(seed=11, duration_s=10.0, base_rps=6.0,
                      num_sessions=9, num_heads=6, head_tokens=48,
                      tenants=('default', 'default', 'heavy'))
TENANT_SIM = dict(policy='prefix_affinity', num_replicas=2, slo_ttft_s=1.0,
                  batch_size=4, decode_chunk=4, prefix_cache_mb=0.5)
# test_serve_traffic.py's SLO-autoscaler scale-up run.
SCALE_TRAFFIC = dict(seed=2, duration_s=45.0, base_rps=1.5, num_sessions=4,
                     num_heads=2)
SCALE_SIM = dict(policy='least_load', num_replicas=1, batch_size=2,
                 decode_chunk=4, prefill_cost_per_token_s=10e-3,
                 prefix_cache_mb=None)
SCALE_SPEC = dict(min_replicas=1, max_replicas=2, target_p99_ttft_ms=300,
                  upscale_delay_seconds=20, downscale_delay_seconds=1200)

# name -> (sim kwargs, traffic kwargs, faults, model dtype)
ARMS = {
    'least_load': (dict(SIM, policy='least_load'), TRAFFIC, None, 'f32'),
    'prefix_affinity': (dict(SIM, policy='prefix_affinity'), TRAFFIC, None,
                        'f32'),
    'kill_preempt': (dict(SIM, policy='least_load'), TRAFFIC, KILL_PREEMPT,
                     'f32'),
    'stall_partition': (dict(SIM, policy='prefix_affinity'), TRAFFIC,
                        STALL_PARTITION, 'f32'),
    'disagg': (dict(DISAGG_SIM, **SPLIT), DISAGG_TRAFFIC, None, 'f32'),
    'disagg_bf16': (dict(DISAGG_SIM, **SPLIT), DISAGG_TRAFFIC, None,
                    'bf16'),
    'disagg_int8': (dict(DISAGG_SIM, kv_cache_dtype='int8', **SPLIT),
                    DISAGG_TRAFFIC, None, 'f32'),
    'single_pool': (DISAGG_SIM, DISAGG_TRAFFIC, None, 'f32'),
    'single_pool_int8': (dict(DISAGG_SIM, kv_cache_dtype='int8'),
                         DISAGG_TRAFFIC, None, 'f32'),
    'two_tenant': (TENANT_SIM, TENANT_TRAFFIC, None, 'f32'),
    'autoscale': (SCALE_SIM, SCALE_TRAFFIC, None, 'f32'),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """The engines run many small ops: with several test workers on the
    host's cores, torch's intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _copy_threads():
    return [t.name for t in threading.enumerate()].count(
        kv_tier.COPY_THREAD_NAME)


def _chaos(mod, faults):
    if faults is None:
        return None
    return mod.ChaosConfig(events=[
        mod.FaultEvent(t=t, kind=kind, replica=rep, duration_s=d)
        for kind, t, rep, d in faults])


class _Runs:
    """Each arm's JAX run and port run, made once for the module."""

    def __init__(self):
        self.jax = {}
        self.port = {}
        self.params = {}

    def jax_run(self, name):
        if name not in self.jax:
            sim_kw, traffic_kw, faults, dtype = ARMS[name]
            with pytest.MonkeyPatch.context() as mp:
                if dtype == 'bf16':
                    # The JAX simulator builds LLAMA_DEBUG itself.
                    mp.setattr(j_llama, 'LLAMA_DEBUG', dataclasses.replace(
                        j_llama.LLAMA_DEBUG, dtype=jnp.bfloat16))
                s = j_sim.FleetSimulator(j_sim.SimConfig(**sim_kw),
                                         j_gen.TrafficConfig(**traffic_kw),
                                         _chaos(j_sim, faults))
                try:
                    self.jax[name] = (s.run(_autoscaler(j_asc, name)),
                                      s.session_outputs())
                finally:
                    s.close()
            if dtype not in self.params:
                tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                                    s.params)
                self.params[dtype] = llama.params_from_numpy(
                    tree, _model_config(dtype), 'cpu')
        return self.jax[name]

    def port_run(self, name):
        if name not in self.port:
            sim_kw, traffic_kw, faults, dtype = ARMS[name]
            if dtype not in self.params:
                self.jax_run(name)
            self.port[name] = _port(sim_kw, traffic_kw, faults,
                                    _model_config(dtype),
                                    self.params[dtype],
                                    _autoscaler(asc, name))
        return self.port[name]


def _model_config(dtype):
    if dtype == 'bf16':
        return dataclasses.replace(llama.LLAMA_DEBUG, dtype=torch.bfloat16)
    return llama.LLAMA_DEBUG


def _autoscaler(mod, name):
    if name != 'autoscale':
        return None
    return mod.SLOAutoscaler('sim', ServiceSpec(**SCALE_SPEC))


def _port(sim_kw, traffic_kw, faults, model_config=None, params=None,
          autoscaler=None):
    s = sim.FleetSimulator(sim.SimConfig(**sim_kw),
                           gen.TrafficConfig(**traffic_kw),
                           _chaos(sim, faults), model_config=model_config,
                           params=params, device='cpu')
    try:
        return s.run(autoscaler), s.session_outputs()
    finally:
        s.close()


@pytest.fixture(scope='module')
def runs():
    return _Runs()


@pytest.mark.parametrize('arm', ['least_load', 'prefix_affinity',
                                 'kill_preempt', 'stall_partition',
                                 'disagg', 'disagg_bf16', 'disagg_int8',
                                 'two_tenant', 'autoscale'])
def test_summary_equals_the_jax_simulators(runs, arm):
    want, _ = runs.jax_run(arm)
    got, _ = runs.port_run(arm)
    assert got == want
    assert got['requests'] > 0
    if arm == 'autoscale':
        assert got['replicas'] == 2
        assert any(e['replicas'] == 2 for e in got['scale_events'])


def test_paired_runs_keep_the_reference_properties(runs):
    """test_serve_traffic.py's claims hold on the port's runs: affinity
    beats least_load on the contended trace, and a rerun is equal."""
    least, _ = runs.port_run('least_load')
    affinity, _ = runs.port_run('prefix_affinity')
    assert least['requests'] == affinity['requests'] > 0
    assert affinity['prefix_hit_ratio'] > least['prefix_hit_ratio']
    assert affinity['prefix_tokens_saved'] > 0
    sim_kw, traffic_kw, _, _ = ARMS['prefix_affinity']
    again, _ = _port(sim_kw, traffic_kw, None,
                     params=runs.params['f32'])
    assert again == affinity


@pytest.mark.parametrize('arm,baseline', [('kill_preempt', 'least_load'),
                                          ('stall_partition',
                                           'prefix_affinity')])
def test_chaos_outputs_equal_jax_and_the_fault_free_run(runs, arm,
                                                        baseline):
    summary, outputs = runs.port_run(arm)
    _, want = runs.jax_run(arm)
    _, fault_free = runs.port_run(baseline)
    assert outputs == want
    assert outputs == fault_free
    assert summary['chaos']['sessions_lost'] == 0
    assert summary['chaos']['circuit_opens'] > 0


def test_chaos_arms_recover_and_hand_off(runs):
    kp, _ = runs.port_run('kill_preempt')
    assert kp['chaos']['sessions_recovered'] > 0
    assert kp['chaos']['sessions_handed_off'] > 0
    assert kp['chaos']['invariant_checks'] > 0
    sp, _ = runs.port_run('stall_partition')
    heals = [e for e in sp['chaos']['faults'] if e.get('event') == 'heal']
    assert len(heals) == 2


@pytest.mark.parametrize('arm,single', [('disagg', 'single_pool'),
                                        ('disagg_int8', 'single_pool_int8')])
def test_disagg_outputs_equal_the_single_pool_run(runs, arm, single):
    summary, outputs = runs.port_run(arm)
    _, want = runs.jax_run(arm)
    _, single_outputs = runs.port_run(single)
    assert outputs == want
    assert outputs == single_outputs
    block = summary['disagg']
    assert block['handoffs'] > 0 and block['handoffs_failed'] == 0
    assert block['export_bytes'] == block['ingest_bytes'] > 0


# Fields that count bytes, the ones that may differ at 4x the bytes a
# token; with handoffs, also the times the images' headers shift (a
# header does not scale with the KV: its bytes cross the link at 4x the
# rate), each within HEADER_MS.
BYTE_FIELDS = {'tier.spill_bytes', 'tier.prefetch_bytes',
               'disagg.export_bytes', 'disagg.ingest_bytes',
               'acct.tenants.*.spill_bytes', 'acct.tenants.*.prefetch_bytes',
               'acct.top.*.spill_bytes', 'acct.top.*.prefetch_bytes'}
HEADER_FIELDS = {'ttft_p99_ms', 'disagg.cold_ttft_p99_ms',
                 'disagg.transfer_p50_ms', 'disagg.transfer_p99_ms'}
HEADER_MS = 1e-3
HEADER_BYTES = 2048


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, list) and tree and isinstance(tree[0], dict):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _field(path):
    """'acct.tenants.heavy.spill_bytes' -> 'acct.tenants.*.spill_bytes'."""
    if path[0] == 'acct' and len(path) == 4:
        return '.'.join((path[0], path[1], '*', path[3]))
    return '.'.join(path)


@pytest.mark.parametrize('arm', ['doctor', 'disagg'])
def test_four_times_the_kv_bytes_give_the_same_summary(arm):
    """The premise of the card's 8B gate, at 4x here: budgets and link
    rates scaled with the bytes a token keep every node count and every
    virtual copy time."""
    if arm == 'doctor':
        traffic = dict(seed=5, duration_s=12.0, base_rps=8.0, num_sessions=8,
                       num_heads=8, head_tokens=64,
                       tenants=('default', 'heavy'))
        base = dict(policy='prefix_affinity', num_replicas=2,
                    slo_ttft_s=0.02, batch_size=4, decode_chunk=4,
                    prefix_cache_mb=0.25, host_tier_mb=8.0)
    else:
        traffic, base = DISAGG_TRAFFIC, dict(DISAGG_SIM, **SPLIT)
    wide = dataclasses.replace(llama.LLAMA_DEBUG, n_heads=4, n_kv_heads=4,
                               head_dim_override=128)
    assert wide.n_kv_heads * wide.head_dim == \
        4 * llama.LLAMA_DEBUG.n_kv_heads * llama.LLAMA_DEBUG.head_dim
    scaled = dict(base, prefix_cache_mb=base['prefix_cache_mb'] * 4,
                  host_tier_mb=base['host_tier_mb'] * 4,
                  tier_spill_gbps=8.0 * 4, tier_prefetch_gbps=8.0 * 4)
    narrow, _ = _port(base, traffic, None)
    got, _ = _port(scaled, traffic, None, model_config=wide)
    want = dict(_leaves(narrow))
    have = dict(_leaves(got))
    assert set(have) == set(want)
    moved = set()
    for path, value in want.items():
        field = _field(path)
        if field in BYTE_FIELDS:
            # 4x, less the headers of the images (they do not scale),
            # and the ledger's rounding to 6 decimals.
            slack = 4 * HEADER_BYTES * want.get(('disagg', 'handoffs'), 0)
            assert 4 * value - slack - 1e-5 <= have[path] <= \
                4 * value + 1e-5, (path, have[path], value)
            moved.add(field)
        elif field in HEADER_FIELDS:
            assert abs(have[path] - value) <= HEADER_MS, (path, value)
        else:
            assert have[path] == value, (path, have[path], value)
    assert {'tier.prefetch_bytes'} <= moved


def test_close_joins_every_copy_thread():
    before = _copy_threads()
    s = sim.FleetSimulator(
        sim.SimConfig(**dict(DISAGG_SIM, **SPLIT)),
        gen.TrafficConfig(**dict(DISAGG_TRAFFIC, duration_s=1.0)),
        device='cpu')
    s.run()
    assert _copy_threads() > before
    s.close()
    assert _copy_threads() == before
    s.close()                   # idempotent
    assert s.summary()['requests'] > 0


def test_closed_replicas_free_without_a_collection():
    """close() breaks the cycles through the simulator (the batchers'
    span clocks read their replicas): with the cyclic collector off, the
    replicas' batchers and arenas go with the simulator, and until then
    the summary and the ledgers stay readable."""
    import gc
    import weakref
    s = sim.FleetSimulator(
        sim.SimConfig(**dict(DISAGG_SIM, **SPLIT)),
        gen.TrafficConfig(**dict(DISAGG_TRAFFIC, duration_s=1.0)),
        device='cpu')
    summary = s.run()
    gc.collect()
    gc.disable()
    try:
        s.close()
        assert s.summary(makespan=summary['makespan_s']) == summary
        assert s.fleet_ledger().tenant_rollup()
        reps = s._all_reps()
        batchers = [weakref.ref(r.batcher) for r in reps]
        arenas = [weakref.ref(r.batcher.pool.arena['k']) for r in reps]
        del reps
        del s
        assert [b() for b in batchers] == [None] * len(batchers)
        assert [a() for a in arenas] == [None] * len(arenas)
    finally:
        gc.enable()


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        sim.FleetSimulator(sim.SimConfig(num_replicas=1))
