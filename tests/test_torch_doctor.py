"""The port's fleet doctor (skypilot_tpu_torch/telemetry/doctor.py) on the
CPU, held against the JAX package's (tests/test_accounting_doctor.py's
and tests/test_disagg.py's doctor cases).

What must hold (exactly):
- the rule registry: codes, names, severities, summaries, the default
  thresholds and the signal catalogue;
- every rule's predicate over one table of signal dicts, and the
  Doctor's incidents (hysteresis, counter deltas, overridden thresholds)
  over one scripted snapshot stream;
- the --list-rules text and --validate's exit code, in process and as
  ``python -m skypilot_tpu_torch.telemetry.doctor``;
- flight-recorder bundles from the same sources are byte-identical to
  the JAX package's; an incident exported with export_metrics lands on
  the port's registry;
- test_accounting_doctor.py's doctor arm (the injected SLO burn and spill
  thrash, 12 s trace, postmortems on) run by the port's FleetSimulator
  on the CPU: the incidents equal the JAX simulator's, each postmortem
  bundle equals the JAX package's as a JSON object, and two port runs
  write byte-identical bundles.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from skypilot_tpu.serve.traffic import generator as j_gen  # noqa: E402
from skypilot_tpu.serve.traffic import simulator as j_sim  # noqa: E402
from skypilot_tpu.telemetry import doctor as j_doctor  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.serve.traffic import generator as gen  # noqa: E402
from skypilot_tpu_torch.serve.traffic import simulator as sim  # noqa: E402
from skypilot_tpu_torch.telemetry import accounting  # noqa: E402
from skypilot_tpu_torch.telemetry import doctor  # noqa: E402
from skypilot_tpu_torch.telemetry import metrics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _registry(mod, thresholds=None):
    return [(r.code, r.name, r.severity, r.summary)
            for r in mod.build_rules(thresholds)]


def test_rule_registry_equal():
    assert _registry(doctor) == _registry(j_doctor)
    assert [c for c, *_ in _registry(doctor)] == [
        'DOC101', 'DOC102', 'DOC201', 'DOC202', 'DOC203', 'DOC301',
        'DOC302', 'DOC401']
    assert doctor.DEFAULT_THRESHOLDS == j_doctor.DEFAULT_THRESHOLDS
    assert doctor.SIGNALS == j_doctor.SIGNALS
    assert doctor._COUNTER_SIGNALS == j_doctor._COUNTER_SIGNALS
    assert doctor.validate_rules() == j_doctor.validate_rules() == []


# One row a predicate case: raw and d_* signals at and around every
# threshold.
SIGNAL_TABLE = [
    {},
    {'slo_burn_fast': 14.4}, {'slo_burn_fast': 14.41},
    {'slo_burn_slow': 6.0}, {'slo_burn_slow': 6.5, 'slo_burn_fast': 99.0},
    {'d_tier_prefetch_late': 4.0, 'd_tier_prefetches': 3.0},
    {'d_tier_prefetch_late': 3.0, 'd_tier_prefetches': 0.0},
    {'d_tier_prefetch_late': 4.0, 'd_tier_prefetches': 4.0},
    {'d_tier_spills': 8.0, 'd_tier_prefetches': 8.0},
    {'d_tier_spills': 100.0, 'd_tier_prefetches': 8.0},
    {'d_tier_spills': 30.0, 'd_tier_prefetches': 25.0},
    {'d_disagg_handoffs': 10.0, 'd_disagg_handoff_late': 6.0},
    {'d_disagg_handoffs': 10.0, 'd_disagg_handoff_late': 5.0},
    {'d_disagg_handoffs': 3.0, 'd_disagg_handoff_late': 3.0},
    {'d_breaker_opens': 1.0}, {'d_breaker_opens': 2.0},
    {'pool_blocks_total': 100.0, 'pool_hwm': 95.0, 'pool_free': 5.0},
    {'pool_blocks_total': 100.0, 'pool_hwm': 94.0},
    {'pool_blocks_total': 0.0, 'pool_hwm': 5.0},
    {'d_backpressure_retries': 7.0}, {'d_backpressure_retries': 8.0},
]


@pytest.mark.parametrize('thresholds', [None, {'slo_fast_burn': 0.5,
                                               'spill_thrash_min_events': 3,
                                               'breaker_flaps': 1}])
def test_every_predicate_equal_over_the_signal_table(thresholds):
    got = [[r.predicate(row) for r in doctor.build_rules(thresholds)]
           for row in SIGNAL_TABLE]
    want = [[r.predicate(row) for r in j_doctor.build_rules(thresholds)]
            for row in SIGNAL_TABLE]
    assert got == want
    fired = {rule for row in got for rule, ev in enumerate(row) if ev}
    assert fired == set(range(len(doctor.build_rules())))


SNAPSHOTS = [
    {}, {'slo_burn_fast': 20.0}, {'slo_burn_fast': 30.0},
    {'slo_burn_fast': 1.0, 'breaker_opens': 1.0},
    {'slo_burn_fast': 25.0, 'breaker_opens': 3.0},
    {'breaker_opens': 3.0, 'tier_spills': 100.0, 'tier_prefetches': 8.0},
    {'tier_spills': 130.0, 'tier_prefetches': 33.0},
    {'tier_prefetch_late': 5.0, 'tier_prefetches': 35.0},
    {'backpressure_retries': 9.0, 'pool_blocks_total': 100.0,
     'pool_hwm': 96.0, 'pool_free': 4.0},
    {'pool_blocks_total': 100.0, 'pool_hwm': 96.0},
    {'disagg_handoffs': 10.0, 'disagg_handoff_late': 6.0},
    {'disagg_handoffs': 10.0, 'disagg_handoff_late': 6.0},
    {'disagg_handoffs': 20.0, 'disagg_handoff_late': 12.0,
     'slo_burn_slow': 7.0},
]


@pytest.mark.parametrize('thresholds', [None, {'slo_fast_burn': 0.5}])
def test_doctor_incidents_equal_over_a_snapshot_stream(thresholds):
    def run(mod):
        doc = mod.Doctor(thresholds=thresholds)
        opened = [[i.to_dict() for i in doc.observe(s, now=float(t))]
                  for t, s in enumerate(SNAPSHOTS)]
        return opened, [i.to_dict() for i in doc.incidents]
    got, want = run(doctor), run(j_doctor)
    assert got == want
    assert len(got[1]) >= 8


def _main_text(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = mod.main(argv)
    return code, out.getvalue(), err.getvalue()


def test_cli_list_rules_and_validate_equal():
    for argv in (['--list-rules'], ['--validate'],
                 ['--list-rules', '--validate']):
        assert _main_text(doctor, argv) == _main_text(j_doctor, argv)
    code, text, _ = _main_text(doctor, ['--list-rules'])
    assert code == 0 and text.count('\n') == 8
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.telemetry.doctor',
         '--list-rules', '--validate'], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _main_text(
        j_doctor, ['--list-rules', '--validate'])[1]


def test_validate_reports_a_broken_registry(monkeypatch):
    specs = doctor._RULE_SPECS + (doctor._RULE_SPECS[0],)
    monkeypatch.setattr(doctor, '_RULE_SPECS', specs)
    monkeypatch.setattr(j_doctor, '_RULE_SPECS',
                        j_doctor._RULE_SPECS + (j_doctor._RULE_SPECS[0],))
    assert doctor.validate_rules() == j_doctor.validate_rules() != []
    assert _main_text(doctor, ['--validate'])[0] == 1


def _incident(mod):
    return mod.Incident(incident_id='inc-001-slo_fast_burn', rule='DOC101',
                        name='slo_fast_burn', severity='page',
                        opened_at=4.0,
                        evidence={'slo_burn_fast': 20.0, 'threshold': 14.4})


def test_recorder_bundles_byte_identical_to_the_jax_packages(tmp_path,
                                                             monkeypatch):
    from skypilot_tpu.telemetry import accounting as j_accounting

    def make(mod, acct, sub):
        led = acct.CostLedger()
        led.begin_step()
        led.charge_batch('decode', [(1, 'a')])
        led.charge_request('prefill', 2, 'b')
        led.end_step({'decode': 2.0, 'prefill': 1.0}, wall=3.5)
        return mod.FlightRecorder(
            str(tmp_path / sub),
            spans_fn=lambda: [{'name': 's', 't0': 1.0, 't1': 2.0}] * 300,
            metrics_fn=lambda: {'slo_burn_fast': 20.0},
            pool_fn=lambda: {'blocks_total': 8},
            tier_fn=lambda: {'spills': 4}, ledger=led)

    got = make(doctor, accounting, 'port').dump(_incident(doctor))
    want = make(j_doctor, j_accounting, 'jax').dump(_incident(j_doctor))
    assert os.path.basename(got) == os.path.basename(want)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    monkeypatch.delenv('SKYTPU_POSTMORTEM_DIR', raising=False)
    assert doctor.FlightRecorder(None, metrics_fn=dict,
                                 spans_fn=list).dump(_incident(doctor)) is None


def test_default_snapshot_reads_the_port_registry():
    snap = doctor._registry_snapshot()
    assert any(k.startswith('skytpu_serve_slo_burn_rate') or
               k.startswith('skytpu_infer_') for k in snap)
    assert list(snap) == sorted(snap)


def test_incidents_export_to_the_port_registry():
    def value():
        return metrics.REGISTRY.get_sample_value(
            'skytpu_doctor_incidents_total',
            {'rule': 'slo_fast_burn'}) or 0.0
    before = value()
    doctor.Doctor(export_metrics=True).observe({'slo_burn_fast': 99.0}, 1.0)
    assert value() == before + 1
    doctor.Doctor().observe({'slo_burn_fast': 99.0}, 1.0)
    assert value() == before + 1


# ---- the doctor arm of the fleet simulator ----------------------------------

TRAFFIC = dict(seed=5, duration_s=12.0, base_rps=8.0, num_sessions=8,
               num_heads=8, head_tokens=64, tenants=('default', 'heavy'))
SIM = dict(policy='prefix_affinity', num_replicas=2, slo_ttft_s=0.02,
           batch_size=4, decode_chunk=4, prefix_cache_mb=0.25,
           host_tier_mb=8.0, doctor_cadence_s=3.0,
           doctor_thresholds={'spill_thrash_min_events': 3})


@pytest.fixture(scope='module')
def doctor_runs(tmp_path_factory):
    """The JAX simulator once, the port's twice, each with its own
    postmortem directory (one torch thread: the module fixture runs
    before the function-scoped one that sets it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    d = str(tmp_path_factory.mktemp('jax'))
    s = j_sim.FleetSimulator(j_sim.SimConfig(postmortem_dir=d, **SIM),
                             j_gen.TrafficConfig(**TRAFFIC))
    try:
        out['jax'] = (d, s.run())
    finally:
        s.close()
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), s.params)
    params = llama.params_from_numpy(tree, llama.LLAMA_DEBUG, 'cpu')
    for run in ('port1', 'port2'):
        d = str(tmp_path_factory.mktemp(run))
        s = sim.FleetSimulator(sim.SimConfig(postmortem_dir=d, **SIM),
                               gen.TrafficConfig(**TRAFFIC), params=params,
                               device='cpu')
        try:
            out[run] = (d, s.run())
        finally:
            s.close()
    torch.set_num_threads(threads)
    return out


def test_sim_doctor_incidents_equal(doctor_runs):
    _, want = doctor_runs['jax']
    _, got = doctor_runs['port1']
    assert got == want
    counts = got['doctor']['incident_counts']
    assert set(counts) == {'DOC101', 'DOC102', 'DOC202'}
    assert got['doctor']['postmortems'] == len(got['doctor']['incidents'])


def test_sim_postmortem_bundles_equal_and_byte_deterministic(doctor_runs):
    dirs = {k: v[0] for k, v in doctor_runs.items()}
    names = sorted(os.listdir(dirs['port1']))
    assert names and names == sorted(os.listdir(dirs['jax'])) == \
        sorted(os.listdir(dirs['port2']))
    for name in names:
        blob = Path(dirs['port1'], name).read_bytes()
        assert blob == Path(dirs['port2'], name).read_bytes(), name
        bundle = json.loads(blob)
        assert bundle == json.loads(Path(dirs['jax'], name).read_bytes())
        assert set(bundle) == {'incident', 'spans', 'metrics', 'pool',
                               'tier', 'tenants_top'}
        assert bundle['spans'] and bundle['tenants_top']
