"""The port's bench (skypilot_tpu_torch/bench.py) against the JAX
package's bench.py on the CPU, both at the reference's debug shapes
(LLAMA_DEBUG, f32) and the port running on the JAX bench's parameters
(jax.random.PRNGKey(0), carried across with llama.params_from_numpy):

- build_headline, trace_summary and _serve_trace_info give equal dicts on
  equal inputs, errored sub-benches included; the headline differs only
  in vs_baseline, which the port leaves null (no card target);
- bench_decode, bench_prefix_reuse, bench_tier_reuse and bench_spec agree
  in every field that no clock reads (counts, tokens saved, pool stats,
  parity flags, accept rates, rooflines, params_b, slots); every timed
  field is present and a finite number, positive where it is a rate or
  a time.  The `method` strings describe each package's own mechanism
  and are not compared; bench_spec's two keys of the port's own
  (prefix_cache_mb, agreeing_prefix_share) are checked apart;
- the contracts of tests/test_bench.py, on the port;
- the entry point: without a card it needs --device cpu, and a
  sub-bench that raises is recorded as an error, BENCH_HEADLINE still
  prints last, and the process exits 1.

The fleet benches' parity is in tests/test_torch_bench_fleet.py.
"""
import json
import math
import os
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import prometheus_client
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import bench as j_bench  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.telemetry import metrics as j_metrics  # noqa: E402
from skypilot_tpu_torch import bench  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.telemetry import metrics as t_metrics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# Leaf keys whose values a clock decides (or a ratio of two such).
TIMED = {'decode_tok_s', 'steady_decode_tok_s', 'roofline_pct',
         'steady_roofline_pct', 'steady_streamed_roofline_pct',
         'latency_per_token_ms_p50', 'latency_per_token_ms_p99',
         'spans_off_tok_s', 'spans_on_tok_s', 'span_overhead_pct',
         'pooled_steady_tok_s', 'bucketed_steady_tok_s',
         'fixed_steady_tok_s', 'speedup', 'pooled_vs_fixed_speedup',
         'prefill_tok_s', 'ttft_s', 'prefill_speedup', 'ttft_speedup',
         'spill_gbps', 'prefetch_gbps', 'speedup_high_acceptance',
         'adversarial_vs_off'}
POSITIVE = ('tok_s', '_s', '_ms_p50', '_ms_p99', 'gbps')


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params_for_port(monkeypatch):
    """The port's sub-benches draw the JAX bench's parameters."""
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        j_llama.init_params(j_llama.LLAMA_DEBUG,
                                            jax.random.PRNGKey(0)))
    params = llama.params_from_numpy(tree, llama.LLAMA_DEBUG, 'cpu')

    def init(config, device, seed=0):
        assert config == llama.LLAMA_DEBUG and seed == 0
        return params
    monkeypatch.setattr(bench, '_init_params', init)


def _assert_same_but_timed(got, want, path='', timed=TIMED):
    """Equal dicts, except that a timed leaf need only be a finite
    number on both sides (positive for a rate or a time)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(set(got) ^ set(want)))
        for key in want:
            if key == 'method':
                assert isinstance(got[key], str) and got[key]
                continue
            _assert_same_but_timed(got[key], want[key], f'{path}.{key}',
                                   timed)
        return
    if path.rsplit('.', 1)[-1] in timed:
        for value in (got, want):
            assert isinstance(value, (int, float)) and math.isfinite(
                value), (path, got, want)
            if path.endswith(POSITIVE):
                assert value > 0, (path, got, want)
        return
    assert got == want, (path, got, want)


@contextlib.contextmanager
def _closing_jax_batchers():
    """Close every JAX ContinuousBatcher made inside: the JAX bench leaves
    its batchers open, and their host-tier copy threads would outlive
    this file in its worker (test_kv_tier.py counts such threads)."""
    opened = []
    init = j_serving.ContinuousBatcher.__init__

    def record(batcher, *args, **kwargs):
        opened.append(batcher)
        init(batcher, *args, **kwargs)
    j_serving.ContinuousBatcher.__init__ = record
    try:
        yield
    finally:
        j_serving.ContinuousBatcher.__init__ = init
        for batcher in opened:
            batcher.close()


class _Runs:
    """Each JAX sub-bench once for the module."""

    def __init__(self):
        self.jax = {}

    def get(self, name):
        if name not in self.jax:
            with _closing_jax_batchers():
                self.jax[name] = getattr(j_bench, name)(False)
        return self.jax[name]


@pytest.fixture(scope='module')
def runs():
    return _Runs()


# ---- the sub-benches against the JAX bench's ---------------------------

def test_bench_decode_matches_jax(runs, monkeypatch):
    want = runs.get('bench_decode')
    _jax_params_for_port(monkeypatch)
    got = bench.bench_decode('cpu')
    _assert_same_but_timed(got, want)
    assert got['pooled_path_cache_migrations'] == 0
    assert got['bf16']['pool']['table_appends'] > 0
    assert got['slots'] == 2 and got['params_b'] == want['params_b']


def test_bench_prefix_reuse_matches_jax(runs, monkeypatch):
    want = runs.get('bench_prefix_reuse')
    _jax_params_for_port(monkeypatch)
    got = bench.bench_prefix_reuse('cpu')
    _assert_same_but_timed(got, want)
    assert got['warm_tokens_saved'] > 0 and got['hits'] > 0


def test_bench_tier_reuse_matches_jax(runs, monkeypatch):
    want = runs.get('bench_tier_reuse')
    _jax_params_for_port(monkeypatch)
    got = bench.bench_tier_reuse('cpu')
    _assert_same_but_timed(got, want)
    assert got['parity_ok'] is True
    assert got['tier']['warm_hit_ratio'] > got['no_tier']['warm_hit_ratio']


def test_bench_spec_matches_jax(runs, monkeypatch):
    """The adversarial arm draws fresh prompts each rep and reports the
    fastest rep's syncs a token: a clock picks them, a timed field
    there (its accept rate counts all reps and is compared)."""
    want = runs.get('bench_spec')
    _jax_params_for_port(monkeypatch)
    got = bench.bench_spec('cpu')
    # The port's two extra keys: its trie budget (the reference's 4 MB
    # at these shapes) and how far spec-on follows spec-off.
    assert got.pop('prefix_cache_mb') == 4
    assert got.pop('agreeing_prefix_share') == 1.0
    _assert_same_but_timed(got['adversarial'], want['adversarial'],
                           'adversarial', TIMED | {'host_syncs_per_token'})

    def rest(d):
        return {k: v for k, v in d.items() if k != 'adversarial'}
    _assert_same_but_timed(rest(got), rest(want))
    assert got['greedy_parity'] is True
    assert got['high_acceptance']['accept_rate'] > \
        got['adversarial']['accept_rate']


# ---- the roll-ups on equal inputs --------------------------------------

HEADLINE_CASES = {
    'north_star': dict(
        tok_s=12345.6, mfu=0.585,
        llama8b={'tok_s_chip_extrapolated': 2358.0, 'mfu_pct': 53.9,
                 'extrapolation_check_pct': 2.1},
        decode={'bf16': {'decode_tok_s': 2910.9,
                         'steady_decode_tok_s': 3864.0,
                         'roofline_pct': 43.7,
                         'steady_roofline_pct': 58.0,
                         'pool': {'blocks_total': 9, 'hwm': 4,
                                  'table_appends': 30,
                                  'prefix_shares': 2}},
                'int8_kv': {'decode_tok_s': 2900.0,
                            'steady_decode_tok_s': 3861.0,
                            'roofline_pct': 41.0,
                            'steady_roofline_pct': 55.5},
                'int8_w_kv': {'decode_tok_s': 4000.0,
                              'steady_decode_tok_s': 5043.0,
                              'roofline_pct': 32.0,
                              'steady_roofline_pct': 40.8},
                'pooled_path_cache_migrations': 0.0},
        latency={'launch_to_first_line_s': 6.08},
        prefix={'cold': {'ttft_s': 0.4}, 'warm': {'ttft_s': 0.1},
                'prefill_speedup': 3.2},
        tier={'tier': {'warm_hit_ratio': 1.0, 'spill_gbps': 2.0,
                       'prefetch_gbps': 3.0, 'prefetch_late_rate': 0.1},
              'no_tier': {'warm_hit_ratio': 0.0},
              'working_set_x_budget': 10.3, 'parity_ok': True},
        serve={'goodput_gain': 1.2, 'prefix_hit_gain': 1.5,
               'prefix_affinity': {'ttft_p99_ms': 800.0,
                                   'slo_burn_fast': 1.5,
                                   'slo_burn_slow': 0.5},
               'least_load': {'ttft_p99_ms': 900.0},
               'acct': {'conservation_ratio': 1.0,
                        'fleet_overhead_share': 0.6,
                        'heavy_share_gap_pct': 2.0,
                        'attributed_share': {'default': 0.7,
                                             'heavy': 0.3}}},
        spec={'speedup_high_acceptance': 3.0, 'adversarial_vs_off': 0.98,
              'high_acceptance': {'accept_rate': 0.9},
              'greedy_parity': True},
        mesh={'ranks': 4, 'allreduce': {'busbw_gbps': 1.0},
              'allgather': {'busbw_gbps': 2.0},
              'sharded_decode_tok_s_chip': 10.0,
              'collective_time_share_est': 0.5,
              'overlap': {'chunks': 2}, 'virtual_devices': True},
        chaos={'bit_exact': True, 'sessions_lost': 0, 'tokens_lost': 0,
               'tokens_duplicated': 0,
               'failover_p99_added_latency_ms': 120.0},
        fuse={'dedicated': {'ttft_p99_ms': 1304.0},
              'fused': {'ttft_p99_ms': 1150.4},
              'ttft_p99_delta_pct': -11.78,
              'tpot_regression_pct': -19.31,
              'piggybacked_tokens': 818},
        trace={'step_phase_shares': {'decode': 0.6, 'prefill': 0.4},
               'spans_captured': 12, 'full_chain_requests': 4,
               'span_overhead_pct': 0.9, 'slo_burn_fast': 2.0,
               'slo_burn_slow': 1.0},
        disagg={'fused': {'ttft_p99_ms': 300.0},
                'disagg': {'ttft_p99_ms': 200.0,
                           'disagg': {'prefill_replicas': 1,
                                      'decode_replicas': 2,
                                      'handoffs': 7,
                                      'handoffs_failed': 0}},
                'ttft_p99_delta_pct': -33.3, 'ttft_win_ok': True,
                'decode_tpot_p99_ratio': 1.01, 'tpot_guard_ok': True,
                'parity_ok': True}),
    'errors': dict(
        tok_s=1.0, mfu=0.1, llama8b={'error': 'x' * 500},
        decode={'error': 'y' * 500},
        latency={'launch_to_first_line_s': None, 'error': 'timeout'},
        **{k: {'error': k * 300} for k in ('prefix', 'tier', 'serve',
                                           'spec', 'mesh', 'chaos',
                                           'fuse', 'trace', 'disagg')}),
    'skipped': dict(
        tok_s=2.0, mfu=0.2, llama8b={'suspect': 'slope degenerate'},
        decode={}, latency=None,
        mesh={'ranks': 1, 'skipped': 'single rank ' * 30},
        serve={'acct': {'error': 'no acct block'}}),
}


@pytest.mark.parametrize('case', sorted(HEADLINE_CASES))
def test_build_headline_equals_the_references(case):
    kw = HEADLINE_CASES[case]
    got = bench.build_headline(**kw)
    want = j_bench.build_headline(**kw)
    assert got.pop('vs_baseline') is None
    want.pop('vs_baseline')
    assert got == want
    assert list(got) == list(want)
    line = 'BENCH_HEADLINE ' + json.dumps(got)
    assert '\n' not in line and json.loads(line.split(' ', 1)[1]) == got


def _fresh_phase_histogram():
    return prometheus_client.Histogram(
        'skytpu_infer_step_phase_seconds', 'test copy', ['phase'],
        registry=prometheus_client.CollectorRegistry())


@pytest.mark.parametrize('inputs', ['served', 'errored'])
def test_trace_summary_equals_the_references(inputs, monkeypatch):
    j_hist, t_hist = _fresh_phase_histogram(), _fresh_phase_histogram()
    for hist in (j_hist, t_hist):
        hist.labels(phase='decode').observe(0.3)
        hist.labels(phase='prefill').observe(0.1)
        hist.labels(phase='admit').observe(0.05)
    monkeypatch.setattr(j_metrics, 'INFER_STEP_PHASE_SECONDS', j_hist)
    monkeypatch.setattr(t_metrics, 'INFER_STEP_PHASE_SECONDS', t_hist)
    if inputs == 'served':
        decode = {'span_overhead': {'span_overhead_pct': 1.4}}
        serve = {'trace': {'path': '/tmp/t.json', 'events': 10,
                           'spans_captured': 10, 'requests_traced': 3,
                           'full_chain_requests': 3, 'chain_ok': True},
                 'prefix_affinity': {'slo_burn_fast': 1.5,
                                     'slo_burn_slow': 0.5}}
    else:
        decode, serve = {'error': 'x'}, {'error': 'y'}
    got = bench.trace_summary(decode, serve)
    assert got == j_bench.trace_summary(decode, serve)
    assert got['step_phase_seconds_total'] == 0.45
    assert 0.99 < sum(got['step_phase_shares'].values()) < 1.01


class _StubSim:
    """export_trace/span_count of a simulator arm, from a fixed trace."""

    EVENTS = [
        {'name': 'lb.select', 'args': {'trace_id': 'a'}},
        {'name': 'queue_wait', 'args': {'trace_id': 'a'}},
        {'name': 'admit', 'args': {'trace_id': 'a'}},
        {'name': 'prefill_chunk', 'args': {'trace_id': 'a'}},
        {'name': 'delivery', 'args': {'trace_id': 'a'}},
        {'name': 'lb.select', 'args': {'trace_id': 'b'}},
        {'name': 'admit', 'args': {'trace_id': 'b'}},
        {'name': 'decode_chunk', 'args': {}},
        {'name': 'decode_chunk'},
    ]

    def export_trace(self, path):
        with open(path, 'w', encoding='utf-8') as f:
            json.dump({'traceEvents': self.EVENTS}, f)
        return len(self.EVENTS)

    def span_count(self):
        return 7


def test_serve_trace_info_equals_the_references():
    got = bench._serve_trace_info(_StubSim())
    want = j_bench._serve_trace_info(_StubSim())
    for out in (got, want):
        path = out.pop('path')
        assert os.path.basename(path).startswith('skytpu-serve-trace-')
        os.unlink(path)
    assert got == want
    assert got['full_chain_requests'] == 1 and got['chain_ok'] is True
    assert got['decode_chunks'] == 2 and got['requests_traced'] == 2


# ---- tests/test_bench.py's contracts, on the port ------------------------

def test_allreduce_single_rank_reports_skipped():
    out = bench.bench_allreduce('cpu')
    assert out['ranks'] == 1
    assert 'skipped' in out
    assert 'algbw_gbps' not in out


def test_mesh_ranks_measure_and_bound_the_collectives(monkeypatch):
    """bench_mesh's gloo ranks (2 here, through its SKYTPU_MESH_RANKS
    knob): the multi-rank all-reduce measures and is bounded, and the
    sharded decode is bit-exact across the schedules before a rate is
    reported."""
    monkeypatch.setenv(bench.MESH_RANKS_ENV, '2')
    out = bench.bench_mesh('cpu')
    assert 'error' not in out, out
    for kind in ('allreduce', 'allgather'):
        assert out[kind]['ranks'] == out['ranks'] == 2
        assert 0 < out[kind]['algbw_gbps']
        if out[kind]['algbw_gbps'] > 10_000:
            assert 'suspect' in out[kind]
    assert out['virtual_devices'] is True
    assert out['overlap']['parity'] == 'bit-exact'
    assert out['sharded_decode_tok_s_chip'] > 0
    assert out['single_device_decode_tok_s'] > 0


def test_8b_extrapolation_reports_check_and_convention():
    out = bench.bench_8b_extrapolated('cpu')
    assert 'extrapolation_check_pct' in out
    assert out['mfu_pct'] <= out['mfu_all_params_pct']
    assert 'matmul params only' in out['method']


def test_launch_latency_is_skipped_without_an_orchestrator():
    out = bench.bench_launch_latency()
    assert out['launch_to_first_line_s'] is None and out['skipped']
    h = bench.build_headline(tok_s=1.0, mfu=0.1, llama8b={}, decode={},
                             latency=out)
    assert h['launch_to_first_line_s'] is None
    assert 'launch_latency_error' not in h


# ---- the entry point -------------------------------------------------------

def test_needs_device_cpu_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, '-m', 'skypilot_tpu_torch.bench'],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert 'BENCH_HEADLINE' not in proc.stdout
    assert '--device cpu' in proc.stderr


@pytest.mark.parametrize('spec_raises', [True, False],
                         ids=['spec_raises', 'control'])
def test_a_failing_subbench_is_recorded_and_exits_1(spec_raises,
                                                    monkeypatch, capsys):
    """Every sub-bench stubbed but the training headline, checkpoint and
    resume lines, which run for real on LLAMA_DEBUG.  When bench_spec
    raises, its error is in SPEC_SUMMARY and the headline, the headline
    is still the last line, and main returns 1; the control run, the
    same stubs with nothing raising, returns 0."""
    from skypilot_tpu_torch.analysis import audit as audit_lib

    def spec(device):
        if spec_raises:
            raise RuntimeError('verify window refused')
        return {'greedy_parity': True}

    for name in ('bench_8b_extrapolated', 'bench_decode',
                 'bench_prefix_reuse', 'bench_tier_reuse', 'bench_fuse',
                 'bench_disagg', 'bench_chaos'):
        monkeypatch.setattr(bench, name, lambda device: {'ok': 1})
    monkeypatch.setattr(bench, 'bench_serve',
                        lambda device: {'acct': {'conservation_ratio': 1.0}})
    monkeypatch.setattr(bench, 'bench_mesh',
                        lambda device: {'ranks': 1, 'skipped': 'stub'})
    monkeypatch.setattr(bench, 'bench_spec', spec)
    monkeypatch.setattr(audit_lib, 'quick_summary',
                        lambda **kw: {'failures': 0})
    assert bench.main(['--device', 'cpu']) == (1 if spec_raises else 0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith('BENCH_HEADLINE ')
    headline = json.loads(lines[-1].split(' ', 1)[1])
    spec_line = [x for x in lines if x.startswith('SPEC_SUMMARY ')][0]
    if spec_raises:
        assert headline['spec'] == {'error': 'verify window refused'}
        assert json.loads(spec_line.split(' ', 1)[1]) == {
            'error': 'verify window refused'}
    else:
        assert 'error' not in headline['spec']
    assert headline['vs_baseline'] is None
    first = json.loads(lines[0])
    assert first['extra']['platform'] == 'cpu'
    assert first['vs_baseline'] is None
    for name in ('CKPT_SUMMARY', 'RESUME_SUMMARY'):
        line = [x for x in lines if x.startswith(name + ' ')][0]
        assert json.loads(line.split(' ', 1)[1])['bytes'] > 0
    names = [x.split(' ', 1)[0] for x in lines[1:]]
    assert names == ['TELEMETRY_SUMMARY', 'CKPT_SUMMARY', 'RESUME_SUMMARY',
                     'AUDIT_SUMMARY', 'POOL_SUMMARY', 'PREFIX_SUMMARY',
                     'TIER_SUMMARY', 'SERVE_SUMMARY', 'FUSE_SUMMARY',
                     'DISAGG_SUMMARY', 'CHAOS_SUMMARY', 'SPEC_SUMMARY',
                     'MESH_SUMMARY', 'TRACE_SUMMARY', 'ACCT_SUMMARY',
                     'BENCH_HEADLINE']
