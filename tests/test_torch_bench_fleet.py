"""The port's fleet benches (bench_serve, bench_fuse, bench_disagg,
bench_chaos in skypilot_tpu_torch/bench.py) against the JAX package's
bench.py on the CPU.

Both run their own FleetSimulator over LLAMA_DEBUG f32 in virtual time,
so their dicts must be equal, but for the one field a run of the host
decides: serve's trace path (a fresh temp file).  Each package's
serve.traffic.generator.TrafficConfig is replaced by the same wrapper,
which cuts every trace's duration_s to TRACE_SCALE of the bench's (the
reference's bench_serve alone runs over 150 s on this host at full
length); every other setting is the bench's.  The port's replicas run on
the JAX simulator's parameters (LLAMA_DEBUG, model_seed 0), carried
across with llama.params_from_numpy.  Tolerances: none.
"""
import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import bench as j_bench  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.serve.traffic import generator as j_gen  # noqa: E402
from skypilot_tpu_torch import bench  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.serve.traffic import generator as gen  # noqa: E402
from skypilot_tpu_torch.serve.traffic import simulator as sim  # noqa: E402

TRACE_SCALE = 0.125
BENCHES = ('bench_serve', 'bench_fuse', 'bench_disagg', 'bench_chaos')


@contextlib.contextmanager
def _closing_jax_batchers():
    """Close every JAX ContinuousBatcher made inside: the JAX fleet
    benches leave their replicas open, and their host-tier copy threads
    would outlive this file in its worker (test_kv_tier.py counts such
    threads)."""
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


def _scaled(cls):
    def make(**kw):
        kw['duration_s'] = kw.get('duration_s',
                                  cls.duration_s) * TRACE_SCALE
        return cls(**kw)
    return make


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def params():
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        j_llama.init_params(j_llama.LLAMA_DEBUG,
                                            jax.random.PRNGKey(0)))
    return llama.params_from_numpy(tree, llama.LLAMA_DEBUG, 'cpu')


@pytest.fixture
def scaled_traces(monkeypatch, params):
    monkeypatch.setattr(j_gen, 'TrafficConfig', _scaled(j_gen.TrafficConfig))
    monkeypatch.setattr(gen, 'TrafficConfig', _scaled(gen.TrafficConfig))

    class OnJaxParams(sim.FleetSimulator):
        def __init__(self, *args, **kwargs):
            assert kwargs.get('model_config') is None
            super().__init__(*args, params=params, **kwargs)
    monkeypatch.setattr(sim, 'FleetSimulator', OnJaxParams)


@pytest.mark.parametrize('name', BENCHES)
def test_fleet_bench_equals_the_references(name, scaled_traces):
    with _closing_jax_batchers():
        want = getattr(j_bench, name)(False)
    got = getattr(bench, name)('cpu')
    if name == 'bench_serve':
        for out in (got, want):
            path = out['trace'].pop('path')
            assert os.path.basename(path).startswith('skytpu-serve-trace-')
            os.unlink(path)
    assert got == want
    assert list(got) == list(want)
    if name == 'bench_serve':
        assert got['least_load']['requests'] > 0
        assert got['trace']['chain_ok'] is True
        assert 'error' not in got['acct']
    elif name == 'bench_fuse':
        assert got['fused_steps'] > 0 and got['piggybacked_tokens'] > 0
    elif name == 'bench_disagg':
        assert got['parity_ok'] is True
        assert got['disagg']['disagg']['handoffs'] > 0
    else:
        assert got['bit_exact'] is True and got['tokens_lost'] == 0
        assert got['sessions_recovered'] or got['sessions_handed_off']
