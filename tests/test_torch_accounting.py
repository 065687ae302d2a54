"""The port's per-tenant cost ledger (skypilot_tpu_torch/telemetry/
accounting.py) and the batcher's charges into it, on the CPU, held
against the JAX package.

What must hold:
- the copy gives the reference's rollups, summaries and top tables on
  the call sequences of tests/test_accounting_doctor.py (batch phases
  split by chunk weight, request phases to their owners, overhead and
  the unattributed remainder to `_fleet` so the tenants conserve the
  wall exactly, tokens/blocks/tier bytes/spec waste, tier bytes without
  an admission billing nobody, the fleet view over replicas);
- its metrics export moves the port's `skytpu_acct_*` families;
- the JAX and port batchers, each with a ledger and an equal tick clock
  for the step profiler, bill the same tenants the same device-ticks,
  tokens, block-ticks and spec waste on pooled, chunked, spec, fused and
  prefix-hit traffic (the same rollups, summaries and top tables), and
  the port's rollup conserves the profiler wall.

At LLAMA_DEBUG (2 layers, f32), weights from one JAX draw
(llama.params_from_numpy).  Rollups compare exactly: a tick clock makes
the attribution a pure function of the schedule.
"""
import itertools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.telemetry import accounting as j_accounting  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.telemetry import accounting  # noqa: E402
from skypilot_tpu_torch.telemetry.metrics import REGISTRY  # noqa: E402

CFG = llama.LLAMA_DEBUG
J_CFG = j_llama.LLAMA_DEBUG
HEAD = [((7 * i) % 500) + 3 for i in range(16)]
PROMPTS = [[5, 9, 2, 7], HEAD + [11, 12], [((3 * i) % 400) + 1
                                           for i in range(40)],
           HEAD + [13], [21, 22, 23], [8, 8, 8, 8, 8, 8]]
TENANTS = ['a', 'b', 'a', 'b', None, 'a']


# ---- the ledger, call sequence for call sequence ---------------------------

def _batch_split(mod):
    led = mod.CostLedger()
    led.begin_step()
    for _ in range(3):
        led.charge_batch('decode', [(1, 'a')])
    led.charge_batch('decode', [(2, 'b')])
    led.end_step({'decode': 8.0}, wall=8.0)
    return led


def _request_owner(mod):
    led = mod.CostLedger()
    led.begin_step()
    led.charge_request('prefill', 1, 'a')
    led.charge_request('admit', 2, 'b')
    led.end_step({'prefill': 4.0, 'admit': 1.0}, wall=5.0)
    return led


def _overhead(mod):
    led = mod.CostLedger()
    led.begin_step()
    led.charge_batch('decode', [(1, 'a'), (2, 'b')])
    led.end_step({'decode': 4.0, 'host_fetch': 2.0}, wall=7.0)
    return led


def _tokens_blocks(mod):
    led = mod.CostLedger()
    led.begin_step()
    led.charge_request('admit', 1, 'a')
    led.add_tokens(1, 'a', prefill=64)
    led.add_tokens(1, 'a', decode=3)
    led.note_blocks([(1, 'a', 4)])
    led.add_tier_bytes(spill=1000.0, prefetch=500.0)
    led.add_spec([(1, 'a')], proposed=8, accepted=5)
    led.end_step({'admit': 1.0}, wall=2.0)
    led.finish_request(1, 'a', session='t-1')
    led.finish_request(1, 'a', session='t-2')    # once only
    return led


def _tier_nobody(mod):
    led = mod.CostLedger()
    led.begin_step()
    led.charge_batch('decode', [(1, 'a')])
    led.add_tier_bytes(spill=999.0)
    led.end_step({'decode': 1.0}, wall=1.0)
    return led


def _default_upgrade(mod):
    led = mod.CostLedger()
    led.begin_step()
    led.charge_batch('decode', [(1, mod.DEFAULT_TENANT), (2, 'c')])
    led.charge_request('prefill', 1, 'z')       # default -> z
    led.add_spec([], proposed=3, accepted=1)    # no parties: no-op
    led.end_step({'decode': 3.0, 'prefill': 1.0, 'upload': 0.0},
                 wall=4.5)
    led.begin_step()
    led.end_step({'tier_wait': 0.5}, wall=0.25)  # remainder < 0
    return led


def _fleet_view(mod):
    led1, led2 = mod.CostLedger(), mod.CostLedger()
    for led, tenant in ((led1, 'a'), (led2, 'b')):
        led.begin_step()
        led.charge_batch('decode', [(1, tenant)])
        led.end_step({'decode': 2.0}, wall=3.0)
    return mod.FleetLedgerView(lambda: [led1, led2, None])


SCRIPTS = {'batch_split': _batch_split, 'request_owner': _request_owner,
           'overhead': _overhead, 'tokens_blocks': _tokens_blocks,
           'tier_nobody': _tier_nobody,
           'default_upgrade': _default_upgrade, 'fleet_view': _fleet_view}


def _bill(led):
    out = {'tenants': led.tenant_rollup(), 'summary': led.summary(),
           'top': led.top_tenants(3), 'steps': led.steps,
           'wall': led.wall_seconds}
    if hasattr(led, 'session_rollup'):
        out['sessions'] = led.session_rollup()
        out['requests'] = sorted(
            (a.rid, a.tenant, a.session, a.finished, a.rollup(),
             sorted(a.device_seconds.items()))
            for a in led.request_accounts())
    return out


@pytest.mark.parametrize('script', sorted(SCRIPTS))
def test_ledger_matches_reference(script):
    got = _bill(SCRIPTS[script](accounting))
    want = _bill(SCRIPTS[script](j_accounting))
    assert got == want
    if script != 'default_upgrade':     # its second step's phases > wall
        assert got['summary']['conservation_ratio'] == pytest.approx(1.0)


def test_rank_and_summarize_match_reference():
    roll = {'a': {'device_seconds': 2.0, 'requests': 1},
            'b': {'device_seconds': 5.0, 'requests': 2},
            accounting.FLEET_TENANT: {'device_seconds': 9.0}}
    assert accounting.rank_tenants(roll, 2) == \
        j_accounting.rank_tenants(roll, 2)
    assert accounting.summarize_rollup(roll, wall=16.0, steps=3) == \
        j_accounting.summarize_rollup(roll, wall=16.0, steps=3)
    assert (accounting.BATCH_PHASES, accounting.REQUEST_PHASES,
            accounting.FLEET_TENANT, accounting.DEFAULT_TENANT) == \
        (j_accounting.BATCH_PHASES, j_accounting.REQUEST_PHASES,
         j_accounting.FLEET_TENANT, j_accounting.DEFAULT_TENANT)


def test_ledger_metrics_export_moves_the_port_families():
    def val(name, **labels):
        return REGISTRY.get_sample_value(name, labels or None) or 0.0

    keys = [('skytpu_acct_device_seconds_total',
             dict(tenant='acct-port', phase='decode')),
            ('skytpu_acct_device_seconds_total',
             dict(tenant='_fleet', phase='other')),
            ('skytpu_acct_requests_total', dict(tenant='acct-port')),
            ('skytpu_acct_tokens_total', dict(tenant='acct-port',
                                              kind='decode')),
            ('skytpu_acct_block_seconds_total', dict(tenant='acct-port')),
            ('skytpu_acct_spec_waste_tokens_total',
             dict(tenant='acct-port'))]
    before = [val(n, **l) for n, l in keys]
    led = accounting.CostLedger(export_metrics=True)
    led.begin_step()
    led.charge_batch('decode', [(1, 'acct-port')])
    led.add_tokens(1, 'acct-port', decode=5)
    led.note_blocks([(1, 'acct-port', 2)])
    led.add_spec([(1, 'acct-port')], proposed=4, accepted=1)
    led.end_step({'decode': 2.0}, wall=2.5)
    led.finish_request(1, 'acct-port')
    delta = [val(n, **l) - b for (n, l), b in zip(keys, before)]
    assert delta == pytest.approx([2.0, 0.5, 1.0, 5.0, 5.0, 3.0])


# ---- the batchers' charges -------------------------------------------------

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


def _tick_clock():
    ticks = itertools.count(1)
    return lambda: float(next(ticks))


CASES = {
    'pooled': dict(),
    'chunked': dict(prefill_chunk=16),
    'spec': dict(spec_k=3),
    'fused': dict(prefill_chunk=16, fuse_budget=8),
    'prefix': dict(prefix_cache_mb=4, prefix_block=8),
}


def _serve(b):
    rids = [b.submit(p, max_new_tokens=6, tenant=t)
            for p, t in zip(PROMPTS, TENANTS)]
    b.run_until_idle()
    return [b.result(r) for r in rids]


@pytest.mark.parametrize('case', sorted(CASES))
def test_batchers_bill_the_same_tenants(models, case):
    jp, tp = models
    kw = dict(max_seq_len=128, batch_size=2, temperature=0.0,
              prompt_buckets=[16, 32, 64], **CASES[case])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jled, led = j_accounting.CostLedger(), accounting.CostLedger()
        jb = j_serving.ContinuousBatcher(
            jp, J_CFG, j_engine.GeneratorConfig(**kw), decode_chunk=4,
            ledger=jled, profiler_clock=_tick_clock())
        b = ContinuousBatcher(tp, CFG, GeneratorConfig(**kw),
                              decode_chunk=4, device='cpu', ledger=led,
                              profiler_clock=_tick_clock())
        try:
            want, got = _serve(jb), _serve(b)
        finally:
            jb.close()
            b.close()
    assert got == want
    bill = _bill(led)
    assert bill == _bill(jled)
    assert set(bill['tenants']) >= {'a', 'b', 'default'}
    assert led.summary()['conservation_ratio'] == pytest.approx(1.0)
    tokens = {t: bill['tenants'][t]['decode_tokens'] for t in 'ab'}
    assert tokens == {t: sum(len(o) - 1 for o, tt in zip(got, TENANTS)
                             if tt == t) for t in 'ab'}
    if case == 'spec':
        assert any(r['spec_waste_tokens'] for r in bill['tenants'].values())
