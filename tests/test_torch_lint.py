"""The port's static analysis (skypilot_tpu_torch/analysis/: linter,
graph, concurrency, baseline) held against the JAX package's.

1. **Framework-neutral parity**: every SKY000/SKY2xx-SKY6xx case of
   tests/test_static_analysis.py gives the same (code, line) set through
   the reference linter and the port's.
2. **Graph and concurrency parity**: the port's graph.py over the JAX
   package gives the reference graph's stats and thread entries, and
   the port's SKY5xx over it the reference's findings.
3. **SKY1xx pairs**: each reference SKY101-SKY106 case translated into
   PyTorch's idiom (CUDA-graph capture in place of jit tracing) gives
   the reference case's codes and counts; static shape tests,
   ``is None``, ``host_fetch`` itself and a ``non_blocking=True`` upload
   stay clean.
4. **Injected defects** in the port's own engine and batcher.
5. **Package gate**: the port lints clean against its baseline (at most
   5 entries), fingerprints survive line drift, the call graph is not
   degenerate, the CLI's JSON contract holds, the call-graph re-base
   only removes SKY1xx findings, and phase 21's census gate.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

from skypilot_tpu.analysis import concurrency as ref_concurrency
from skypilot_tpu.analysis import graph as ref_graph
from skypilot_tpu.analysis import linter as ref_linter
from skypilot_tpu_torch.analysis import baseline as baseline_lib
from skypilot_tpu_torch.analysis import concurrency
from skypilot_tpu_torch.analysis import graph as graph_lib
from skypilot_tpu_torch.analysis import linter

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_ROOT = os.path.join(REPO_ROOT, 'skypilot_tpu_torch')


def codes(source: str, path: str = 'infer/somefile.py'):
    return [v.code for v in linter.lint_source(textwrap.dedent(source),
                                               path)]


def codes_multi(sources):
    return [v.code for v in linter.lint_sources(
        {p: textwrap.dedent(s) for p, s in sources.items()})]


# ---------------------------------------------------------------------------
# 1. Framework-neutral parity with the reference linter
# ---------------------------------------------------------------------------

_RECOVERY = """
    def recover():
        try:
            relaunch()
        except ValueError:
            pass
"""
_RETRY = """
    def run(strategy):
        while True:
            try:
                strategy.recover()
            except Exception:
                continue
"""
_KILL = """
    class Fleet:
        def kill(self, rep):
            self.replicas.remove(rep)
"""
_POLL = """
    import time

    def wait(pred):
        while not pred():
            time.sleep(0.2)
"""
_HISTOGRAM = """
    from prometheus_client import Histogram
    from skypilot_tpu.metrics import REGISTRY

    H = Histogram('skytpu_x_seconds', 'x', registry=REGISTRY)
"""
_STAMP = """
    import time

    def stamp(span):
        span['t0'] = time.time()
        span['mono'] = time.monotonic()
"""
_PUMP = """
    import threading

    class Pump:
        def __init__(self):
            self._thread = threading.Thread(target=self._run,
                                            daemon=True)
            {lock_init}
            self.count = 0

        def start(self):
            self._thread.start()

        def stop(self):
            self._thread.join()

        def _run(self):
            for _ in range(100):
                {bump}

        def read(self):
            {read}
"""
_PAIR = """
    import threading

    class Pair:
        def __init__(self):
            self.a = threading.Lock()
            self.b = threading.Lock()

        def forward(self):
            with self.a:
                with self.b:
                    return 1

        def backward(self):
            with self.{first}:
                with self.{second}:
                    return 2
"""
_POLLER = """
    import threading

    class Poller:
        def __init__(self):
            self._thread = None

        def start(self):
            self._thread = threading.Thread(target=self._run,
                                            daemon=True)
            self._thread.start()
        {stop}
        def _run(self):
            return None
"""
_STEP_QUEUE = """
    import queue

    class ContinuousBatcher:
        def __init__(self):
            self._q = queue.Queue()

        def step(self):
            return self._pull()

        def _pull(self):
            {pull}
"""

# (id, path, source): single-module cases (lint_source).
SINGLE_CASES = [
    ('blocking-in-async', 'serve/load_balancer.py', """
        import time, requests

        async def handler(request):
            time.sleep(1)
            return requests.get('http://replica')
    """),
    ('sleep-poll-jobs', 'jobs/core.py', _POLL),
    ('sleep-poll-backoff', 'utils/backoff.py', _POLL),
    ('silent-except-jobs', 'jobs/pool.py', _RECOVERY),
    ('silent-except-engine', 'infer/engine.py', _RECOVERY),
    ('bare-except', 'infer/engine.py', """
        def recover():
            try:
                relaunch()
            except:
                raise SystemExit
    """),
    ('retry-jobs', 'jobs/controller.py', _RETRY),
    ('retry-serve', 'serve/autoscaler.py', _RETRY),
    ('retry-engine', 'infer/engine.py', _RETRY),
    ('launch-loop', 'jobs/controller.py', """
        def run(strategy):
            while True:
                strategy.launch()
    """),
    ('retry-backoff', 'jobs/controller.py', """
        from skypilot_tpu.utils.backoff import Backoff

        def run(strategy):
            backoff = Backoff(initial=1.0, cap=30.0)
            while True:
                try:
                    strategy.recover()
                except Exception:
                    backoff.sleep()
    """),
    ('retry-attempts', 'jobs/controller.py', """
        def run(strategy, max_recovery_attempts):
            for attempt in range(max_recovery_attempts):
                try:
                    return strategy.recover()
                except Exception:
                    continue
    """),
    ('monitor-returns', 'jobs/controller.py', """
        def monitor(strategy):
            while True:
                try:
                    status = strategy.recover()
                except Exception:
                    return None
                if status is not None:
                    return status
    """),
    ('kill-serve', 'serve/manager.py', _KILL),
    ('kill-jobs', 'jobs/pool.py', _KILL),
    ('kill-engine', 'infer/engine.py', _KILL),
    ('evict-pop', 'serve/manager.py', """
        def evict(replica_map, url):
            replica_map.pop(url)
    """),
    ('evict-del', 'serve/manager.py', """
        def evict(replicas_by_url, url):
            del replicas_by_url[url]
    """),
    ('kill-cleanup', 'serve/manager.py', """
        class Fleet:
            def kill(self, rep):
                self.replicas.remove(rep)
                self.ring.remove_member(rep.url)
                self.breaker.forget(rep.url)
    """),
    ('kill-sync-policy', 'serve/manager.py', """
        class Fleet:
            def kill(self, rep):
                self.replicas.remove(rep)
                self._sync_policy()
    """),
    ('trim-queue', 'serve/manager.py', """
        def trim(queue):
            queue.pop(0)
    """),
    ('kill-nested-cleanup', 'serve/manager.py', """
        class Fleet:
            def kill(self, rep):
                self.replicas.remove(rep)
                def later():
                    self.ring.remove_member(rep.url)
    """),
    ('kill-allowed', 'serve/manager.py', """
        class Fleet:
            def kill(self, rep):
                self.replicas.remove(rep)  # skytpu-allow: SKY304
    """),
    ('metric-dotted', 'serve/load_balancer.py', """
        import prometheus_client

        REQS = prometheus_client.Counter('skytpu_lb_requests_total',
                                         'requests')
    """),
    ('metric-registry-kw', 'serve/load_balancer.py', """
        from prometheus_client import Gauge
        from skypilot_tpu.metrics import REGISTRY

        DEPTH = Gauge('skytpu_lb_queue_depth', 'depth',
                      registry=REGISTRY)
    """),
    ('metric-home', 'telemetry/metrics.py', _HISTOGRAM),
    ('metric-utils-home', 'metrics/utils.py', _HISTOGRAM),
    ('metric-allowed', 'serve/load_balancer.py', """
        from prometheus_client import Gauge

        G = Gauge('skytpu_y', 'y', registry=None)  # skytpu-allow: SKY401
    """),
    ('collections-counter', 'serve/spot_placer.py', """
        import collections

        def tally(xs):
            return collections.Counter(xs)
    """),
    ('bare-counter', 'analysis/baseline.py', """
        from collections import Counter

        def tally(xs):
            return Counter(xs)
    """),
    ('wall-clock-serve', 'serve/load_balancer.py', _STAMP),
    ('wall-clock-telemetry', 'telemetry/spans.py', _STAMP),
    ('wall-clock-serving', 'infer/serving.py', _STAMP),
    ('wall-clock-jobs', 'jobs/core.py', _STAMP),
    ('wall-clock-engine', 'infer/engine.py', _STAMP),
    ('injected-clock', 'serve/load_balancer.py', """
        import time

        class LB:
            def __init__(self, clock=None):
                self._clock = clock or time.time

            def now(self):
                return self._clock()

        def span_len(t0):
            return time.perf_counter() - t0
    """),
    ('wall-clock-allowed', 'serve/serve_state.py', """
        import time

        def stamp():
            return time.time()  # skytpu-allow: SKY402
    """),
    ('parse-error', 'infer/somefile.py', 'def broken(:\n'),
]

# (id, {path: source}): whole-program cases (lint_sources).
MULTI_CASES = [
    ('sky501-unlocked', {'pkg/pump.py': _PUMP.format(
        lock_init='pass', bump='self.count += 1',
        read='return self.count')}),
    ('sky501-locked', {'pkg/pump.py': _PUMP.format(
        lock_init='self._lock = threading.Lock()',
        bump='with self._lock:\n                    self.count += 1',
        read='with self._lock:\n                return self.count')}),
    ('sky502-cycle', {'pkg/pair.py': _PAIR.format(first='b', second='a')}),
    ('sky502-ordered', {'pkg/pair.py': _PAIR.format(first='a',
                                                    second='b')}),
    ('sky503-unjoined', {'pkg/poller.py': _POLLER.format(stop='')}),
    ('sky503-joined', {'pkg/poller.py': _POLLER.format(stop="""
        def stop(self):
            if self._thread is not None:
                self._thread.join(timeout=5)
""")}),
    ('sky504-get', {'infer/serving.py': _STEP_QUEUE.format(
        pull='return self._q.get()')}),
    ('sky504-timeout', {'infer/serving.py': _STEP_QUEUE.format(
        pull='try:\n                return self._q.get(timeout=0.1)\n'
             '            except queue.Empty:\n'
             '                return None')}),
    ('unused-suppression', {'pkg/x.py': """
        def f():
            return 1  # skytpu-allow: SKY101
    """}),
    ('docstring-marker', {'pkg/x.py': '''
        def f():
            """Docs about # skytpu-allow: SKY101 markers."""
            return 1
    '''}),
]


def _pairs(violations):
    return sorted((v.path, v.line, v.code) for v in violations)


@pytest.mark.parametrize('case', SINGLE_CASES, ids=[c[0] for c in
                                                    SINGLE_CASES])
def test_neutral_case_matches_reference(case):
    _, path, source = case
    source = textwrap.dedent(source)
    want = _pairs(ref_linter.lint_source(source, path))
    got = _pairs(linter.lint_source(source, path))
    assert got == want


@pytest.mark.parametrize('case', MULTI_CASES, ids=[c[0] for c in
                                                   MULTI_CASES])
def test_neutral_program_matches_reference(case):
    _, sources = case
    sources = {p: textwrap.dedent(s) for p, s in sources.items()}
    want = _pairs(ref_linter.lint_sources(sources))
    got = _pairs(linter.lint_sources(sources))
    assert got == want


def test_neutral_cases_fire_as_the_reference_tests_say():
    """The parity above is not parity of silence: the cases that the
    reference's own tests expect to fire do fire in the port."""
    by_id = {c[0]: c for c in SINGLE_CASES}
    fired = {i: codes(by_id[i][2], by_id[i][1]) for i in by_id}
    assert fired['blocking-in-async'].count('SKY201') == 2
    assert 'SKY202' in fired['sleep-poll-jobs']
    assert 'SKY202' not in fired['sleep-poll-backoff']
    assert fired['bare-except'] == ['SKY301']
    assert 'SKY302' in fired['silent-except-jobs']
    assert 'SKY303' in fired['retry-serve']
    assert 'SKY304' in fired['evict-del']
    assert 'SKY401' in fired['metric-registry-kw']
    assert fired['wall-clock-serve'].count('SKY402') == 2
    assert fired['parse-error'] == ['SKY000']
    multi = {c[0]: [v.code for v in linter.lint_sources(
        {p: textwrap.dedent(s) for p, s in c[1].items()})]
        for c in MULTI_CASES}
    assert multi['sky501-unlocked'] == ['SKY501']
    assert multi['sky502-cycle'] == ['SKY502']
    assert multi['sky503-unjoined'] == ['SKY503']
    assert multi['sky504-get'] == ['SKY504']
    assert multi['unused-suppression'] == ['SKY601']
    assert multi['sky501-locked'] == multi['sky504-timeout'] == []


# ---------------------------------------------------------------------------
# 2. Graph and concurrency parity over the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_package_graphs():
    ref = ref_graph.build_package_graph(REPO_ROOT)
    port = graph_lib.build_package_graph(REPO_ROOT, package='skypilot_tpu')
    return ref, port


def test_graph_of_the_jax_package_matches_reference(jax_package_graphs):
    ref, port = jax_package_graphs
    assert port.stats() == ref.stats()
    assert port.thread_entries == ref.thread_entries
    assert sorted(port.thread_edges) == sorted(ref.thread_edges)
    assert {k: sorted(v) for k, v in port.call_edges.items()} == \
        {k: sorted(v) for k, v in ref.call_edges.items()}


def test_sky5xx_over_the_jax_package_matches_reference(jax_package_graphs):
    ref, port = jax_package_graphs

    def collect(graph, check):
        found = []
        check(graph, lambda path, node, code, message: found.append(
            (path, getattr(node, 'lineno', 0), code, message)))
        return sorted(found)

    want = collect(ref, ref_concurrency.check)
    got = collect(port, concurrency.check)
    assert want, 'the reference finds SKY5xx sites (allowed by markers)'
    assert got == want


# ---------------------------------------------------------------------------
# 3. SKY1xx: the reference's JAX cases in PyTorch's idiom
# ---------------------------------------------------------------------------


def test_host_sync_in_captured_body():
    # @jax.jit def step(x): int(x)  ->  run_chunk's body reads int(x).
    assert 'SKY101' in codes("""
        from skypilot_tpu_torch.infer import engine

        def decode(graphs, x):
            def body():
                return int(x)
            return engine.run_chunk(graphs, ('decode', 4), body)
    """)


def test_host_sync_in_graphs_run_target():
    # jax.jit(step) with step reading x.item()  ->  ChunkGraphs.run.
    assert 'SKY101' in codes("""
        def step():
            return TOKENS.item()

        def run(self):
            return self.graphs.run(('decode', 4), step)
    """)


def test_host_sync_in_cuda_graph_block():
    # lax.fori_loop body with np.asarray  ->  a torch.cuda.graph block.
    assert 'SKY101' in codes("""
        import numpy as np
        import torch

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                np.asarray(y)
    """)


@pytest.mark.parametrize('call', ['x.tolist()', 'x.cpu()', 'x.numpy()',
                                  "x.to('cpu')", 'float(x.sum())',
                                  'torch.cuda.synchronize()',
                                  'event.synchronize()'])
def test_every_host_sync_call_in_captured_code(call):
    assert codes(f"""
        import torch

        def decode(graphs, x, event):
            def body():
                return {call}
            return graphs.run(('k',), body)
    """) == ['SKY101']


def test_uncaptured_function_is_clean():
    # Host code may int()/.cpu()/np.asarray() freely.
    assert codes("""
        import numpy as np

        def host_side(x):
            return int(np.asarray(x.cpu()))
    """, path='jobs/host.py') == []


def test_tensor_control_flow():
    assert 'SKY102' in codes("""
        import torch

        def capture(g, x):
            with torch.cuda.graph(g):
                if x > 0:
                    x = x + 1
    """)
    assert codes("""
        def decode(graphs, done):
            def body():
                while not done.all():
                    done = done | True
                return done
            return graphs.run(('k',), body)
    """) == ['SKY102']


def test_static_control_flow_is_clean():
    # Keyword-only params are static, `is None` / isinstance never read
    # values, and shapes are fixed under a graph key.
    assert codes("""
        import torch

        def capture(g, x, *, n):
            with torch.cuda.graph(g):
                if n > 2:
                    x = x + 1
                if x is None:
                    return 0
                if isinstance(x, dict):
                    return x['a']
                if x.shape[0] > 2 and x.dim() == 2 and len(x) > 1:
                    x = x[:2]
                if x.size(1) == 4 or x.dtype == torch.int8:
                    x = x.float()
                return x
    """) == []


def test_impure_and_seed_in_captured_code():
    got = codes("""
        import time
        import torch

        def decode(graphs, x):
            def body():
                time.monotonic()
                print(x)
                torch.manual_seed(0)
                return x
            return graphs.run(('k',), body)
    """)
    assert got.count('SKY103') == 2 and 'SKY104' in got
    assert 'SKY104' in codes("""
        import torch

        def decode(graphs, x):
            def body():
                gen = torch.Generator(device='cuda').manual_seed(1)
                return torch.rand(x.shape, generator=gen)
            return graphs.run(('k',), body)
    """)


def test_f64_promotion():
    got = codes("""
        import torch

        def make(x):
            a = torch.zeros(3, dtype=torch.float64)
            b = x.double()
            return a, b
    """)
    assert got.count('SKY106') == 2
    assert codes("""
        import numpy as np

        def make(x):
            a = np.zeros(3, dtype='float64')
            b = np.float64(x)
            return a, b
    """).count('SKY106') == 2


def test_host_fetch_bypass_only_in_data_plane():
    bad = """
        import numpy as np
        import torch

        def drain(x, host, dev):
            a = x.cpu()
            b = torch.as_tensor(host, device=dev)
            x.copy_(torch.from_numpy(host))
            return a, b, torch.from_numpy(host).to(dev)
    """
    assert codes(bad, path='infer/serving.py').count('SKY105') == 4
    # Same code outside the decode data plane is fine...
    assert 'SKY105' not in codes(bad, path='jobs/core.py')
    # ...host_fetch itself is THE sanctioned transfer point...
    assert 'SKY105' not in codes("""
        def host_fetch(*tensors):
            return tuple(t.to('cpu').numpy() for t in tensors)
    """, path='infer/engine.py')
    # ...and a non-blocking upload, a host tensor and a cast never wait.
    assert codes("""
        import torch

        def upload(x, host, dev):
            x.copy_(torch.from_numpy(host), non_blocking=True)
            a = torch.from_numpy(host).to(dev, non_blocking=True)
            b = torch.as_tensor(host, device='cpu')
            c = torch.from_numpy(host).to(torch.int32)
            return a, b, c, torch.zeros(3, device=dev)
    """, path='infer/serving.py') == []


def test_inline_allow_suppresses():
    assert codes("""
        def decode(graphs, x):
            def body():
                return int(x)  # skytpu-allow: SKY101
            return graphs.run(('k',), body)
    """) == []
    assert codes_multi({'infer/x.py': """
        def decode(graphs, x):
            def body():
                return int(x)  # skytpu-allow: SKY101
            return graphs.run(('k',), body)
    """}) == []


def test_captured_discovery_follows_indirect_calls():
    # `inner` is never handed to a capture; only the call edge from the
    # captured body marks it.  The one-module pass does not follow it.
    src = """
        def inner(x):
            print(x)
            return x

        def decode(graphs, x):
            return graphs.run(('k',), lambda: inner(x))
    """
    assert 'SKY103' in codes_multi({'infer/model.py': src})
    assert 'SKY103' not in codes(src, path='infer/model.py')


def test_captured_discovery_resolves_methods():
    # x.item() in a helper reached only through self-method resolution.
    assert 'SKY101' in codes_multi({'infer/model.py': """
        from skypilot_tpu_torch.infer import engine

        class Decoder:
            def _helper(self, x):
                return x.item()

            def run(self, x):
                return engine.run_chunk(self.graphs, ('k',),
                                        lambda: self._helper(x))
    """})


def test_indirect_helpers_keep_static_arguments():
    # A helper reached over call edges may int() its static arguments
    # (annotated as anything but a tensor, or keyword-only); int() of a
    # tensor parameter's values is still a host sync.
    got = [v for v in linter.lint_sources({'infer/model.py': textwrap.dedent(
        """
        import torch

        def helper(token: torch.Tensor, n: int, pos, *, width):
            k = int(n) + int(width) + int(pos.shape[0])
            return token[:k], int(token[0]), bool(pos.any())

        def decode(graphs, token, pos):
            return graphs.run(('k',), lambda: helper(token, 4, pos, width=8))
        """)}) if v.code == 'SKY101']
    assert [(v.line, v.col) for v in got] == [(6, 22), (6, 37)]


def test_dead_code_not_treated_as_captured():
    assert codes_multi({'infer/model.py': """
        def orphan_step_fn(x):
            print(x)
            return x.item()
    """}) == []


# ---------------------------------------------------------------------------
# 4. Injected defects in the port's own source
# ---------------------------------------------------------------------------


def _read(rel):
    with open(os.path.join(PACKAGE_ROOT, rel), encoding='utf-8') as f:
        return f.read().splitlines(keepends=True)


def _inject(lines, anchor, statement):
    """lines with `statement` at the head of the def named by anchor."""
    at = next(i for i, ln in enumerate(lines) if anchor in ln)
    body_at = next(i for i in range(at, len(lines))
                   if lines[i].split('#')[0].rstrip().endswith(':')) + 1
    # Skip the docstring, if any.
    if lines[body_at].strip().startswith('"""'):
        body_at = next(i for i in range(body_at, len(lines))
                       if lines[i].rstrip().endswith('"""')
                       and (i > body_at
                            or lines[i].strip().count('"""') == 2)) + 1
    return ''.join(lines[:body_at] + [statement] + lines[body_at:]), \
        body_at + 1


def test_int_in_decode_chunk_impl_is_lint_caught():
    path = 'skypilot_tpu_torch/infer/engine.py'
    lines = _read('infer/engine.py')
    assert not [v for v in linter.lint_sources({path: ''.join(lines)})
                if v.code == 'SKY101'], 'engine.py must start clean'
    injected, line = _inject(lines, 'def _decode_chunk_impl',
                             '        _bad = int(token[0])\n')
    got = [v for v in linter.lint_sources({path: injected})
           if v.code == 'SKY101']
    assert [v.line for v in got] == [line], got
    # _decode_chunk_impl is captured only because _chunk's body closure
    # calls it: the one-module pass, which follows no call edge, is
    # blind to it.
    assert not [v for v in linter.lint_source(injected, path)
                if v.code == 'SKY101']


def test_item_on_the_batcher_step_is_host_fetch_bypass():
    path = 'skypilot_tpu_torch/infer/serving.py'
    lines = _read('infer/serving.py')
    before = {(v.line, v.code) for v in linter.lint_source(''.join(lines),
                                                          path)}
    injected, line = _inject(lines, '    def step(self)',
                             '        _bad = self._token[0].item()\n')
    got = [v for v in linter.lint_source(injected, path)
           if v.code == 'SKY105' and v.line == line]
    assert got, 'an .item() on ContinuousBatcher.step must be SKY105'
    assert len(before) == len({(v.line if v.line < line else v.line - 1,
                                v.code)
                               for v in linter.lint_source(injected, path)
                               if v.line != line})


# ---------------------------------------------------------------------------
# 5. Package gate + baseline discipline
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def port_findings():
    allowed = []
    found = linter.lint_paths([PACKAGE_ROOT], root=REPO_ROOT,
                              allowed=allowed)
    return found, allowed


def test_port_lints_clean_against_baseline(port_findings):
    violations, _ = port_findings
    new, _, stale = baseline_lib.diff_baseline(
        violations, baseline_lib.load_baseline())
    assert not new, ('NEW lint violations (fix them or, if sanctioned, '
                     'mark "# skytpu-allow: <code>"):\n'
                     + '\n'.join(v.format() for v in new))
    assert not stale, f'stale baseline entries: {stale}'


def test_baseline_must_not_grow():
    assert len(baseline_lib.load_baseline()) <= 5


def test_every_marker_suppresses_a_finding(port_findings):
    # SKY601 is a finding like any other, so a clean lint has no stale
    # marker; the markers the port carries each suppress one.
    violations, allowed = port_findings
    assert not [v for v in violations if v.code == 'SKY601']
    assert allowed


def test_baseline_fingerprint_survives_line_drift():
    src = 'import time\n\ndef f():\n    while True:\n        time.sleep(1)\n'
    shifted = '# a new header comment\n' + src
    (fp1, _), = baseline_lib.fingerprint_violations(
        linter.lint_source(src, 'jobs/x.py'))
    (fp2, _), = baseline_lib.fingerprint_violations(
        linter.lint_source(shifted, 'jobs/x.py'))
    assert fp1 == fp2


def test_fingerprint_matches_reference():
    from skypilot_tpu.analysis import baseline as ref_baseline
    src = 'import time\n\ndef f():\n    while True:\n        time.sleep(1)\n'
    (fp, _), = baseline_lib.fingerprint_violations(
        linter.lint_source(src, 'jobs/x.py'))
    (want, _), = ref_baseline.fingerprint_violations(
        ref_linter.lint_source(src, 'jobs/x.py'))
    assert fp == want


def test_package_graph_stats_are_nonzero():
    stats = graph_lib.build_package_graph(REPO_ROOT).stats()
    assert stats['files'] > 50
    assert stats['functions'] > 1000
    assert stats['call_edges'] > 1000
    assert stats['thread_entries'] > 3


def test_sky1xx_graph_rebase_only_shrinks_findings():
    # On the current tree the whole-program pipeline may only REMOVE
    # SKY101-105 findings relative to the one-module pass, never add.
    sources = graph_lib.package_sources(REPO_ROOT)
    tracked = ('SKY101', 'SKY102', 'SKY103', 'SKY104', 'SKY105')
    old = {(v.path, v.line, v.code)
           for path, src in sources.items()
           for v in linter.lint_source(src, path)
           if v.code in tracked}
    new = {(v.path, v.line, v.code)
           for v in linter.lint_sources(sources)
           if v.code in tracked}
    assert new <= old, f'graph re-base ADDED findings: {new - old}'


def test_cli_json_and_graph_stats_contract():
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.analysis', '--json',
         '--graph-stats'],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert sorted(report) == ['audit', 'graph', 'new', 'ok',
                              'stale_baseline', 'suppressed']
    assert report['ok'] and report['new'] == [] and \
        report['audit'] is None
    assert report['graph']['functions'] and \
        report['graph']['call_edges'] and report['graph']['thread_entries']
    assert len(report['suppressed']) == len(baseline_lib.load_baseline())


def test_cli_lists_rules_and_updates_a_baseline(tmp_path):
    from skypilot_tpu_torch.analysis.__main__ import main
    assert main(['--list-rules']) == 0
    target = tmp_path / 'baseline.json'
    bad = tmp_path / 'serve' / 'bad.py'
    bad.parent.mkdir()
    bad.write_text('import time\n\ndef f():\n    return time.time()\n')
    assert main([str(bad), '--baseline', str(target)]) == 1
    assert main([str(bad), '--baseline', str(target),
                 '--update-baseline']) == 0
    assert len(baseline_lib.load_baseline(str(target))) == 1
    assert main([str(bad), '--baseline', str(target)]) == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_lint', os.path.join(REPO_ROOT, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_census_gate_holds_sites_against_the_linter():
    # Phase 21's gate on the CPU: a main-thread site passes inside
    # engine.host_fetch or on a line the linter flags SKY101/SKY105, and
    # fails elsewhere; other threads' sites are not gated.
    cs = _chip_smoke()
    flagged, host_fetch = cs.lint_flagged(REPO_ROOT)
    path, first, last = host_fetch
    assert path == 'skypilot_tpu_torch/infer/engine.py' and first < last
    assert flagged and all(p.startswith('skypilot_tpu_torch/')
                           for p, _ in flagged)
    some_flagged = '%s:%d' % sorted(flagged)[0]
    sites = {(f'{path}:{last}', 'MainThread'): 4,
             (some_flagged, 'MainThread'): 2,
             ('skypilot_tpu_torch/ops/rope.py:1', 'kv-tier-copy-torch'): 1}
    assert cs.census_gate(sites, flagged, host_fetch) == []
    sites[('skypilot_tpu_torch/ops/rope.py:1', 'MainThread')] = 3
    sites[(None, 'MainThread')] = 1
    assert cs.census_gate(sites, flagged, host_fetch) == [
        ('skypilot_tpu_torch/ops/rope.py:1', 3), (None, 1)]
