"""PyTorch- and CUDA-graph-aware AST linter: the static half of
skytpu-lint over the port's own source.

Stdlib ``ast`` only: it runs wherever the package's own dependencies
are installed, and imports nothing it analyses.

The rules encode the port's real failure classes, not generic style:
the decode data path (infer/engine.py, infer/serving.py) is fast
because sampling and eos tracking stay on the card, every chunk body is
captured once as a CUDA graph and replayed, and the host sees one
transfer a chunk through ``engine.host_fetch``; the serving plane stays
deterministic in virtual time because it reads injected clocks; and the
whole data plane is f32-or-below.  Each is a property that a one-line
diff can silently destroy.

Capture heuristic (no imports executed): a function is CAPTURED when it
is passed as ``body`` to ``engine.run_chunk(graphs, key, body)`` or to
``ChunkGraphs.run(key, body)`` (a ``.run`` on a receiver named
``*graphs*``), or when its statements run inside a
``with torch.cuda.graph(...)`` block.  Functions nested inside a
captured function are captured, and so (in :func:`lint_sources`) is
every package function that one reaches over the call graph.  A
captured body runs once eagerly and is then recorded: whatever it
decides on the host from device values, reads from the clock or prints
is baked into every replay, and a host sync inside it breaks the
capture.  Keyword-only parameters, and positional ones annotated as
anything but a tensor (``n: int``), are STATIC; so are shape tests
(``.shape``, ``.size()``, ``.dim()``, ``len``, ``.dtype``): shapes are
fixed under a graph key.

Suppression: append ``# skytpu-allow: SKY105`` (comma-separate for
several codes, ``*`` for all) to the violating line: this marks a
SANCTIONED host sync or blocking call.  Pre-existing violations live in
``analysis/baseline.json`` instead (see baseline.py): suppressed but
counted, and NEW ones fail.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# Rule catalog
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str


RULES: Dict[str, Rule] = {r.code: r for r in [
    Rule('SKY000', 'parse-error',
         'file does not parse — nothing else can be checked'),
    Rule('SKY101', 'host-sync-in-jit',
         'host-sync call (.item()/.tolist()/.cpu()/.numpy()/.to("cpu")/'
         'int/float/bool of a value/np.asarray/torch.cuda.synchronize/'
         'Event or Stream .synchronize()) inside CUDA-graph-captured code '
         '— a device round-trip at capture that the replay never repeats, '
         'or a capture that fails'),
    Rule('SKY102', 'tracer-control-flow',
         'Python if/while on a tensor value (.any()/.all()/a comparison '
         'of a tensor) inside captured code — decided once at capture '
         'and baked into every replay'),
    Rule('SKY103', 'impure-in-jit',
         'impure call (time.*/print/np.random.*/random.*) inside '
         'captured code — runs once at capture only, silently baked '
         'into the replayed graph'),
    Rule('SKY104', 'prng-seed-in-jit',
         'torch.manual_seed(constant) or Generator.manual_seed(constant) '
         'inside captured code — every replay draws the same noise'),
    Rule('SKY105', 'host-fetch-bypass',
         'device->host transfer (.item()/.tolist()/.cpu()/.numpy()/'
         'np.asarray/synchronize) or synchronizing upload (torch.tensor/'
         'as_tensor onto a device, .to(device)/.copy_ from host memory '
         'without non_blocking=True) in a decode data-plane module '
         'outside engine.host_fetch — an uncounted host wait breaks the '
         'one-transfer-per-chunk contract'),
    Rule('SKY106', 'f64-promotion',
         'float64 dtype (torch.float64/torch.double/.double()/'
         'np.float64/"float64") — silent f32->f64 promotion doubles '
         'bandwidth and falls off the tensor cores'),
    Rule('SKY201', 'blocking-in-async',
         'blocking call (time.sleep/requests/sqlite3/subprocess/'
         'urlopen) inside an async handler — stalls the event loop '
         'for every in-flight request'),
    Rule('SKY202', 'sleep-poll-loop',
         'constant time.sleep inside a polling loop — use '
         'skypilot_tpu_torch.utils.backoff (bounded exponential backoff) '
         'instead of a fixed-rate spin'),
    Rule('SKY301', 'bare-except',
         "bare 'except:' — swallows KeyboardInterrupt/SystemExit and "
         'every recovery signal'),
    Rule('SKY302', 'silent-except',
         'except handler whose body is only pass/continue in a jobs/'
         'serve recovery path — log it or re-raise'),
    Rule('SKY303', 'unbounded-recovery-loop',
         "'while True' recovery loop (recover/launch retried on "
         'failure) without a Backoff or attempt bound in a jobs/serve '
         'recovery path — a capacity stall spins forever instead of '
         'surfacing a terminal failed-recovery status'),
    Rule('SKY304', 'replica-removal-without-cleanup',
         'replica removed from a membership collection in a jobs/'
         'serve path without hashring/health/breaker cleanup in the '
         'same function — the consistent-hash ring keeps routing '
         'sessions at the dead replica and the circuit breaker leaks '
         'its per-replica state'),
    Rule('SKY401', 'metric-family-outside-registry',
         'Prometheus metric family (Counter/Gauge/Histogram/Summary/'
         'Info) instantiated outside telemetry/metrics.py — families '
         'must live in the shared-registry module so the metrics<->docs '
         'parity test sees every skytpu_* name and a re-import cannot '
         'collide on duplicate registration'),
    Rule('SKY402', 'wall-clock-in-data-plane',
         'direct time.time()/time.monotonic() call in a serving '
         'data-plane module (serve/, telemetry/, infer/serving.py) — '
         'these classes take injectable clocks (span_clock/'
         'profiler_clock/clock=/now=); a direct wall-clock read '
         'bypasses the injected clock and breaks virtual-time '
         'determinism (simulator summaries, postmortem bundles, '
         'frozen-clock tests)'),
    Rule('SKY501', 'unsynced-cross-thread-state',
         'attribute written from thread-plane code (reachable from a '
         'Thread(target=...)/submit entry) and read or written from '
         'main-plane code with no lock held in common at every site — '
         'torn reads / lost updates under the race'),
    Rule('SKY502', 'lock-order-cycle',
         'two locks acquired in opposite orders on different code paths '
         '(or a non-reentrant Lock re-acquired while held) — classic '
         'ABBA deadlock risk'),
    Rule('SKY503', 'leaked-thread-or-resource',
         'a started thread or thread-owning resource stored on a class '
         'none of whose methods ever join/close it, or a fire-and-'
         'forget local thread — the shutdown-leak class'),
    Rule('SKY504', 'blocking-hot-path',
         'unbounded blocking call (queue.get/.join()/.acquire()/.wait() '
         'without timeout, time.sleep) reachable from the serving hot '
         'path (ContinuousBatcher.step) — one wedged worker stalls '
         'every in-flight request'),
    Rule('SKY601', 'unused-suppression',
         'a # skytpu-allow: marker that no longer suppresses any '
         'violation — delete it so the allow-list can only shrink'),
]}

# Modules whose device->host transfers must route through
# engine.host_fetch (the countable sync point of the decode data path),
# and whose uploads must not make the host wait for the stream.
DATA_PLANE_MODULES = (
    'infer/engine.py',
    'infer/serving.py',
    'infer/multihost.py',
    'infer/multihost_check.py',
    'infer/prefix_cache.py',
    'infer/block_pool.py',
    'infer/spec_decode.py',
    'infer/fuse.py',
    'infer/kv_tier.py',
    'serve/disagg.py',
)

# SKY202's sanctioned home: the bounded-backoff helper is ALLOWED to
# sleep inside its own retry loop — that is the whole point of routing
# polling through it.
SLEEP_ALLOWLIST_MODULES = (
    'utils/backoff.py',
)

# SKY401's sanctioned homes: the shared-registry modules where every
# metric family must be defined (telemetry/metrics.py owns the port's
# skytpu_* families and its REGISTRY; metrics/utils.py is the JAX
# package's home for the same, kept so both trees lint alike).
METRIC_MODULE_ALLOWLIST = (
    'telemetry/metrics.py',
    'metrics/utils.py',
)

# Constructor names that create a Prometheus metric family.  A bare
# name only counts with a `registry=` kwarg — `collections.Counter`
# and a plain `Counter(...)` mapping must never fire this rule.
_METRIC_FAMILY_NAMES = ('Counter', 'Gauge', 'Histogram', 'Summary',
                        'Info')

# Paths (relative, '/'-normalized) whose except handlers are recovery
# paths: a swallowed error there turns a recoverable failure into a
# silent hang.
RECOVERY_PATH_PREFIXES = ('jobs/', 'serve/')

# SKY402's scope: the serving data plane, where every timing consumer
# takes an injectable clock (ContinuousBatcher span_clock/
# profiler_clock, SLOMonitor now=, SpanBuffer clock=) precisely so the
# virtual-time simulator can drive it deterministically.  `time.sleep`
# and `time.perf_counter` are out of scope: sleeping is SKY201/202's
# beat, and perf_counter deltas never leak into recorded timestamps.
WALL_CLOCK_PLANE_PREFIXES = ('serve/', 'telemetry/')
WALL_CLOCK_PLANE_MODULES = ('infer/serving.py',)
_WALL_CLOCK_CALLS = ('time.time', 'time.monotonic')

_PARTIAL = {'functools.partial', 'partial'}
# Capture entry points: a call whose dotted name ends in `run_chunk`
# takes its body third; `.run(key, body)` on a receiver whose name
# contains 'graphs' (ChunkGraphs, or a wrapper of one) second.
_RUN_CHUNK = 'run_chunk'
_GRAPHS_RUN_INDEX = 1
_RUN_CHUNK_INDEX = 2
_CUDA_GRAPH_CONTEXTS = ('torch.cuda.graph', 'cuda.graph')

_HOST_SYNC_NAMES = {'int', 'float', 'bool'}
_HOST_SYNC_DOTTED = {'np.asarray', 'np.array', 'numpy.asarray',
                     'numpy.array'}
# Methods that read a tensor back to the host (any receiver).
_HOST_SYNC_METHODS = ('item', 'tolist', 'cpu', 'numpy', 'synchronize')
_IMPURE_PREFIXES = ('time.', 'np.random.', 'numpy.random.', 'random.')
_SEED_CALLS = ('torch.manual_seed', 'torch.cuda.manual_seed',
               'torch.cuda.manual_seed_all', 'torch.random.manual_seed')
_F64_DOTTED = {'np.float64', 'numpy.float64', 'torch.float64',
               'torch.double'}
_F64_NAMES = ('float64', 'double', 'f64')
_BLOCKING_DOTTED_PREFIXES = ('requests.', 'subprocess.',
                             'urllib.request.')
_BLOCKING_DOTTED = {'time.sleep', 'sqlite3.connect',
                    'socket.create_connection'}
# Host-memory tensor constructors: their result lives on the host
# unless a device= says otherwise.
_HOST_TENSOR_CALLS = {'torch.from_numpy', 'torch.tensor',
                      'torch.as_tensor', 'torch.asarray'}
# Calls that build a device tensor from host data in one step.
_UPLOAD_CALLS = {'torch.tensor', 'torch.as_tensor', 'torch.asarray'}
# Accesses that read a tensor's static metadata, never its values.
_SHAPE_ATTRS = {'shape', 'dtype', 'device', 'ndim', 'is_cuda',
                'layout', 'requires_grad'}
_SHAPE_METHODS = {'size', 'dim', 'numel', 'element_size', 'stride',
                  'data_ptr', 'is_contiguous'}
_SHAPE_CALLS = {'len', 'isinstance', 'hasattr', 'type', 'id'}
# Tensor methods whose result is a tensor VALUE (a test on it is a
# host sync under eager and a frozen decision under capture).
_VALUE_METHODS = {'any', 'all', 'item', 'equal', 'allclose', 'sum',
                  'max', 'min', 'argmax', 'argmin', 'mean', 'count_nonzero'}


@dataclasses.dataclass
class Violation:
    path: str          # '/'-normalized, relative to the lint root
    line: int
    col: int
    code: str
    message: str
    text: str          # stripped source line (baseline fingerprint key)

    def format(self) -> str:
        return (f'{self.path}:{self.line}:{self.col}: {self.code} '
                f'[{RULES[self.code].name}] {self.message}')

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Small AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for nested Attributes, 'print' for Names."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return None if base is None else f'{base}.{node.attr}'
    return None


def _callable_targets(node: ast.AST) -> Tuple[List[str], List[ast.AST]]:
    """Names / lambda nodes a captured-callable expression refers to.

    ``self._decode_steps`` resolves by its attribute name (method
    lookup is scope-insensitive by design: a lint heuristic, not an
    interpreter); ``functools.partial(f, ...)`` unwraps to f.
    """
    if isinstance(node, ast.Name):
        return [node.id], []
    if isinstance(node, ast.Attribute):
        return [node.attr], []
    if isinstance(node, (ast.Lambda, ast.FunctionDef,
                         ast.AsyncFunctionDef)):
        return [], [node]
    if isinstance(node, ast.Call):
        fn = _dotted(node.func)
        if fn in _PARTIAL and node.args:
            return _callable_targets(node.args[0])
    return [], []


def _capture_body_arg(node: ast.Call) -> Optional[ast.AST]:
    """The body callable a capture entry point is handed, else None:
    ``run_chunk(graphs, key, body)`` and ``<..graphs..>.run(key, body)``
    (positional or ``body=``)."""
    fn = _dotted(node.func) or ''
    index = None
    if fn.rsplit('.', 1)[-1] == _RUN_CHUNK:
        index = _RUN_CHUNK_INDEX
    elif isinstance(node.func, ast.Attribute) and node.func.attr == 'run':
        receiver = _dotted(node.func.value) or ''
        if 'graphs' in receiver.rsplit('.', 1)[-1].lower():
            index = _GRAPHS_RUN_INDEX
    if index is None:
        return None
    for kw in node.keywords:
        if kw.arg == 'body':
            return kw.value
    return node.args[index] if index < len(node.args) else None


def _is_cuda_graph_with(node: ast.AST) -> bool:
    """``with torch.cuda.graph(g, ...):`` (its body is recorded)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and \
                _dotted(expr.func) in _CUDA_GRAPH_CONTEXTS:
            return True
    return False


def _is_static_test(test: ast.AST) -> bool:
    """Control-flow tests that never read a tensor's values: identity
    checks against None, dict-structure membership with a constant key,
    isinstance, and boolean combinations thereof."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_static_test(test.operand)
    if isinstance(test, ast.BoolOp):
        return all(_is_static_test(v) for v in test.values)
    if isinstance(test, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return True
        if (all(isinstance(op, (ast.In, ast.NotIn)) for op in test.ops)
                and isinstance(test.left, ast.Constant)):
            return True
        return False
    if isinstance(test, ast.Call):
        return _dotted(test.func) in ('isinstance', 'hasattr', 'len')
    return False


def _is_shape_access(node: ast.AST) -> bool:
    """A subexpression that reads static metadata only: ``x.shape``,
    ``x.size()``, ``x.dim()``, ``len(x)``, ``x.dtype``, ``isinstance``."""
    if isinstance(node, ast.Attribute) and node.attr in _SHAPE_ATTRS:
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SHAPE_METHODS:
            return True
        if _dotted(node.func) in _SHAPE_CALLS:
            return True
    return False


def _value_nodes(node: ast.AST):
    """Walk `node` without descending into shape accesses."""
    stack = [node]
    while stack:
        cur = stack.pop()
        if _is_shape_access(cur):
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def _value_names(node: ast.AST) -> Set[str]:
    """Names whose VALUES the expression reads (shape accesses do not)."""
    return {n.id for n in _value_nodes(node) if isinstance(n, ast.Name)}


def _reads_tensor_value(node: ast.AST) -> bool:
    """The expression calls a tensor-valued method (``.any()``,
    ``.sum()``, ...) or a ``torch.*`` function outside shape accesses."""
    for n in _value_nodes(node):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) and \
                n.func.attr in _VALUE_METHODS:
            return True
        if (_dotted(n.func) or '').startswith('torch.'):
            return True
    return False


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_is_literal(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_literal(node.operand)
    return False


def _static_params(args: ast.arguments) -> Set[str]:
    """Positional parameters that carry tensors: all but self/cls/config
    and the ones annotated as anything but a tensor (``n: int``,
    ``scaling: Dict[str, Any]``)."""
    out = set()
    for a in list(args.posonlyargs) + list(args.args):
        if a.arg in ('self', 'cls', 'config'):
            continue
        if a.annotation is not None and not any(
                'Tensor' in (_dotted(n) or '')
                or (isinstance(n, ast.Constant) and 'Tensor' in str(n.value))
                for n in ast.walk(a.annotation)):
            continue
        out.add(a.arg)
    if args.vararg:
        out.add(args.vararg.arg)
    return out


def _device_kw(node: ast.Call) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == 'device':
            return kw.value
    return None


def _is_cpu(node: Optional[ast.AST]) -> bool:
    """A literal host device: 'cpu' or torch.device('cpu')."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(':')[0] == 'cpu'
    if isinstance(node, ast.Call) and \
            _dotted(node.func) in ('torch.device', 'device') and node.args:
        return _is_cpu(node.args[0])
    return False


def _non_blocking(node: ast.Call) -> bool:
    return any(kw.arg == 'non_blocking' and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in node.keywords)


def _is_host_tensor(node: ast.AST) -> bool:
    """An expression that builds a tensor in host memory:
    ``torch.from_numpy(a)``, or ``torch.tensor``/``as_tensor`` without
    a device (or with device='cpu')."""
    if not isinstance(node, ast.Call):
        return False
    fn = _dotted(node.func)
    if fn not in _HOST_TENSOR_CALLS:
        return False
    device = _device_kw(node)
    return device is None or _is_cpu(device)


def _is_dtype_expr(node: ast.AST) -> bool:
    """``torch.int32``-like: a cast, not a move."""
    fn = _dotted(node) or ''
    return fn.startswith('torch.') and fn.rsplit('.', 1)[-1] not in (
        'device',)


def _host_sync_call(node: ast.Call) -> Optional[str]:
    """What makes `node` read a tensor back to the host, else None:
    the calls SKY101 flags in captured code and SKY105 in the data
    plane (int()/float()/bool() apart: those depend on their operand)."""
    fn = _dotted(node.func)
    if fn in _HOST_SYNC_DOTTED and node.args and \
            not _is_literal(node.args[0]):
        return f'{fn}()'
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _HOST_SYNC_METHODS:
            return f'.{attr}()'
        if attr == 'to':
            target = node.args[0] if node.args else _device_kw(node)
            if _is_cpu(target):
                return ".to('cpu')"
    return None


def _sync_upload_call(node: ast.Call) -> Optional[str]:
    """What makes `node` a synchronizing upload, else None: a tensor
    built from host data straight onto a device, or a host-memory
    tensor moved (``.to``) or copied (``.copy_``) onto one without
    ``non_blocking=True`` (the host waits for the stream)."""
    fn = _dotted(node.func)
    if fn in _UPLOAD_CALLS:
        device = _device_kw(node)
        if device is not None and not _is_cpu(device):
            return f'{fn}(..., device=...)'
        return None
    if not isinstance(node.func, ast.Attribute) or _non_blocking(node):
        return None
    attr = node.func.attr
    if attr == 'to' and _is_host_tensor(node.func.value):
        target = node.args[0] if node.args else _device_kw(node)
        if target is not None and not _is_cpu(target) and \
                not _is_dtype_expr(target):
            return '.to(device) of a host tensor'
    if attr == 'copy_' and node.args and _is_host_tensor(node.args[0]):
        return '.copy_(host tensor)'
    return None


def _device_tensor_attrs(cls: ast.ClassDef) -> Set[str]:
    """``self.x`` attributes of a class that some method binds to a
    tensor built on a device: ``self.x = torch.zeros(..., device=dev)``
    (any ``torch.*`` call with a device= that is not the host)."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if not (isinstance(value, ast.Call)
                and (_dotted(value.func) or '').startswith('torch.')):
            continue
        device = _device_kw(value)
        if device is None or _is_cpu(device):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for target in targets:
            if isinstance(target, ast.Attribute) and \
                    isinstance(target.value, ast.Name) and \
                    target.value.id == 'self':
                out.add(target.attr)
    return out


def _reads_device_attr(node: ast.AST, attrs: Set[str]) -> bool:
    """The expression reads the VALUES of a device-tensor attribute
    (``self._done[slot]``; ``self._done.shape`` does not)."""
    for n in _value_nodes(node):
        if isinstance(n, ast.Attribute) and n.attr in attrs and \
                isinstance(n.value, ast.Name) and n.value.id == 'self':
            return True
    return False


def _is_host_scalar(node: ast.AST, local_values: Dict[str, ast.AST],
                    attrs: Set[str], depth: int = 0) -> bool:
    """A Python number or bool computed on the host: a literal, a name
    bound to one in the same function, arithmetic of those, int()/len(),
    or a ``self`` attribute that is not a device tensor."""
    if depth > 4:
        return False
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, bool))
    if isinstance(node, ast.UnaryOp):
        return _is_host_scalar(node.operand, local_values, attrs, depth + 1)
    if isinstance(node, ast.BinOp):
        return all(_is_host_scalar(n, local_values, attrs, depth + 1)
                   for n in (node.left, node.right))
    if isinstance(node, ast.Name):
        value = local_values.get(node.id)
        return value is not None and _is_host_scalar(value, local_values,
                                                     attrs, depth + 1)
    if isinstance(node, ast.Call):
        return _dotted(node.func) in ('int', 'float', 'bool', 'len') \
            and not _reads_device_attr(node, attrs)
    if isinstance(node, ast.Attribute):
        return (isinstance(node.value, ast.Name) and node.value.id == 'self'
                and node.attr not in attrs)
    return False


def _local_values(fn: ast.AST) -> Dict[str, ast.AST]:
    """name -> value of the names a function binds exactly once by a
    plain assignment (nested defs excluded)."""
    seen: Dict[str, List[ast.AST]] = {}
    stack = list(getattr(fn, 'body', []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    seen.setdefault(target.id, []).append(node.value)
        elif isinstance(node, (ast.AugAssign, ast.For, ast.AnnAssign,
                               ast.NamedExpr)):
            target = getattr(node, 'target', None)
            if isinstance(target, ast.Name):
                seen.setdefault(target.id, []).extend([None, None])
        stack.extend(ast.iter_child_nodes(node))
    return {k: v[0] for k, v in seen.items() if len(v) == 1}


# ---------------------------------------------------------------------------
# Pass 1: discover captured functions
# ---------------------------------------------------------------------------


class _CapturedCollector(ast.NodeVisitor):
    """Collect every function and block the module hands to a CUDA-graph
    capture."""

    def __init__(self) -> None:
        self.defs_by_name: Dict[str, List[ast.AST]] = {}
        self.captured_names: Set[str] = set()
        self.captured_nodes: List[ast.AST] = []
        #: ``with torch.cuda.graph(...)`` statements and the positional
        #: parameters of their enclosing function.
        self.blocks: List[Tuple[ast.AST, Set[str]]] = []
        self._params: List[Set[str]] = [set()]

    def _mark(self, expr: ast.AST) -> None:
        names, nodes = _callable_targets(expr)
        self.captured_names.update(names)
        self.captured_nodes.extend(nodes)

    def visit_FunctionDef(self, node) -> None:
        self.defs_by_name.setdefault(node.name, []).append(node)
        self._params.append(_static_params(node.args))
        self.generic_visit(node)
        self._params.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node) -> None:
        if _is_cuda_graph_with(node):
            self.blocks.append((node, self._params[-1]))
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        body = _capture_body_arg(node)
        if body is not None:
            self._mark(body)
        self.generic_visit(node)

    def resolve(self) -> List[ast.AST]:
        out: List[ast.AST] = []
        seen: Set[int] = set()
        for node in self.captured_nodes:
            if id(node) not in seen:
                seen.add(id(node))
                out.append(node)
        for name in self.captured_names:
            for node in self.defs_by_name.get(name, []):
                if id(node) not in seen:
                    seen.add(id(node))
                    out.append(node)
        return out


# ---------------------------------------------------------------------------
# Pass 2: rules
# ---------------------------------------------------------------------------


class _Reporter:
    def __init__(self, path: str, source_lines: Sequence[str],
                 allow: Dict[int, Set[str]]):
        self.path = path
        self._lines = source_lines
        self._allow = allow
        self.violations: List[Violation] = []
        self._seen: Set[Tuple[int, int, str]] = set()
        #: lines whose allow-marker actually suppressed something (SKY601).
        self.used_allow_lines: Set[int] = set()
        #: the violations an allow-marker suppressed.
        self.allowed: List[Violation] = []

    def report(self, node: ast.AST, code: str, message: str) -> None:
        line = getattr(node, 'lineno', 0)
        col = getattr(node, 'col_offset', 0)
        key = (line, col, code)
        if key in self._seen:   # a def reachable via two capture edges
            return
        self._seen.add(key)
        text = (self._lines[line - 1].strip()
                if 0 < line <= len(self._lines) else '')
        violation = Violation(self.path, line, col, code, message, text)
        allowed = self._allow.get(line, set())
        if '*' in allowed or code in allowed:
            self.used_allow_lines.add(line)
            self.allowed.append(violation)
            return
        self.violations.append(violation)


def _walk_captured(fn_node: ast.AST, rep: _Reporter,
                   tracked: Set[str]) -> None:
    """Apply the in-capture rules (SKY101-104) to one captured function
    or ``with torch.cuda.graph`` block.

    ``tracked`` holds the names bound to tensors: the function's
    positional parameters (keyword-only ones, and ones annotated as
    anything but a tensor, are static) plus enclosing captured
    functions' parameters.
    """
    args = getattr(fn_node, 'args', None)
    if isinstance(args, ast.arguments):
        tracked = tracked | _static_params(args)

    body = fn_node.body if isinstance(fn_node.body, list) \
        else [fn_node.body]          # Lambda body is an expression

    def visit(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # Nested defs are captured too — recurse with their params.
            _walk_captured(node, rep, tracked)
            return
        if isinstance(node, ast.Call):
            _check_captured_call(node, rep, tracked, direct=True)
        if isinstance(node, (ast.If, ast.While)):
            _check_captured_test(node, rep, tracked)
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in body:
        visit(stmt)


def _check_captured_test(node, rep: _Reporter, tracked: Set[str]) -> None:
    """SKY102: an if/while whose test reads a tensor's values."""
    if _is_static_test(node.test):
        return
    names = _value_names(node.test) & tracked
    if names or _reads_tensor_value(node.test):
        what = (f'tensor value(s) {sorted(names)}' if names
                else 'a tensor value')
        rep.report(
            node, 'SKY102',
            f'Python control flow on {what} inside captured code — '
            'decided once at capture; use torch.where, or make the '
            'operand static (a graph key)')


def _check_captured_call(node: ast.Call, rep: _Reporter, tracked: Set[str],
                         direct: bool) -> None:
    """SKY101/103/104 on one call in captured code.  `direct`: the
    function was handed to the capture (or nests in one), so int()/
    float()/bool() of any value is flagged; a function only reached
    over call edges may take static scalars positionally, so there only
    operands that read a tracked tensor (``int(token[0])``) or a
    tensor-valued method are."""
    fn = _dotted(node.func)
    where = ('captured code' if direct
             else 'captured code (reached from a captured caller)')
    # SKY101: host syncs.
    if fn in _HOST_SYNC_NAMES and node.args and \
            not _is_literal(node.args[0]):
        arg = node.args[0]
        names = _value_names(arg)
        if not direct:
            names &= tracked
        if names or _reads_tensor_value(arg):
            rep.report(node, 'SKY101',
                       f'{fn}() on a value inside {where} reads the '
                       'tensor back to the host — keep it on the card, '
                       'or fetch it via engine.host_fetch outside the '
                       'chunk')
    else:
        sync = _host_sync_call(node)
        if sync:
            rep.report(node, 'SKY101',
                       f'{sync} inside {where} is a device->host sync — '
                       'route results through engine.host_fetch outside '
                       'the chunk')
    # SKY103: impure calls.
    if fn == 'print':
        rep.report(node, 'SKY103',
                   f'print() inside {where} runs once at capture only — '
                   'return the value and log it after the replay')
    elif fn and fn.startswith(_IMPURE_PREFIXES):
        rep.report(node, 'SKY103',
                   f'{fn}() inside {where} executes once at capture and '
                   'is baked into the replayed graph')
    # SKY104: constant seeds.
    seeded = (fn in _SEED_CALLS or (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == 'manual_seed'))
    if seeded and node.args and isinstance(node.args[0], ast.Constant):
        rep.report(node, 'SKY104',
                   'manual_seed(constant) inside captured code replays '
                   'identical noise every replay — seed the generator '
                   'outside the chunk and register it with the graph')


class _ModuleRuleVisitor(ast.NodeVisitor):
    """Module-wide rules: SKY105/106/201/202/301-304/401/402."""

    def __init__(self, rep: _Reporter, path: str):
        self.rep = rep
        self.path = path
        self.is_data_plane = path.endswith(DATA_PLANE_MODULES)
        self.sleep_allowed = path.endswith(SLEEP_ALLOWLIST_MODULES)
        self.metrics_allowed = path.endswith(METRIC_MODULE_ALLOWLIST)
        parts = path.split('/')[:-1]
        self.is_recovery = any(
            f'{p}/' in RECOVERY_PATH_PREFIXES for p in parts)
        self.is_wall_clock_plane = (
            path.endswith(WALL_CLOCK_PLANE_MODULES)
            or any(f'{p}/' in WALL_CLOCK_PLANE_PREFIXES
                   for p in parts))
        self._async_depth = 0
        self._loop_depth = 0
        self._in_host_fetch = False
        #: the enclosing class's device-tensor attributes, and the
        #: enclosing function's singly-bound locals (data plane only).
        self._device_attrs: Set[str] = set()
        self._locals: Dict[str, ast.AST] = {}

    # -- scope tracking ---------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev = self._device_attrs
        if self.is_data_plane:
            self._device_attrs = _device_tensor_attrs(node)
        self.generic_visit(node)
        self._device_attrs = prev

    def visit_AsyncFunctionDef(self, node) -> None:
        self._async_depth += 1
        if self.is_recovery:
            self._check_replica_cleanup(node)
        self.generic_visit(node)
        self._async_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # A sync def nested under an async handler is typically shipped
        # to an executor thread — blocking there is legal.  host_fetch
        # itself is THE sanctioned transfer point.
        prev_async, self._async_depth = self._async_depth, 0
        prev_hf = self._in_host_fetch
        prev_locals = self._locals
        if node.name == 'host_fetch':
            self._in_host_fetch = True
        if self.is_data_plane and self._device_attrs:
            self._locals = _local_values(node)
        if self.is_recovery:
            self._check_replica_cleanup(node)
        self.generic_visit(node)
        self._async_depth = prev_async
        self._in_host_fetch = prev_hf
        self._locals = prev_locals

    def _visit_loop(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_While(self, node: ast.While) -> None:
        if self.is_recovery:
            self._check_unbounded_recovery_loop(node)
        self._check_device_test(node)
        self._visit_loop(node)

    def visit_If(self, node: ast.If) -> None:
        self._check_device_test(node)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._device_attrs and not self._in_host_fetch:
            for target in node.targets:
                if (isinstance(target, ast.Subscript)
                        and isinstance(target.value, ast.Attribute)
                        and isinstance(target.value.value, ast.Name)
                        and target.value.value.id == 'self'
                        and target.value.attr in self._device_attrs
                        and _is_host_scalar(node.value, self._locals,
                                            self._device_attrs)):
                    self.rep.report(
                        target, 'SKY105',
                        f'a host scalar written into the device tensor '
                        f'self.{target.value.attr}: a synchronizing '
                        'upload (the host waits for the stream) outside '
                        'engine.host_fetch — write a device value, or '
                        'mark it  # skytpu-allow: SKY105')
        self.generic_visit(node)

    def _check_device_test(self, node) -> None:
        """SKY105: an if/while that reads a device tensor's values."""
        if self._device_attrs and not self._in_host_fetch and \
                not _is_static_test(node.test) and \
                _reads_device_attr(node.test, self._device_attrs):
            self.rep.report(
                node, 'SKY105',
                'control flow on a device tensor\'s value reads it back '
                'to the host outside engine.host_fetch — decide from the '
                'host mirror, or mark it  # skytpu-allow: SKY105')

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop

    # -- SKY303: unbounded while-True recovery loops ----------------------
    _RECOVERY_CALL_NAMES = {'launch', 'relaunch', '_launch_once'}

    @staticmethod
    def _walk_no_defs(node):
        """Walk a statement's subtree, not descending into nested
        function/class defs (their loops are their own scope)."""
        stack = list(ast.iter_child_nodes(node))
        while stack:
            child = stack.pop()
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            yield child
            stack.extend(ast.iter_child_nodes(child))

    @classmethod
    def _is_recovery_call(cls, node) -> bool:
        if not isinstance(node, ast.Call):
            return False
        fn = _dotted(node.func) or ''
        name = fn.rsplit('.', 1)[-1]
        return 'recover' in name or name in cls._RECOVERY_CALL_NAMES

    def _check_unbounded_recovery_loop(self, node: ast.While) -> None:
        if not (isinstance(node.test, ast.Constant)
                and node.test.value is True):
            return
        body_nodes = [n for stmt in node.body
                      for n in [stmt, *self._walk_no_defs(stmt)]]
        if not any(self._is_recovery_call(n) for n in body_nodes):
            return
        # Bounded if the loop references a backoff or an attempt/retry
        # counter (the bound may live one call down, e.g. inside
        # strategy.recover(), but then the loop names it).
        for n in body_nodes:
            ident = None
            if isinstance(n, ast.Name):
                ident = n.id
            elif isinstance(n, ast.Attribute):
                ident = n.attr
            if ident is not None:
                low = ident.lower()
                if ('backoff' in low or 'attempt' in low
                        or 'retries' in low or 'max_recovery' in low
                        or 'deadline' in low):
                    return
        # Shape 1: recovery call inside a try whose except falls
        # through (no raise/return/break) -> retries forever.
        unbounded = False
        for n in body_nodes:
            if not isinstance(n, ast.Try):
                continue
            try_nodes = [m for stmt in n.body
                         for m in [stmt, *self._walk_no_defs(stmt)]]
            if not any(self._is_recovery_call(m) for m in try_nodes):
                continue
            for handler in n.handlers:
                handler_nodes = [m for stmt in handler.body
                                 for m in [stmt,
                                           *self._walk_no_defs(stmt)]]
                if not any(isinstance(m, (ast.Raise, ast.Return,
                                          ast.Break))
                           for m in handler_nodes):
                    unbounded = True
        # Shape 2: bare retry loop with no exit at all.
        if not unbounded and not any(
                isinstance(n, (ast.Raise, ast.Return, ast.Break))
                for n in body_nodes):
            unbounded = True
        if unbounded:
            self.rep.report(
                node, 'SKY303',
                "'while True' retries recover/launch without a "
                'Backoff or attempt bound — cap it with '
                'max_recovery_attempts + utils.backoff.Backoff and '
                'surface a terminal failed-recovery status')

    # -- SKY304: replica removal without routing-state cleanup ------------
    # Identifier substrings that mark the function as ALSO tearing
    # down routing state (hashring arcs, health/breaker records) or
    # delegating to a helper that does (`_sync_policy`).
    _CLEANUP_HINTS = ('ring', 'health', 'breaker', 'sync_policy')

    def _check_replica_cleanup(self, node) -> None:
        """A function that drops a replica from a membership
        collection (`*replica*.pop/remove/discard(...)` or
        `del *replica*[...]`) must, in the SAME function, touch the
        routing state that referenced it — otherwise the hashring
        keeps owning arcs for a dead URL and the circuit breaker
        leaks its per-replica record.  Cleanup is recognized by any
        identifier containing one of _CLEANUP_HINTS (nested defs are
        their own scope and don't count)."""
        removals: List[ast.AST] = []
        idents: Set[str] = set()
        for n in self._walk_no_defs(node):
            if isinstance(n, ast.Name):
                idents.add(n.id.lower())
            elif isinstance(n, ast.Attribute):
                idents.add(n.attr.lower())
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in ('pop', 'remove', 'discard'):
                target = _dotted(n.func.value) or ''
                if 'replica' in target.lower():
                    removals.append(n)
            elif isinstance(n, ast.Delete):
                for tgt in n.targets:
                    if isinstance(tgt, ast.Subscript) and \
                            'replica' in (_dotted(tgt.value)
                                          or '').lower():
                        removals.append(n)
        if not removals:
            return
        if any(hint in ident for ident in idents
               for hint in self._CLEANUP_HINTS):
            return
        for n in removals:
            self.rep.report(
                n, 'SKY304',
                'replica removed from membership without hashring/'
                'health cleanup in the same function — also remove '
                'its ring arcs and breaker/health state (or call the '
                'policy-sync helper that does), or mark a sanctioned '
                'site  # skytpu-allow: SKY304')

    # -- rules ------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        fn = _dotted(node.func)
        self._check_f64_call(node)
        if not self.metrics_allowed:
            self._check_metric_family(node, fn)
        if self.is_wall_clock_plane and fn in _WALL_CLOCK_CALLS:
            self.rep.report(
                node, 'SKY402',
                f'{fn}() reads the wall clock directly in the serving '
                'data plane — read the class\'s injectable clock '
                '(span_clock/clock=/now=) so virtual-time runs stay '
                'deterministic, or mark a sanctioned wall-clock site  '
                '# skytpu-allow: SKY402')
        if self.is_data_plane and not self._in_host_fetch:
            self._check_host_fetch_bypass(node)
        if self._async_depth > 0:
            self._check_blocking(node, fn)
        elif (fn == 'time.sleep' and self._loop_depth > 0
              and not self.sleep_allowed and node.args
              and isinstance(node.args[0], ast.Constant)):
            self.rep.report(
                node, 'SKY202',
                'constant time.sleep in a polling loop — use '
                'skypilot_tpu_torch.utils.backoff.Backoff (bounded '
                'exponential backoff) so retries back off instead of '
                'spinning at a fixed rate')
        self.generic_visit(node)

    def _check_f64_call(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if kw.arg == 'dtype' and \
                    isinstance(kw.value, ast.Constant) and \
                    kw.value.value in _F64_NAMES:
                self.rep.report(node, 'SKY106',
                                f'dtype={kw.value.value!r} — f64 has no '
                                'tensor-core path and doubles bandwidth')
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == 'astype' and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                node.args[0].value in _F64_NAMES:
            self.rep.report(node, 'SKY106',
                            '.astype to f64 — f64 has no tensor-core path')
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == 'double' and not node.args:
            self.rep.report(node, 'SKY106',
                            '.double() casts to f64 — f64 has no '
                            'tensor-core path and doubles bandwidth')

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if _dotted(node) in _F64_DOTTED:
            self.rep.report(node, 'SKY106',
                            f'{_dotted(node)} literal — f64 has no '
                            'tensor-core path and doubles bandwidth')
        self.generic_visit(node)

    def _check_metric_family(self, node: ast.Call,
                             fn: Optional[str]) -> None:
        """SKY401: a metric-family constructor outside the registry
        modules.  Fires on dotted `prometheus_client.Counter(...)`
        regardless of kwargs, and on a bare `Counter(...)` ONLY when a
        `registry=` kwarg marks it as a Prometheus constructor —
        `collections.Counter(...)` never matches either shape."""
        if not fn or fn.rsplit('.', 1)[-1] not in _METRIC_FAMILY_NAMES:
            return
        dotted_prom = fn.startswith('prometheus_client.')
        bare_with_registry = '.' not in fn and any(
            kw.arg == 'registry' for kw in node.keywords)
        if dotted_prom or bare_with_registry:
            self.rep.report(
                node, 'SKY401',
                f'{fn}() creates a metric family outside '
                'telemetry/metrics.py — define it there (shared '
                'REGISTRY, one home the metrics<->docs parity test '
                'walks) and import it, or mark a sanctioned site  '
                '# skytpu-allow: SKY401')

    def _check_host_fetch_bypass(self, node: ast.Call) -> None:
        fn = _dotted(node.func)
        # A bare np.asarray(x) / np.array(x) (one operand, no dtype) is
        # the transfer shape; with a dtype it builds host data.
        if fn in _HOST_SYNC_DOTTED:
            what = (f'{fn}()' if len(node.args) == 1 and not node.keywords
                    and not _is_literal(node.args[0]) else None)
        elif fn in _HOST_SYNC_NAMES:
            what = (f'{fn}() of a device tensor' if node.args
                    and self._device_attrs and _reads_device_attr(
                        node.args[0], self._device_attrs) else None)
        else:
            what = _host_sync_call(node)
        if what:
            self.rep.report(
                node, 'SKY105',
                f'{what}: device->host transfer outside engine.host_fetch '
                '— the decode data plane counts its syncs '
                '(skytpu_infer_host_syncs_total); route this through '
                'engine.host_fetch or mark it  # skytpu-allow: SKY105')
            return
        upload = _sync_upload_call(node)
        if upload:
            self.rep.report(
                node, 'SKY105',
                f'{upload}: a synchronizing upload (the host waits for '
                'the stream) outside engine.host_fetch — upload from '
                'pinned memory with non_blocking=True, or mark it  '
                '# skytpu-allow: SKY105')

    def _check_blocking(self, node: ast.Call,
                        fn: Optional[str]) -> None:
        blocking = (fn in _BLOCKING_DOTTED
                    or (fn or '').startswith(_BLOCKING_DOTTED_PREFIXES))
        if blocking:
            self.rep.report(
                node, 'SKY201',
                f'{fn}() blocks the event loop inside an async handler '
                '— await an async client, or run_in_executor/to_thread')

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self.rep.report(node, 'SKY301',
                            "bare 'except:' swallows KeyboardInterrupt/"
                            'SystemExit — catch a concrete exception')
        elif self.is_recovery and all(
                isinstance(stmt, (ast.Pass, ast.Continue))
                for stmt in node.body):
            self.rep.report(
                node, 'SKY302',
                'recovery-path except handler swallows the error '
                'silently — log it or re-raise')
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _allow_map(source: str) -> Dict[int, Set[str]]:
    """lineno -> codes allowed by a `# skytpu-allow: ...` comment.

    Only real COMMENT tokens count — a docstring or string literal that
    merely mentions the marker is neither a suppression nor (SKY601) a
    stale one.  Falls back to a per-line text scan if the file does not
    tokenize (it will be reported as SKY000 anyway).
    """
    marker = 'skytpu-allow:'
    allow: Dict[int, Set[str]] = {}

    def add(lineno: int, comment: str) -> None:
        pos = comment.find(marker)
        if pos < 0:
            return
        codes = {c.strip() for c in
                 comment[pos + len(marker):].split(',') if c.strip()}
        if codes:
            allow[lineno] = codes

    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                add(tok.start[0], tok.string)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for i, line in enumerate(source.splitlines(), start=1):
            pos = line.find(marker)
            if pos >= 0 and '#' in line[:pos]:
                add(i, line[line.index('#'):])
    return allow


def lint_source(source: str, path: str = '<string>') -> List[Violation]:
    """One module alone: the module-wide rules, and SKY101-104 over the
    functions and blocks the module itself hands to a capture (no call
    edges followed)."""
    path = path.replace(os.sep, '/')
    lines = source.splitlines()
    allow = _allow_map(source)
    rep = _Reporter(path, lines, allow)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        rep.violations.append(Violation(
            path, e.lineno or 0, e.offset or 0, 'SKY000',
            f'file does not parse: {e.msg}', ''))
        return rep.violations

    collector = _CapturedCollector()
    collector.visit(tree)
    for fn_node in collector.resolve():
        _walk_captured(fn_node, rep, set())
    for block, params in collector.blocks:
        _walk_captured(block, rep, params)
    _ModuleRuleVisitor(rep, path).visit(tree)
    rep.violations.sort(key=lambda v: (v.line, v.col, v.code))
    return rep.violations


def lint_file(path: str, root: Optional[str] = None) -> List[Violation]:
    rel = os.path.relpath(path, root) if root else path
    with open(path, 'r', encoding='utf-8') as f:
        return lint_source(f.read(), rel)


# ---------------------------------------------------------------------------
# Whole-program pipeline (call-graph based)
# ---------------------------------------------------------------------------


def _capture_blocks(fn):
    """The ``with torch.cuda.graph(...)`` statements in fn's own body."""
    from skypilot_tpu_torch.analysis import graph as graph_lib
    return [n for n in graph_lib._iter_body_nodes(fn)
            if _is_cuda_graph_with(n)]


def _block_callees(graph, fn, block) -> Set[str]:
    """Functions called from inside a capture block (not nested defs)."""
    out: Set[str] = set()
    stack = list(block.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            out.update(graph.resolve_callable(fn, node.func))
        stack.extend(ast.iter_child_nodes(node))
    return out


def _collect_captured_fids(graph) -> Tuple[Set[str], Set[str]]:
    """Captured functions as ``(direct, indirect)`` fid sets: *direct*
    ones are handed to a capture (run_chunk/ChunkGraphs.run body) and
    get the full SKY101-104 walk; *indirect* ones are only reached
    through call edges (from a direct one or from a ``with
    torch.cuda.graph`` block) and get the reduced rule set.

    A resolvable body reference marks only the resolved definition;
    unresolvable ones fall back to name-based marking within the
    module, so resolution can only improve precision, never lose
    coverage.
    """
    from skypilot_tpu_torch.analysis import graph as graph_lib

    by_name: Dict[str, Dict[str, List[str]]] = {}
    for fid, fn in graph.funcs.items():
        if isinstance(fn.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(fn.path, {}).setdefault(
                fn.name, []).append(fid)

    roots: Set[str] = set()
    block_seeds: Set[str] = set()

    def mark(fn, expr: ast.AST) -> None:
        targets = graph.resolve_callable(fn, expr)
        if targets:
            roots.update(targets)
            return
        names, nodes = _callable_targets(expr)
        for name in names:
            roots.update(by_name.get(fn.path, {}).get(name, []))
        for node in nodes:
            for child_fid in fn.children:
                if graph.funcs[child_fid].node is node:
                    roots.add(child_fid)

    for fid in sorted(graph.funcs):
        fn = graph.funcs[fid]
        for node in graph_lib._iter_body_nodes(fn):
            if isinstance(node, ast.Call):
                body = _capture_body_arg(node)
                if body is not None:
                    mark(fn, body)
            elif _is_cuda_graph_with(node):
                block_seeds.update(_block_callees(graph, fn, node))

    # Direct set: the roots plus everything lexically nested in them.
    direct = set(roots)
    frontier = list(roots)
    while frontier:
        fid = frontier.pop()
        for child in graph.funcs[fid].children:
            if child not in direct:
                direct.add(child)
                frontier.append(child)
    # Indirect set: everything else a captured function calls runs
    # under the same capture, but which of its parameters carry tensors
    # is not known (static config args are routine), so these bodies
    # get the reduced rule set only.
    seen = set(direct)
    frontier = list(direct)
    for fid in block_seeds:
        if fid not in seen and fid in graph.funcs:
            seen.add(fid)
            frontier.append(fid)
    while frontier:
        fid = frontier.pop()
        fn = graph.funcs[fid]
        for nxt in list(graph.call_edges.get(fid, ())) + fn.children:
            if nxt not in seen and nxt in graph.funcs:
                seen.add(nxt)
                frontier.append(nxt)
    return direct, seen - direct


def _top_captured(graph, captured: Set[str]) -> List[str]:
    """Captured fids with no captured lexical ancestor (the walk
    recurses into nested defs itself)."""
    out: List[str] = []
    for fid in captured:
        fn = graph.funcs[fid]
        parent = fn.parent
        is_top = True
        while parent is not None:
            if parent in captured:
                is_top = False
                break
            parent = graph.funcs[parent].parent
        if is_top:
            out.append(fid)
    return sorted(out)


def _walk_captured_indirect(fn, rep: _Reporter) -> None:
    """Reduced in-capture rules for functions only reached via call
    edges.

    The body runs under the capture, but which parameters carry tensors
    is not known for sure: helpers routinely take static config
    (dtypes, flags, meshes, ``n``) that is deliberately branched on and
    int()-ed.  So: no SKY102, and int()/float()/bool() only of an
    operand that reads a positional tensor parameter's values
    (``int(token[0])``) or calls a tensor-valued method; every other
    SKY101-104 call is wrong in captured code whatever its operand.
    """
    from skypilot_tpu_torch.analysis import graph as graph_lib

    args = getattr(fn.node, 'args', None)
    tracked = (_static_params(args) if isinstance(args, ast.arguments)
               else set())
    for node in graph_lib._iter_body_nodes(fn):
        if isinstance(node, ast.Call):
            _check_captured_call(node, rep, tracked, direct=False)


def lint_sources(sources: Dict[str, str],
                 allowed: Optional[List[Violation]] = None
                 ) -> List[Violation]:
    """Whole-program lint over ``{relative_path: source}``.

    Runs the per-module rules, the call-graph-based captured-function
    rules (SKY101-104), the SKY5xx concurrency/lifecycle rules, and the
    SKY601 unused-suppression check.  `allowed`, a list, receives the
    violations that allow-markers suppressed.
    """
    from skypilot_tpu_torch.analysis import concurrency
    from skypilot_tpu_torch.analysis import graph as graph_lib

    reporters: Dict[str, _Reporter] = {}
    parsed: Dict[str, str] = {}
    for path in sorted(sources):
        norm = path.replace(os.sep, '/')
        source = sources[path]
        rep = _Reporter(norm, source.splitlines(), _allow_map(source))
        reporters[norm] = rep
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            rep.violations.append(Violation(
                norm, e.lineno or 0, e.offset or 0, 'SKY000',
                f'file does not parse: {e.msg}', ''))
            continue
        parsed[norm] = source
        _ModuleRuleVisitor(rep, norm).visit(tree)

    graph = graph_lib.build_graph(parsed)
    direct, indirect = _collect_captured_fids(graph)
    for fid in _top_captured(graph, direct):
        fn = graph.funcs[fid]
        _walk_captured(fn.node, reporters[fn.path], set())
    for fid in sorted(indirect):
        fn = graph.funcs[fid]
        _walk_captured_indirect(fn, reporters[fn.path])
    for fid in sorted(graph.funcs):
        fn = graph.funcs[fid]
        args = getattr(fn.node, 'args', None)
        params = (_static_params(args) if isinstance(args, ast.arguments)
                  else set())
        for block in _capture_blocks(fn):
            _walk_captured(block, reporters[fn.path], params)

    def route(path: str, node: ast.AST, code: str, message: str) -> None:
        rep = reporters.get(path)
        if rep is not None:
            rep.report(node, code, message)

    concurrency.check(graph, route)

    for path in sorted(reporters):
        rep = reporters[path]
        for line in sorted(rep._allow):
            if line in rep.used_allow_lines:
                continue
            codes = ','.join(sorted(rep._allow[line]))
            text = (rep._lines[line - 1].strip()
                    if 0 < line <= len(rep._lines) else '')
            rep.violations.append(Violation(
                path, line, 0, 'SKY601',
                f'suppression for {codes} no longer matches any '
                f'violation on this line — delete the stale '
                f'skytpu-allow marker', text))

    out: List[Violation] = []
    for path in sorted(reporters):
        violations = reporters[path].violations
        violations.sort(key=lambda v: (v.line, v.col, v.code))
        out.extend(violations)
        if allowed is not None:
            allowed.extend(sorted(reporters[path].allowed,
                                  key=lambda v: (v.line, v.col, v.code)))
    return out


def lint_paths(paths: Iterable[str], root: Optional[str] = None,
               allowed: Optional[List[Violation]] = None
               ) -> List[Violation]:
    """Lint every .py file under the given files/directories with the
    whole-program pipeline (`allowed`: as lint_sources')."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ('__pycache__', '.git', 'build',
                                 'node_modules'))
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith('.py'))
        elif p.endswith('.py'):
            files.append(p)
    sources: Dict[str, str] = {}
    for f in files:
        rel = (os.path.relpath(f, root) if root else f).replace(os.sep, '/')
        if rel in sources:
            continue
        with open(f, 'r', encoding='utf-8') as handle:
            sources[rel] = handle.read()
    return lint_sources(sources, allowed)
