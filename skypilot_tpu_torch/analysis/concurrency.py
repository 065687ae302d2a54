"""SKY5xx: concurrency & resource-lifecycle rules over the call graph.

These are the cross-module hazards the per-module linter cannot see (the
port runs the kv-tier copy thread, the checkpoint writer, the replica
loop and the fleet simulator's replicas):

* SKY501 — an attribute written from thread-plane code (reachable from a
  ``Thread(target=...)`` / ``submit`` entry) and read or written from
  main-plane code with no lock held in common at every site.
* SKY502 — lock-order cycle: lock B acquired while A is held in one
  function, A while B in another (classic ABBA deadlock).
* SKY503 — un-joined / un-closed thread or resource: a class stores a
  started thread (or an object of a thread-owning class) and no method
  of the class ever joins/closes it; also fire-and-forget local threads.
* SKY504 — blocking call (``queue.get``/``.join()``/``.acquire()``/
  ``.wait()`` without timeout, ``time.sleep``) reachable from the
  serving hot path (``ContinuousBatcher.step``).

The analysis is intentionally one-sided: writes in ``__init__`` happen
before any thread is started (happens-before via ``Thread.start``), and
attributes holding synchronization primitives or internally-locked
containers (queues, deques) are exempt from SKY501.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple

from skypilot_tpu_torch.analysis import graph as graph_lib

#: (path suffix, class name, method) roots for the SKY504 hot-path scan.
HOT_PATH_ROOTS: Sequence[Tuple[str, str, str]] = (
    ('infer/serving.py', 'ContinuousBatcher', 'step'),
)

#: Method calls on a ``self`` attribute that mutate it (count as writes).
_MUTATORS = frozenset({
    'append', 'appendleft', 'extend', 'insert', 'remove', 'discard',
    'pop', 'popleft', 'popitem', 'clear', 'add', 'update', 'setdefault',
    '__setitem__', 'sort', 'reverse',
})

#: Constructor writes happen before any thread starts.
_INIT_METHODS = frozenset({'__init__', '__post_init__', '__new__'})

#: Method names that count as releasing/joining a held thread/resource.
_THREAD_CLOSERS = frozenset({'join'})
_RESOURCE_CLOSERS = frozenset(
    {'close', 'stop', 'shutdown', 'join', 'terminate', 'terminate_all'})

LockKey = Tuple[str, ...]


def _pruned_walk(root: ast.AST):
    """Pre-order walk that does not descend into nested function bodies
    (each nested def/lambda is its own FuncNode)."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Lambda, ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            stack.append(child)


@dataclasses.dataclass
class _Access:
    attr: str
    node: ast.AST
    locks: FrozenSet[LockKey]


@dataclasses.dataclass
class _FuncFacts:
    """Everything the rules need about one function body."""
    reads: List[_Access] = dataclasses.field(default_factory=list)
    writes: List[_Access] = dataclasses.field(default_factory=list)
    #: (outer lock, inner lock, acquisition node) for nested ``with``.
    lock_pairs: List[Tuple[LockKey, LockKey, ast.AST]] = dataclasses.field(
        default_factory=list)
    #: self attrs referenced anywhere + method-call names made (SKY503).
    attr_refs: Set[str] = dataclasses.field(default_factory=set)
    call_names: Set[str] = dataclasses.field(default_factory=set)


def _lock_key(graph: graph_lib.CallGraph, fn: graph_lib.FuncNode,
              expr: ast.AST) -> Optional[LockKey]:
    """Identify a lock-valued with-item, keyed so that the same lock seen
    from different methods compares equal."""
    dotted = graph_lib._dotted(expr)
    if not dotted:
        return None
    parts = dotted.split('.')
    if parts[0] == 'self' and len(parts) == 2 and fn.cls:
        cinfo = graph.classes.get(fn.cls)
        tag = cinfo.attr_types.get(parts[1]) if cinfo else None
        if tag in graph_lib.LOCK_TYPES or (tag is None
                                           and 'lock' in parts[1].lower()):
            return ('attr', fn.cls, parts[1])
    elif len(parts) == 1:
        name = parts[0]
        tag = fn.local_types.get(name) or graph.modules[
            fn.path].global_types.get(name)
        if tag in graph_lib.LOCK_TYPES or (tag is None
                                           and 'lock' in name.lower()):
            scope = ('global', fn.path) if name in graph.modules[
                fn.path].global_types else ('local', fn.fid)
            return scope + (name,)
    return None


def _lock_tag(graph: graph_lib.CallGraph, key: LockKey) -> Optional[str]:
    if key[0] == 'attr':
        cinfo = graph.classes.get(key[1])
        return cinfo.attr_types.get(key[2]) if cinfo else None
    module = graph.modules.get(key[1])
    return module.global_types.get(key[-1]) if module else None


def _lock_label(key: LockKey, graph: graph_lib.CallGraph) -> str:
    if key[0] == 'attr':
        cinfo = graph.classes.get(key[1])
        owner = cinfo.name if cinfo else key[1]
        return f'{owner}.{key[2]}'
    return key[-1]


class _FactsWalker:
    """Collect _FuncFacts for one function body (nested defs excluded —
    they are their own FuncNodes)."""

    def __init__(self, graph: graph_lib.CallGraph,
                 fn: graph_lib.FuncNode) -> None:
        self.graph = graph
        self.fn = fn
        self.facts = _FuncFacts()
        self._held: List[LockKey] = []
        self._counted: Set[int] = set()   # Attribute node ids already
                                          # recorded as writes

    def run(self) -> _FuncFacts:
        node = self.fn.node
        if isinstance(node, ast.Lambda):
            self._walk_expr(node.body)
        elif isinstance(node, ast.Module):
            for stmt in node.body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                    self._walk_stmt(stmt)
        else:
            for stmt in node.body:
                self._walk_stmt(stmt)
        return self.facts

    # -- statement walk with held-lock tracking --------------------------

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired: List[LockKey] = []
            for item in stmt.items:
                self._walk_expr(item.context_expr)
                key = _lock_key(self.graph, self.fn, item.context_expr)
                if key is not None:
                    for outer in self._held + acquired:
                        self.facts.lock_pairs.append(
                            (outer, key, item.context_expr))
                    acquired.append(key)
            self._held.extend(acquired)
            for inner in stmt.body:
                self._walk_stmt(inner)
            if acquired:
                del self._held[-len(acquired):]
            return
        # Assignment targets first, so writes are classified before the
        # generic expression walk sees the nodes.
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for target in targets:
                self._mark_write_target(target,
                                        aug=isinstance(stmt, ast.AugAssign))
        self._walk_children(stmt)

    def _walk_children(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, ast.stmt):
                self._walk_stmt(child)
            elif isinstance(child, ast.expr):
                self._walk_expr(child)
            else:
                # excepthandler, withitem, match_case, ... — containers
                # of further statements/expressions.
                self._walk_children(child)

    def _mark_write_target(self, target: ast.expr, aug: bool = False) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._mark_write_target(elt)
            return
        if isinstance(target, ast.Starred):
            self._mark_write_target(target.value)
            return
        attr_node = None
        if isinstance(target, ast.Attribute):
            attr_node = target
        elif isinstance(target, ast.Subscript) and isinstance(
                target.value, ast.Attribute):
            attr_node = target.value
        if (attr_node is not None and isinstance(attr_node.value, ast.Name)
                and attr_node.value.id == 'self'):
            self._record(attr_node, write=True)
            if aug:
                self._record(attr_node, write=False, force=True)
            self._counted.add(id(attr_node))

    def _record(self, node: ast.Attribute, write: bool,
                force: bool = False) -> None:
        if id(node) in self._counted and not force:
            return
        access = _Access(node.attr, node, frozenset(self._held))
        (self.facts.writes if write else self.facts.reads).append(access)
        self.facts.attr_refs.add(node.attr)

    # -- expression walk -------------------------------------------------

    def _walk_expr(self, expr: ast.expr) -> None:
        for node in _pruned_walk(expr):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute):
                self.facts.call_names.add(node.func.attr)
                receiver = node.func.value
                if (node.func.attr in _MUTATORS
                        and isinstance(receiver, ast.Attribute)
                        and isinstance(receiver.value, ast.Name)
                        and receiver.value.id == 'self'):
                    self._record(receiver, write=True)
                    self._counted.add(id(receiver))
            elif isinstance(node, ast.Attribute):
                if (isinstance(node.value, ast.Name)
                        and node.value.id == 'self'):
                    cinfo = self.graph.classes.get(self.fn.cls or '')
                    if cinfo and node.attr in cinfo.methods:
                        self.facts.attr_refs.add(node.attr)
                        continue   # method reference, not shared state
                    self._record(node, write=False)


def collect_facts(graph: graph_lib.CallGraph) -> Dict[str, _FuncFacts]:
    facts: Dict[str, _FuncFacts] = {}
    for fid, fn in graph.funcs.items():
        facts[fid] = _FactsWalker(graph, fn).run()
    return facts


# -- SKY501: unsynchronized cross-thread state ----------------------------


def _init_plane(graph: graph_lib.CallGraph,
                funcs: Sequence[graph_lib.FuncNode]) -> Set[str]:
    """__init__ and everything lexically nested in it."""
    out: Set[str] = set()
    for fn in funcs:
        cursor: Optional[graph_lib.FuncNode] = fn
        while cursor is not None:
            if cursor.name in _INIT_METHODS:
                out.add(fn.fid)
                break
            cursor = (graph.funcs[cursor.parent]
                      if cursor.parent else None)
    return out


def _common_locks(sites: Sequence[_Access]) -> Set[LockKey]:
    common: Optional[Set[LockKey]] = None
    for access in sites:
        held = set(access.locks)
        common = held if common is None else (common & held)
    return common or set()


def _thread_aware_classes(graph: graph_lib.CallGraph) -> Set[str]:
    """Classes that participate in threading: they hold a thread, a lock,
    or a thread-owning resource, or one of their functions is itself a
    thread entry.  SKY501 is scoped to these — a plain value class whose
    methods merely get *called* from thread code (on thread-local
    instances) would otherwise drown the rule in instance-insensitive
    false positives."""
    owning = _thread_owning_classes(graph)
    aware: Set[str] = set()
    for key, cinfo in graph.classes.items():
        tags = list(cinfo.attr_types.values()) + list(
            cinfo.container_elems.values())
        if any(t == 'thread' or t in graph_lib.LOCK_TYPES or t in owning
               for t in tags):
            aware.add(key)
            continue
        if any(f.fid in graph.thread_entries
               for f in graph.class_functions(key)):
            aware.add(key)
    return aware


def _check_sky501(graph, facts, thread_reachable, report) -> None:
    aware = _thread_aware_classes(graph)
    for class_key in sorted(graph.classes):
        if class_key not in aware:
            continue
        cinfo = graph.classes[class_key]
        funcs = graph.class_functions(class_key)
        init_fids = _init_plane(graph, funcs)
        t_funcs = [f for f in funcs
                   if f.fid in thread_reachable and f.fid not in init_fids]
        if not t_funcs:
            continue
        m_funcs = [f for f in funcs
                   if f.fid not in thread_reachable
                   and f.fid not in init_fids]
        t_writes: Dict[str, List[Tuple[graph_lib.FuncNode, _Access]]] = {}
        for fn in t_funcs:
            for access in facts[fn.fid].writes:
                t_writes.setdefault(access.attr, []).append((fn, access))
        if not t_writes:
            continue
        m_access: Dict[str, List[Tuple[graph_lib.FuncNode, _Access]]] = {}
        for fn in m_funcs:
            for access in (facts[fn.fid].writes + facts[fn.fid].reads):
                m_access.setdefault(access.attr, []).append((fn, access))
        for attr in sorted(t_writes):
            if attr not in m_access:
                continue
            tag = cinfo.attr_types.get(attr)
            if tag in graph_lib.THREAD_SAFE_TYPES:
                continue
            t_sites = sorted(t_writes[attr], key=lambda s: s[1].node.lineno)
            m_sites = sorted(m_access[attr], key=lambda s: s[1].node.lineno)
            common = (_common_locks([s for _, s in t_sites])
                      & _common_locks([s for _, s in m_sites]))
            if common:
                continue
            t_fn, t_acc = t_sites[0]
            m_fn, m_acc = m_sites[0]
            report(cinfo.path, t_acc.node, 'SKY501',
                   f'attribute {cinfo.name}.{attr} is written on the '
                   f'thread plane ({t_fn.qual}:{t_acc.node.lineno}) and '
                   f'accessed from the main plane '
                   f'({m_fn.qual}:{m_acc.node.lineno}) with no lock held '
                   f'in common at every site')


# -- SKY502: lock-order cycles --------------------------------------------


def _check_sky502(graph, facts, report) -> None:
    edges: Dict[LockKey, Dict[LockKey, Tuple[str, ast.AST]]] = {}
    for fid in sorted(facts):
        for outer, inner, node in facts[fid].lock_pairs:
            if outer == inner:
                # Re-acquiring the same non-reentrant lock deadlocks
                # immediately; RLocks are fine.
                if _lock_tag(graph, outer) == 'lock':
                    report(graph.funcs[fid].path, node, 'SKY502',
                           f'lock {_lock_label(outer, graph)} re-acquired '
                           f'while already held (non-reentrant Lock: '
                           f'immediate self-deadlock)')
                continue
            edges.setdefault(outer, {}).setdefault(
                inner, (graph.funcs[fid].path, node))
    # DFS cycle detection over the acquired-while-held graph.
    color: Dict[LockKey, int] = {}
    stack: List[LockKey] = []
    reported: Set[FrozenSet[LockKey]] = set()

    def visit(key: LockKey) -> None:
        color[key] = 1
        stack.append(key)
        for nxt in sorted(edges.get(key, ())):
            if color.get(nxt, 0) == 1:
                cycle = stack[stack.index(nxt):] + [nxt]
                cycle_set = frozenset(cycle)
                if cycle_set not in reported:
                    reported.add(cycle_set)
                    path, node = edges[key][nxt]
                    order = ' -> '.join(
                        _lock_label(k, graph) for k in cycle)
                    report(path, node, 'SKY502',
                           f'lock-order cycle (deadlock risk): {order}')
            elif color.get(nxt, 0) == 0:
                visit(nxt)
        stack.pop()
        color[key] = 2

    for key in sorted(edges):
        if color.get(key, 0) == 0:
            visit(key)


# -- SKY503: un-joined / un-closed threads & resources --------------------


def _thread_owning_classes(graph: graph_lib.CallGraph) -> Set[str]:
    """Classes that (transitively) hold a thread-typed attribute."""
    owning: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for key, cinfo in graph.classes.items():
            if key in owning:
                continue
            tags = list(cinfo.attr_types.values()) + list(
                cinfo.container_elems.values())
            if any(t == 'thread' or t in owning for t in tags):
                owning.add(key)
                changed = True
    return owning


def _check_sky503(graph, facts, report) -> None:
    owning = _thread_owning_classes(graph)
    for class_key in sorted(graph.classes):
        cinfo = graph.classes[class_key]
        candidates: Dict[str, Tuple[str, Tuple[int, int], str]] = {}
        for attr, tag in cinfo.attr_types.items():
            if tag == 'thread':
                candidates[attr] = ('thread', cinfo.attr_sites[attr], tag)
            elif tag in owning:
                candidates[attr] = ('resource', cinfo.attr_sites[attr],
                                    graph.classes[tag].name)
        for attr, tag in cinfo.container_elems.items():
            if tag == 'thread':
                candidates.setdefault(
                    attr, ('thread', cinfo.container_sites[attr], tag))
            elif tag in owning:
                candidates.setdefault(
                    attr, ('resource', cinfo.container_sites[attr],
                           graph.classes[tag].name))
        if not candidates:
            continue
        class_facts = [facts[f.fid] for f in graph.class_functions(class_key)]
        for attr in sorted(candidates):
            kind, site, detail = candidates[attr]
            closers = (_THREAD_CLOSERS if kind == 'thread'
                       else _RESOURCE_CLOSERS)
            sanctioned = any(
                attr in f.attr_refs and (f.call_names & closers)
                for f in class_facts)
            if sanctioned:
                continue
            shim = ast.Pass()
            shim.lineno, shim.col_offset = site
            if kind == 'thread':
                message = (f'{cinfo.name}.{attr} stores a started thread '
                           f'but no method of {cinfo.name} ever joins it '
                           f'(leaked thread on shutdown)')
            else:
                message = (f'{cinfo.name}.{attr} holds a thread-owning '
                           f'{detail} but no method of {cinfo.name} ever '
                           f'closes/joins it (leaked worker on shutdown)')
            report(cinfo.path, shim, 'SKY503', message)
    _check_local_threads(graph, report)


def _check_local_threads(graph: graph_lib.CallGraph, report) -> None:
    """Fire-and-forget: a thread started in a function and neither joined,
    stored on self, appended anywhere, nor returned."""
    for fid in sorted(graph.funcs):
        fn = graph.funcs[fid]
        thread_vars = {name for name, tag in fn.local_types.items()
                       if tag == 'thread'}
        started: Dict[str, ast.AST] = {}
        sanctioned: Set[str] = set()
        for node in graph_lib._iter_body_nodes(fn):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute):
                    recv = node.func.value
                    if node.func.attr == 'start':
                        if isinstance(recv,
                                      ast.Name) and recv.id in thread_vars:
                            started.setdefault(recv.id, node)
                        elif isinstance(recv, ast.Call):
                            # Thread(...).start() — can never be joined.
                            dotted = graph_lib._dotted(recv.func)
                            resolved = (graph._resolve_value_name(fn, dotted)
                                        if dotted else None)
                            if resolved == ('sync', 'thread'):
                                report(fn.path, node, 'SKY503',
                                       'anonymous Thread(...).start() — '
                                       'the thread can never be joined')
                        continue
                    if node.func.attr == 'join' and isinstance(
                            recv, ast.Name):
                        sanctioned.add(recv.id)
                        continue
                # The thread handed to any other call (registered/stored
                # elsewhere) is someone else's to join.
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    if isinstance(arg, ast.Name):
                        sanctioned.add(arg.id)
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if not isinstance(target, ast.Name) and isinstance(
                            node.value, ast.Name):
                        sanctioned.add(node.value.id)   # stored somewhere
            elif isinstance(node, ast.Return) and isinstance(
                    node.value, ast.Name):
                sanctioned.add(node.value.id)
        for name in sorted(started):
            if name not in sanctioned:
                report(fn.path, started[name], 'SKY503',
                       f'thread {name!r} started in {fn.qual} is never '
                       f'joined, stored, or returned (fire-and-forget '
                       f'daemon leak)')


# -- SKY504: blocking calls on the serving hot path -----------------------


def _has_timeout(call: ast.Call) -> bool:
    if call.args:
        return True
    return any(kw.arg in ('timeout', 'block') or kw.arg is None
               for kw in call.keywords)


def _receiver_type(graph, fn, expr) -> Optional[str]:
    return graph.expr_type(fn, expr)


def _check_sky504(graph, report) -> None:
    roots: List[str] = []
    root_names = []
    for suffix, class_name, method in HOT_PATH_ROOTS:
        for path, module in graph.modules.items():
            if not path.endswith(suffix):
                continue
            cinfo = module.classes.get(class_name)
            if cinfo and method in cinfo.methods:
                roots.append(cinfo.methods[method])
                root_names.append(f'{class_name}.{method}')
    if not roots:
        return
    parents = graph.call_paths_from(roots)
    for fid in sorted(parents):
        fn = graph.funcs[fid]
        for node in graph_lib._iter_body_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = graph_lib._dotted(node.func)
            blocked: Optional[str] = None
            if dotted == 'time.sleep':
                blocked = 'time.sleep()'
            elif isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                recv_type = _receiver_type(graph, fn, node.func.value)
                if attr == 'get' and recv_type == 'queue' and not \
                        _has_timeout(node):
                    blocked = 'queue.get() without timeout'
                elif attr == 'join' and recv_type in ('queue', 'thread') \
                        and not _has_timeout(node):
                    blocked = (f'{recv_type}.join() without timeout')
                elif attr == 'acquire' and not _has_timeout(node):
                    recv_dotted = graph_lib._dotted(node.func.value) or ''
                    if (recv_type in graph_lib.LOCK_TYPES
                            or 'lock' in recv_dotted.lower()):
                        blocked = 'lock.acquire() without timeout'
                elif attr == 'wait' and recv_type in (
                        'event', 'condition') and not _has_timeout(node):
                    blocked = f'{recv_type}.wait() without timeout'
            if blocked:
                chain = ' -> '.join(graph.chain(parents, fid))
                report(fn.path, node, 'SKY504',
                       f'{blocked} reachable from the serving hot path '
                       f'({chain}) — a stall here blocks every in-flight '
                       f'request for the whole step')


# -- entry point ----------------------------------------------------------


def check(graph: graph_lib.CallGraph, report) -> None:
    """Run SKY501-504.  ``report(path, node, code, message)`` routes each
    finding to the right per-file reporter (allow-marks and baseline are
    applied there)."""
    facts = collect_facts(graph)
    thread_reachable = graph.reachable(graph.thread_entries,
                                       include_children=True)
    _check_sky501(graph, facts, thread_reachable, report)
    _check_sky502(graph, facts, report)
    _check_sky503(graph, facts, report)
    _check_sky504(graph, report)
