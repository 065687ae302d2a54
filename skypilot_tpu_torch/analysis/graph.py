"""Whole-program symbol table and call graph for the skypilot_tpu_torch
package (or any package named by ``package=``).

A one-module lint is enough for the per-line data-plane rules but blind
to the hazards that span modules: state shared across threads (the
kv-tier copy thread, the checkpoint writer, the replica loop), lock
ordering, resource lifecycles, and which functions a CUDA-graph capture
reaches.  This module builds the cross-module picture that the SKY5xx
rules and the linter's captured-code discovery need:

* a per-module symbol table (imports, top-level functions, classes and
  their methods);
* a ``FuncNode`` for every function, method, nested def and lambda, with
  parent/child links mirroring lexical nesting;
* *call edges* between functions, resolved through imports, ``self``
  attributes and bounded local-alias tracking;
* *thread edges*: ``threading.Thread(target=...)`` / ``Timer``,
  ``.submit(fn)`` / ``.try_submit(fn)`` and ``loop.run_in_executor`` —
  their targets become *thread entries*, the roots of the thread plane;
* bounded type tracking for ``self.x = threading.Lock()`` style
  attributes (locks, queues, events, threads, and package classes,
  including one hop through a called function's return annotation).

Everything is stdlib ``ast``; nothing here imports the modules under
analysis.  The graph is deliberately conservative: unresolved calls simply
produce no edge, so downstream rules err toward silence, not noise.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

#: The package that :func:`package_sources` reads by default.  Any other
#: package laid out the same way can be named instead (``package=``).
PACKAGE_NAME = 'skypilot_tpu_torch'

# Dotted constructor -> coarse type tag for the bounded alias analysis.
_SYNC_DOTTED = {
    'threading.Lock': 'lock',
    'threading.RLock': 'rlock',
    'threading.Condition': 'condition',
    'threading.Semaphore': 'semaphore',
    'threading.BoundedSemaphore': 'semaphore',
    'threading.Event': 'event',
    'threading.Thread': 'thread',
    'threading.Timer': 'thread',
    'queue.Queue': 'queue',
    'queue.SimpleQueue': 'queue',
    'queue.LifoQueue': 'queue',
    'queue.PriorityQueue': 'queue',
    'collections.deque': 'deque',
    'collections.OrderedDict': 'dict',
}

#: Type tags that are safe to share across threads without an extra lock
#: (they are synchronization primitives or internally locked containers).
THREAD_SAFE_TYPES = frozenset(
    {'lock', 'rlock', 'condition', 'semaphore', 'event', 'queue', 'deque'})

#: Lock-like tags (things whose ``with``/``acquire`` means mutual exclusion).
LOCK_TYPES = frozenset({'lock', 'rlock', 'condition', 'semaphore'})

# ``obj.submit(fn, ...)`` style APIs: method name -> positional index of the
# callable that will run on another thread.  Keyword callables (for example
# ``try_submit(job, on_error=unwind)`` in kv_tier) are deliberately *not*
# thread edges: by the AsyncCopyEngine contract the error callback runs on
# the scheduler thread at drain time, not on the copy thread.
_SUBMIT_CALLABLE_INDEX = {
    'submit': 0,
    'try_submit': 0,
    'run_in_executor': 1,
}


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return '.'.join(reversed(parts))
    return None


def _unwrap_partial(node: ast.AST) -> ast.AST:
    """Peel ``functools.partial(f, ...)`` down to ``f``."""
    while isinstance(node, ast.Call):
        dotted = _dotted(node.func)
        if dotted in ('functools.partial', 'partial') and node.args:
            node = node.args[0]
        else:
            break
    return node


@dataclasses.dataclass
class FuncNode:
    """One function-like scope: def, async def, lambda, or module body."""
    fid: str                 # '<path>::<qualname>'
    path: str
    qual: str                # 'Cls.method', 'func.<locals>.inner', '<module>'
    name: str                # terminal name ('method', 'inner', '<module>')
    cls: Optional[str]       # owning class key ('path::Cls') if a method or
                             # nested inside one, else None
    node: ast.AST            # FunctionDef | AsyncFunctionDef | Lambda | Module
    lineno: int
    parent: Optional[str] = None
    children: List[str] = dataclasses.field(default_factory=list)
    local_types: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def is_module_scope(self) -> bool:
        return self.name == '<module>'


@dataclasses.dataclass
class ClassInfo:
    key: str                 # '<path>::<ClassName>'
    name: str
    path: str
    node: ast.ClassDef
    bases: List[str] = dataclasses.field(default_factory=list)
    methods: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: attr name -> type tag ('lock', 'queue', 'thread', ...) or a class key.
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: attr name -> (lineno, col) of the assignment that typed it.
    attr_sites: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    #: attrs that hold containers of threads / resources, e.g.
    #: ``self._launch_threads[rid] = thread``: attr -> element type tag/key.
    container_elems: Dict[str, str] = dataclasses.field(default_factory=dict)
    container_sites: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    path: str
    dotted: str
    tree: ast.Module
    source: str
    #: local name -> fully dotted origin ('threading.Thread',
    #: 'skypilot_tpu_torch.infer.kv_tier',
    #: 'skypilot_tpu_torch.ckpt.writer.Writer').
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    functions: Dict[str, str] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    #: module-level name -> type tag (for module-global locks etc).
    global_types: Dict[str, str] = dataclasses.field(default_factory=dict)


class CallGraph:
    """The whole-program graph; build via :func:`build_graph`."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_dotted: Dict[str, ModuleInfo] = {}
        self.funcs: Dict[str, FuncNode] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.call_edges: Dict[str, Set[str]] = {}
        #: (caller fid, target fid, kind, lineno); kind in {'thread','submit'}.
        self.thread_edges: List[Tuple[str, str, str, int]] = []
        self.thread_entries: Set[str] = set()

    # -- resolution ------------------------------------------------------

    def _resolve_global(self, dotted: str):
        """Resolve a fully-qualified dotted name.

        Returns ('sync', tag) | ('class', key) | ('func', fid) |
        ('module', ModuleInfo) | None.
        """
        if dotted in _SYNC_DOTTED:
            return ('sync', _SYNC_DOTTED[dotted])
        parts = dotted.split('.')
        for cut in range(len(parts), 0, -1):
            mod = self.by_dotted.get('.'.join(parts[:cut]))
            if mod is None:
                continue
            rest = parts[cut:]
            if not rest:
                return ('module', mod)
            if rest[0] in mod.imports and rest[0] not in mod.classes \
                    and rest[0] not in mod.functions:
                # Re-export (e.g. ckpt/__init__.py pulling CheckpointManager
                # out of ckpt.manager): follow the import one hop.
                return self._resolve_global(
                    '.'.join([mod.imports[rest[0]]] + rest[1:]))
            if rest[0] in mod.classes:
                cinfo = mod.classes[rest[0]]
                if len(rest) == 1:
                    return ('class', cinfo.key)
                method = self.lookup_method(cinfo.key, rest[1])
                return ('func', method) if method else None
            if len(rest) == 1 and rest[0] in mod.functions:
                return ('func', mod.functions[rest[0]])
            return None
        return None

    def resolve_name(self, module: ModuleInfo, dotted: str):
        """Resolve a dotted name as seen from *module* scope."""
        parts = dotted.split('.')
        head = parts[0]
        if head in module.imports:
            return self._resolve_global(
                '.'.join([module.imports[head]] + parts[1:]))
        if head in module.classes:
            cinfo = module.classes[head]
            if len(parts) == 1:
                return ('class', cinfo.key)
            method = self.lookup_method(cinfo.key, parts[1])
            return ('func', method) if method else None
        if len(parts) == 1 and head in module.functions:
            return ('func', module.functions[head])
        return self._resolve_global(dotted)

    def lookup_method(self, class_key: str, name: str,
                      _depth: int = 0) -> Optional[str]:
        """Find *name* on the class or (depth-bounded) its bases."""
        if _depth > 4:
            return None
        cinfo = self.classes.get(class_key)
        if cinfo is None:
            return None
        if name in cinfo.methods:
            return cinfo.methods[name]
        module = self.modules[cinfo.path]
        for base in cinfo.bases:
            resolved = self.resolve_name(module, base)
            if resolved and resolved[0] == 'class':
                found = self.lookup_method(resolved[1], name, _depth + 1)
                if found:
                    return found
        return None

    def _local_def(self, fn: FuncNode, name: str) -> Optional[str]:
        """A def named *name* nested in *fn* or a lexical ancestor."""
        cursor: Optional[FuncNode] = fn
        while cursor is not None:
            for child_fid in cursor.children:
                if self.funcs[child_fid].name == name:
                    return child_fid
            cursor = (self.funcs[cursor.parent]
                      if cursor.parent is not None else None)
        return None

    def expr_type(self, fn: FuncNode, expr: ast.AST,
                  _depth: int = 0) -> Optional[str]:
        """Coarse type of an expression: a tag from _SYNC_DOTTED values or a
        class key.  One hop through return annotations is allowed, so
        ``self._tier = make_kv_tier(...)`` picks up ``-> Optional[KVTier]``.
        """
        if _depth > 2:
            return None
        module = self.modules[fn.path]
        if isinstance(expr, ast.Call):
            dotted = _dotted(expr.func)
            if not dotted:
                return None
            resolved = self._resolve_value_name(fn, dotted)
            if resolved is None:
                return None
            kind, value = resolved
            if kind == 'sync':
                return value
            if kind == 'class':
                return value
            if kind == 'func':
                return self._annotation_type(value, _depth)
            return None
        if isinstance(expr, ast.Attribute):
            dotted = _dotted(expr)
            if dotted and dotted.startswith('self.') and fn.cls:
                parts = dotted.split('.')
                if len(parts) == 2:
                    cinfo = self.classes.get(fn.cls)
                    if cinfo:
                        return cinfo.attr_types.get(parts[1])
            return None
        if isinstance(expr, ast.Name):
            return fn.local_types.get(expr.id) or module.global_types.get(
                expr.id)
        return None

    def _resolve_value_name(self, fn: FuncNode, dotted: str):
        """resolve_name, but also aware of self attrs and local defs."""
        module = self.modules[fn.path]
        parts = dotted.split('.')
        if parts[0] == 'self' and fn.cls and len(parts) >= 2:
            method = self.lookup_method(fn.cls, parts[1])
            if method and len(parts) == 2:
                return ('func', method)
            cinfo = self.classes.get(fn.cls)
            attr_type = cinfo.attr_types.get(parts[1]) if cinfo else None
            if attr_type and attr_type in self.classes and len(parts) == 3:
                method = self.lookup_method(attr_type, parts[2])
                return ('func', method) if method else None
            return None
        if len(parts) == 1:
            local = self._local_def(fn, parts[0])
            if local:
                return ('func', local)
        if parts[0] in fn.local_types:
            holder = fn.local_types[parts[0]]
            if holder in self.classes and len(parts) == 2:
                method = self.lookup_method(holder, parts[1])
                return ('func', method) if method else None
            if len(parts) == 1:
                return ('sync', holder) if holder in set(
                    _SYNC_DOTTED.values()) else None
            return None
        return self.resolve_name(module, dotted)

    def _annotation_type(self, fid: str, depth: int) -> Optional[str]:
        """Type from a function's return annotation (one hop)."""
        callee = self.funcs.get(fid)
        if callee is None or not isinstance(
                callee.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        ann = callee.node.returns
        if ann is None:
            return None
        # Optional[X] / 'X' / X
        if isinstance(ann, ast.Subscript):
            dotted = _dotted(ann.value)
            if dotted and dotted.split('.')[-1] == 'Optional':
                ann = ann.slice
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value
        else:
            name = _dotted(ann)
        if not name:
            return None
        resolved = self.resolve_name(self.modules[callee.path], name)
        if resolved and resolved[0] == 'class':
            return resolved[1]
        return None

    def resolve_callable(self, fn: FuncNode, expr: ast.AST) -> List[str]:
        """Resolve a callable-valued expression to function fids."""
        expr = _unwrap_partial(expr)
        if isinstance(expr, ast.Lambda):
            for child_fid in fn.children:
                if self.funcs[child_fid].node is expr:
                    return [child_fid]
            return []
        dotted = _dotted(expr)
        if not dotted:
            return []
        # super().m()
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Call) and _dotted(
                    expr.value.func) == 'super' and fn.cls:
            cinfo = self.classes.get(fn.cls)
            module = self.modules[fn.path]
            for base in (cinfo.bases if cinfo else []):
                resolved = self.resolve_name(module, base)
                if resolved and resolved[0] == 'class':
                    method = self.lookup_method(resolved[1], expr.attr)
                    if method:
                        return [method]
            return []
        resolved = self._resolve_value_name(fn, dotted)
        if resolved is None:
            return []
        kind, value = resolved
        if kind == 'func':
            return [value]
        if kind == 'class':
            init = self.lookup_method(value, '__init__')
            return [init] if init else []
        return []

    # -- queries ---------------------------------------------------------

    def reachable(self, seeds: Iterable[str],
                  include_children: bool = True) -> Set[str]:
        """Transitive closure over call edges (optionally + lexical children,
        which is right for thread-plane reachability: a closure defined in a
        thread function runs on that thread)."""
        seen: Set[str] = set()
        frontier = [fid for fid in seeds if fid in self.funcs]
        seen.update(frontier)
        while frontier:
            fid = frontier.pop()
            nxt: List[str] = list(self.call_edges.get(fid, ()))
            if include_children:
                nxt.extend(self.funcs[fid].children)
            for other in nxt:
                if other not in seen and other in self.funcs:
                    seen.add(other)
                    frontier.append(other)
        return seen

    def call_paths_from(self, seeds: Sequence[str]) -> Dict[str, str]:
        """BFS parent map over call edges only (for SKY504 chain messages)."""
        parents: Dict[str, str] = {fid: '' for fid in seeds
                                   if fid in self.funcs}
        frontier = list(parents)
        while frontier:
            fid = frontier.pop(0)
            for callee in sorted(self.call_edges.get(fid, ())):
                if callee not in parents and callee in self.funcs:
                    parents[callee] = fid
                    frontier.append(callee)
        return parents

    def chain(self, parents: Mapping[str, str], fid: str) -> List[str]:
        out = [fid]
        while parents.get(fid):
            fid = parents[fid]
            out.append(fid)
        return [self.funcs[f].qual for f in reversed(out)]

    def class_functions(self, class_key: str) -> List[FuncNode]:
        """All methods of a class plus their nested defs/lambdas."""
        cinfo = self.classes.get(class_key)
        if cinfo is None:
            return []
        out: List[FuncNode] = []
        stack = [self.funcs[fid] for fid in cinfo.methods.values()]
        while stack:
            fn = stack.pop()
            out.append(fn)
            stack.extend(self.funcs[c] for c in fn.children)
        return out

    def stats(self) -> Dict[str, int]:
        return {
            'files': len(self.modules),
            'functions': sum(1 for f in self.funcs.values()
                             if not f.is_module_scope),
            'classes': len(self.classes),
            'call_edges': sum(len(v) for v in self.call_edges.values()),
            'thread_edges': len(self.thread_edges),
            'thread_entries': len(self.thread_entries),
            'typed_attrs': sum(len(c.attr_types) + len(c.container_elems)
                               for c in self.classes.values()),
        }


# -- construction --------------------------------------------------------


def _module_dotted(path: str) -> str:
    stem = path[:-3] if path.endswith('.py') else path
    parts = stem.replace(os.sep, '/').split('/')
    if parts and parts[-1] == '__init__':
        parts = parts[:-1]
    return '.'.join(parts)


def _collect_imports(module: ModuleInfo) -> None:
    pkg_parts = module.dotted.split('.')
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split('.')[0]
                target = alias.name if alias.asname else alias.name.split(
                    '.')[0]
                module.imports[local] = target
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # Relative import: resolve against this module's package.
                base = pkg_parts[:-node.level] if len(
                    pkg_parts) >= node.level else []
                prefix = '.'.join(base + ([node.module] if node.module
                                          else []))
            else:
                prefix = node.module or ''
            for alias in node.names:
                if alias.name == '*':
                    continue
                local = alias.asname or alias.name
                module.imports[local] = (f'{prefix}.{alias.name}'
                                         if prefix else alias.name)


class _ScopeWalker(ast.NodeVisitor):
    """First pass: create FuncNodes/ClassInfos for one module."""

    def __init__(self, graph: CallGraph, module: ModuleInfo) -> None:
        self.graph = graph
        self.module = module
        self.scope: List[str] = []            # qualname parts
        self.fn_stack: List[FuncNode] = []
        self.cls_stack: List[ClassInfo] = []
        root = FuncNode(fid=f'{module.path}::<module>', path=module.path,
                        qual='<module>', name='<module>', cls=None,
                        node=module.tree, lineno=0)
        graph.funcs[root.fid] = root
        self.fn_stack.append(root)

    def _add_func(self, node, name: str) -> FuncNode:
        parent = self.fn_stack[-1]
        in_func = not parent.is_module_scope
        qual = ('.'.join(self.scope + [name]) if self.scope else name)
        fid = f'{self.module.path}::{qual}'
        if fid in self.graph.funcs:        # same-name redefinitions
            fid = f'{fid}@{node.lineno}'
        fn = FuncNode(fid=fid, path=self.module.path, qual=qual, name=name,
                      cls=(self.cls_stack[-1].key if self.cls_stack
                           else None),
                      node=node, lineno=node.lineno,
                      parent=parent.fid if in_func else None)
        self.graph.funcs[fid] = fn
        if in_func:
            parent.children.append(fid)
        if self.cls_stack and not in_func:
            self.cls_stack[-1].methods.setdefault(name, fid)
        elif not in_func and not self.cls_stack:
            self.module.functions.setdefault(name, fid)
        return fn

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._walk_func(node, node.name)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._walk_func(node, node.name)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._walk_func(node, f'<lambda:{node.lineno}>')

    def _walk_func(self, node, name: str) -> None:
        fn = self._add_func(node, name)
        self.scope.append(name)
        self.fn_stack.append(fn)
        self.generic_visit(node)
        self.fn_stack.pop()
        self.scope.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        key = f'{self.module.path}::{node.name}'
        cinfo = ClassInfo(key=key, name=node.name, path=self.module.path,
                          node=node,
                          bases=[d for d in (_dotted(b) for b in node.bases)
                                 if d])
        if not self.fn_stack[-1].is_module_scope or self.cls_stack:
            # Nested classes: register but scoped by qualname to stay unique.
            key = f'{self.module.path}::{".".join(self.scope + [node.name])}'
            cinfo.key = key
        self.graph.classes[cinfo.key] = cinfo
        self.module.classes.setdefault(node.name, cinfo)
        self.scope.append(node.name)
        self.cls_stack.append(cinfo)
        self.generic_visit(node)
        self.cls_stack.pop()
        self.scope.pop()


def _iter_body_nodes(fn: FuncNode):
    """Walk a function's own statements, not nested function bodies."""
    if isinstance(fn.node, ast.Lambda):
        roots = [fn.node.body]
    elif isinstance(fn.node, ast.Module):
        roots = [n for n in fn.node.body
                 if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                       ast.ClassDef))]
    else:
        roots = list(fn.node.body)
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)


def _assign_pairs(node: ast.AST):
    """(target, value) for Assign and value-bearing AnnAssign nodes."""
    if isinstance(node, ast.Assign):
        for target in node.targets:
            yield target, node.value
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        yield node.target, node.value


def _infer_local_types(graph: CallGraph, fn: FuncNode) -> None:
    for node in _iter_body_nodes(fn):
        pairs = list(_assign_pairs(node))
        if len(pairs) != 1:
            continue
        target, value = pairs[0]
        if not isinstance(target, ast.Name):
            continue
        inferred = graph.expr_type(fn, value)
        if inferred:
            fn.local_types.setdefault(target.id, inferred)
            if fn.is_module_scope:
                graph.modules[fn.path].global_types.setdefault(
                    target.id, inferred)


def _infer_attr_types(graph: CallGraph) -> None:
    """Populate ClassInfo.attr_types from ``self.x = ...`` assignments."""
    for cinfo in graph.classes.values():
        for fn in graph.class_functions(cinfo.key):
            for node in _iter_body_nodes(fn):
                if isinstance(node, ast.Call):
                    # self._threads.append(thread): container of threads.
                    if (isinstance(node.func, ast.Attribute)
                            and node.func.attr in ('append', 'add')
                            and isinstance(node.func.value, ast.Attribute)
                            and isinstance(node.func.value.value, ast.Name)
                            and node.func.value.value.id == 'self'
                            and node.args):
                        inferred = graph.expr_type(fn, node.args[0])
                        if inferred:
                            attr = node.func.value.attr
                            cinfo.container_elems.setdefault(attr, inferred)
                            cinfo.container_sites.setdefault(
                                attr, (node.lineno, node.col_offset))
                    continue
                for target, value in _assign_pairs(node):
                    if (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == 'self'):
                        inferred = graph.expr_type(fn, value)
                        if inferred:
                            cinfo.attr_types.setdefault(target.attr, inferred)
                            cinfo.attr_sites.setdefault(
                                target.attr, (node.lineno, node.col_offset))
                    elif (isinstance(target, ast.Subscript)
                          and isinstance(target.value, ast.Attribute)
                          and isinstance(target.value.value, ast.Name)
                          and target.value.value.id == 'self'):
                        # self._threads[key] = <thread or resource>
                        inferred = graph.expr_type(fn, value)
                        if inferred:
                            attr = target.value.attr
                            cinfo.container_elems.setdefault(attr, inferred)
                            cinfo.container_sites.setdefault(
                                attr, (node.lineno, node.col_offset))


def _collect_edges(graph: CallGraph, fn: FuncNode) -> None:
    edges = graph.call_edges.setdefault(fn.fid, set())
    for node in _iter_body_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        # Thread construction: the target callable is a thread entry.
        ctor_type = None
        if dotted:
            resolved = graph._resolve_value_name(fn, dotted)
            if resolved and resolved[0] == 'sync':
                ctor_type = resolved[1]
        if ctor_type == 'thread':
            target_expr = None
            for kw in node.keywords:
                if kw.arg == 'target':
                    target_expr = kw.value
            if target_expr is None and dotted and dotted.endswith('Timer'):
                if len(node.args) >= 2:
                    target_expr = node.args[1]
            elif target_expr is None and node.args:
                target_expr = node.args[0]
            if target_expr is not None:
                for fid in graph.resolve_callable(fn, target_expr):
                    graph.thread_edges.append(
                        (fn.fid, fid, 'thread', node.lineno))
                    graph.thread_entries.add(fid)
            continue
        # submit-style dispatch: positional callable only (see module note).
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _SUBMIT_CALLABLE_INDEX):
            idx = _SUBMIT_CALLABLE_INDEX[node.func.attr]
            if len(node.args) > idx:
                for fid in graph.resolve_callable(fn, node.args[idx]):
                    graph.thread_edges.append(
                        (fn.fid, fid, 'submit', node.lineno))
                    graph.thread_entries.add(fid)
        # Plain call edge.
        for fid in graph.resolve_callable(fn, node.func):
            edges.add(fid)


def build_graph(sources: Mapping[str, str]) -> CallGraph:
    """Build the whole-program graph from ``{relative_path: source}``."""
    graph = CallGraph()
    for path in sorted(sources):
        source = sources[path]
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        module = ModuleInfo(path=path, dotted=_module_dotted(path),
                            tree=tree, source=source)
        _collect_imports(module)
        graph.modules[path] = module
        graph.by_dotted[module.dotted] = module
        _ScopeWalker(graph, module).visit(tree)
    # Two type passes: the first types straightforward constructor
    # assignments; the second lets one-hop return annotations and
    # attr-through-attr lookups see those results.
    for _ in range(2):
        for fn in graph.funcs.values():
            _infer_local_types(graph, fn)
        _infer_attr_types(graph)
    for fn in list(graph.funcs.values()):
        _collect_edges(graph, fn)
    return graph


def package_sources(root: Optional[str] = None,
                    package: str = PACKAGE_NAME) -> Dict[str, str]:
    """``{relative_path: source}`` for every .py under the package
    ``root/package`` (root: the directory that holds this package; a
    root that is itself the package directory is taken as such)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    package_dir = os.path.join(root, package)
    if not os.path.isdir(package_dir):
        package_dir = root
        root = os.path.dirname(root)
    sources: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ('__pycache__', '.git'))
        for filename in sorted(filenames):
            if not filename.endswith('.py'):
                continue
            full = os.path.join(dirpath, filename)
            rel = os.path.relpath(full, root).replace(os.sep, '/')
            with open(full, 'r', encoding='utf-8') as handle:
                sources[rel] = handle.read()
    return sources


def build_package_graph(root: Optional[str] = None,
                        package: str = PACKAGE_NAME) -> CallGraph:
    return build_graph(package_sources(root, package))
