"""Runtime audit of the port's compile discipline: run the hot-path entry
points once and hold them to the budgets the serving rate rests on.

Counterpart of skypilot_tpu/analysis/audit.py, with its entry names,
report shape (``_check``: name, status ``ok``/``fail``/``skip``,
detail), ``REGISTRY`` order, ``run_audit`` and ``quick_summary``.  The
reference traces jaxprs and lowers HLO; the port has neither, and each
check has this analog:

- **compile budget** -> graph keys.  The reference counts the programs
  jit compiled (``_cache_size()``) per static-argument set; the port
  replays each chunk from a CUDA graph captured once per static key
  (``infer/engine.py``'s ``ChunkGraphs``), so it counts the keys:
  ``('decode', n, all_greedy, nucleus)`` on the pooled plane (led by the
  cache length on a legacy one), ``('verify', all_greedy, nucleus)``,
  the fused step's tail (a decode key run inside the batcher's 'fused'
  phase), and ``('decode', n)`` / ``('verify',)`` on the Generator.
  :func:`watch` puts a :class:`KeyLog` in an engine's ``graphs``: on a
  card it wraps the engine's own ChunkGraphs, elsewhere (no graphs) it
  is a stand-in that runs each chunk eagerly and records its key; every
  budget's detail says which counted.  Prefill runs eagerly in the
  port: its budget counts the prompt-bucket shapes it ran at.  The host
  tier's copies count the id-vector lengths they ran at
  (``KVTier.copy_shapes``).
- **no callbacks** -> no host read of a device value inside a chunk.
  One ``TorchDispatchMode`` (:func:`checked`) over a chunk's body is the
  port's ``jax.make_jaxpr``: it taints the engine's state tensors
  (arena, rows, tables, parameters, draft) and every op output computed
  from a tainted input, and flags ``aten._local_scalar_dense`` on a
  tainted tensor (what ``int()``, ``bool()`` and ``.item()`` dispatch),
  and a cuda-to-cpu ``_to_copy``/``copy_`` of one.  The taint keeps a
  host constant's ``.item()`` (the optimizer's ``_in_dtype``) from
  counting.  On a card the decode and verify chunks also run under
  ``torch.cuda.set_sync_debug_mode('error')``, after the engine has run
  them once (first uses stay outside).
- **no f64** -> no op output or input of dtype float64.
- **donation** -> the arena updated in place: the arena and rows keep
  their ``data_ptr`` across the chunk, and no op inside it produces a
  tensor of the arena's element count that does not alias the arena (a
  shadow copy, what a dropped donation costs).  The train step's params
  keep their addresses (``p.copy_``); Adam's moments are rebound leaf by
  leaf, so the step fails only when its peak extra bytes reach a second
  copy of the whole state.
- **collectives** (mesh_decode) -> the c10d ops the dispatch mode sees.
  The port's combine is an ``all_gather_into_tensor`` of the partial's
  bytes and a local rank-order sum (parallel/collectives.py), so a
  gather whose rows are added together is an all-reduce; the budget
  counts those per layer.  The reference's HLO parse
  (``_hlo_computation_bodies``) has no analog and is dropped.
- **output shardings** -> the mesh's axes when an engine has one, else
  ``skip``.

Every entry takes ``device=`` (the card by default; the tests pass
'cpu') and ``cfg=``.  The default config is the reference's tiny one on
the CPU (d_model 64, 4 heads: head_dim 16), so its counts compare with
the JAX engines', and LLAMA_DEBUG's widths at the same depth and
buckets on a card, whose decode kernels take head_dim 64, 128 or 256.
"""
from __future__ import annotations

import contextlib
import dataclasses
import tempfile
import types
import weakref
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from skypilot_tpu_torch.device import resolve_device


def _check(name: str, status: str, detail: str) -> Dict[str, str]:
    assert status in ('ok', 'fail', 'skip')
    return {'name': name, 'status': status, 'detail': detail}


# ---------------------------------------------------------------------------
# The shared checker: a dispatch mode over one chunk's body
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# Ops that move a gather's rows without computing on them (a view keeps
# the gather's storage and needs no entry).
_MOVES = frozenset({_aten.index.Tensor, _aten.index_select.default,
                    _aten.clone.default, _aten._to_copy.default,
                    _aten._unsafe_view.default, _aten.copy_.default})


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None


class Trace:
    """What one :func:`checked` region saw."""

    def __init__(self, sources: Sequence[torch.Tensor],
                 arena: Optional[Dict[str, torch.Tensor]],
                 hold: Sequence[torch.Tensor], track_bytes: bool):
        self.host_reads: List[str] = []
        self.f64: List[str] = []
        self.shadows: List[str] = []
        self.moved: List[str] = []
        self.collectives: List[Dict[str, Any]] = []
        self.ops = 0
        self._taint: Dict[int, weakref.ref] = {}
        self._track = track_bytes
        self._live: Dict[int, List[int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        # Storages of the sources still alive (a dead source's address
        # may come back as a fresh tensor's), held by no reference here.
        self._source_storages: Dict[int, int] = {}
        # Detached by finish(): the registry must not keep the region's
        # record (and through it any tensor) alive.
        self._finalizers: List[weakref.finalize] = []
        for t in sources:
            self._mark(t)
            ptr = _storage(t)
            if ptr is None:
                continue
            self._source_storages[ptr] = self._source_storages.get(ptr, 0) + 1
            self._finalizers.append(weakref.finalize(
                t, self._source_died, ptr, t.untyped_storage().nbytes()))
        self._arena = dict(arena or {})
        self._arena_numel = {t.numel() for t in self._arena.values()}
        self._arena_storages = {_storage(t) for t in self._arena.values()}
        self._hold = [(name, t, t.data_ptr()) for name, t in
                      [(f'arena[{k!r}]', t) for k, t in self._arena.items()]
                      + [(f'hold[{i}]', t) for i, t in enumerate(hold)]]
        # Storages of collective outputs -> their record (kept alive for
        # the region, so no later tensor reuses the address).
        self._gathered: Dict[int, Dict[str, Any]] = {}
        self._open = True

    # -- taint ---------------------------------------------------------
    def _mark(self, t: torch.Tensor) -> None:
        key = id(t)
        ref = self._taint.get(key)
        if ref is not None and ref() is t:
            return
        self._taint[key] = weakref.ref(t, lambda r, k=key: self._forget(k, r))

    def _forget(self, key: int, ref) -> None:
        if self._taint.get(key) is ref:
            del self._taint[key]

    def _source_died(self, ptr: int, nbytes: int) -> None:
        left = self._source_storages.get(ptr, 0) - 1
        if left > 0:
            self._source_storages[ptr] = left
            return
        self._source_storages.pop(ptr, None)
        if self._track and self._open:
            # State the region replaced (a rebound moment): its bytes
            # come off the region's extra.
            self.live_bytes -= nbytes

    def tainted(self, t: torch.Tensor) -> bool:
        ref = self._taint.get(id(t))
        if ref is not None and ref() is t:
            return True
        return _storage(t) in self._source_storages

    # -- live bytes (CPU estimate of a region's peak) ----------------------
    def _drop(self, ptr: int) -> None:
        entry = self._live.get(ptr)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self.live_bytes -= entry[0]
            del self._live[ptr]

    def _count(self, out: torch.Tensor, inputs_ptrs) -> None:
        ptr = _storage(out)
        if ptr is None:
            return
        if ptr not in self._live:
            if ptr in inputs_ptrs:
                return
            nbytes = out.untyped_storage().nbytes()
            self._live[ptr] = [nbytes, 0]
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._live[ptr][1] += 1
        self._finalizers.append(weakref.finalize(out, self._drop, ptr))

    # -- the dispatch hook ---------------------------------------------
    def before(self, func, args, kwargs) -> bool:
        """Checks on an op's inputs, made before it runs (under
        sync_debug a host read raises inside the op); returns whether an
        input is tainted."""
        self.ops += 1
        ins = _tensors((args, kwargs))
        hot = any(self.tainted(t) for t in ins)
        name = str(func)
        if func is _aten._local_scalar_dense.default and hot:
            self.host_reads.append(name)
        elif func is _aten._to_copy.default and hot and ins \
                and ins[0].device.type == 'cuda' \
                and str(kwargs.get('device', 'cuda')).startswith('cpu'):
            self.host_reads.append(f'{name} cuda->cpu')
        elif func is _aten.copy_.default and len(ins) > 1 \
                and ins[0].device.type == 'cpu' \
                and ins[1].device.type == 'cuda' and self.tainted(ins[1]):
            self.host_reads.append(f'{name} cuda->cpu')
        return hot

    def see(self, func, args, kwargs, out, hot: bool) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = str(func)
        for t in ins + outs:
            if t.dtype == torch.float64:  # the check; skytpu-allow: SKY106
                self.f64.append(name)
                break
        if getattr(func, 'namespace', None) == 'c10d':
            self._collective(func, args)
        in_ptrs = {_storage(t) for t in ins}
        gathers = {id(self._gathered[p]): self._gathered[p]
                   for p in in_ptrs if p in self._gathered}
        if len(gathers) == 1:
            (rec,) = gathers.values()
            if func in (_aten.add.Tensor, _aten.add_.Tensor) and sum(
                    _storage(t) in self._gathered
                    for t in ins) >= 2:
                # Two rows of one gather added: the port's all-reduce
                # (rank_order_sum over a gather's rows).
                rec['summed'] = True
                rec['elements'] = ins[-1].numel()
            elif func in _MOVES:
                # The gathered rows reordered or copied, not computed on.
                for t in outs:
                    p = _storage(t)
                    if p is not None and p not in self._gathered:
                        self._gathered[p] = rec
        for t in outs:
            if hot:
                self._mark(t)
            if self._arena and t.numel() in self._arena_numel and \
                    _storage(t) not in self._arena_storages:
                self.shadows.append(f'{name} -> {tuple(t.shape)}')
            if self._track:
                self._count(t, in_ptrs)

    def _collective(self, func, args) -> None:
        op = func._schema.name.split('::')[-1]
        rec: Dict[str, Any] = {'op': op, 'summed': False, 'elements': None}
        if 'allgather' in op or 'all_gather' in op:
            outs = _tensors(args[0])
            rec.update(kind='all_gather', keep=outs,
                       bytes=sum(t.numel() * t.element_size() for t in outs))
            for t in outs:
                self._gathered[_storage(t)] = rec
        elif 'allreduce' in op or 'all_reduce' in op:
            ts = _tensors(args[0])
            rec.update(kind='all_reduce', summed=True,
                       elements=sum(t.numel() for t in ts),
                       bytes=sum(t.numel() * t.element_size() for t in ts))
        else:
            ts = _tensors(args)
            rec.update(kind=op, bytes=sum(t.numel() * t.element_size()
                                          for t in ts))
        self.collectives.append(rec)

    def finish(self) -> None:
        """Close the region: read the held addresses, keep the findings
        and let go of every tensor it referenced."""
        self._open = False
        for name, t, ptr in self._hold:
            if t.data_ptr() != ptr:
                self.moved.append(name)
        for rec in self.collectives:
            rec.pop('keep', None)
        for f in self._finalizers:
            f.detach()
        for held in (self._finalizers, self._hold, self._arena,
                     self._gathered, self._taint, self._live):
            held.clear()


class _Watch(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        hot = self.trace.before(func, args, kwargs)
        out = func(*args, **kwargs)
        self.trace.see(func, args, kwargs, out, hot)
        return out


class checked:
    """``with checked(sources, ...) as trace:`` runs the body under the
    checker and gives its :class:`Trace`.  sources: the state tensors
    whose values must not reach the host (not kept alive: a rebound
    moment may die inside); arena: the cache whose addresses must hold
    and which must not be shadowed; hold: more tensors whose addresses
    must hold; sync_debug (a card): any synchronizing CUDA call raises,
    and is recorded as a host read; track_bytes: estimate the region's
    peak extra bytes (new storage live at once, less the sources freed)
    in ``Trace.peak_bytes``."""

    def __init__(self, sources: Sequence[torch.Tensor], *,
                 arena: Optional[Dict[str, torch.Tensor]] = None,
                 hold: Sequence[torch.Tensor] = (), sync_debug: bool = False,
                 track_bytes: bool = False):
        self.trace = Trace(sources, arena, hold, track_bytes)
        self._sync = sync_debug
        self._prev = None
        self._mode = _Watch(self.trace)

    def __enter__(self) -> Trace:
        if self._sync:
            self._prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode('error')
        self._mode.__enter__()
        return self.trace

    def __exit__(self, kind, err, tb) -> bool:
        self._mode.__exit__(kind, err, tb)
        if self._sync:
            torch.cuda.set_sync_debug_mode(self._prev)
        self.trace.finish()
        if self._sync and kind is not None and \
                issubclass(kind, RuntimeError) and 'synchroniz' in str(err):
            self.trace.host_reads.append(
                f'a synchronizing CUDA call under sync_debug_mode error: '
                f'{err}')
            return True
        return False


def _graph_checks(trace: Trace, where: str = '') -> List[Dict[str, str]]:
    """The two per-region budgets: no host read, no f64."""
    pre = f'{where}: ' if where else ''
    reads = sorted(set(trace.host_reads))
    f64 = sorted(set(trace.f64))
    return [
        _check('no_callbacks', 'fail' if reads else 'ok',
               f'{pre}host reads of device values inside the region: '
               f'{reads[:5]}' if reads else
               f'{pre}no host read of a device value in {trace.ops} ops'),
        _check('no_f64', 'fail' if f64 else 'ok',
               f'{pre}float64 values inside the region: {f64[:5]}'
               if f64 else f'{pre}no f64 in {trace.ops} ops'),
    ]


def _donation_check(trace: Trace, what: str) -> Dict[str, str]:
    bad = trace.moved or trace.shadows
    return _check(
        'donation', 'fail' if bad else 'ok',
        f'{what} updated in place (addresses held, no op output of its '
        f'size outside it)' if not bad else
        f'{what} NOT updated in place: moved {trace.moved}, shadow '
        f'copies {trace.shadows[:3]} (a full copy a dispatch)')


def _sharding_check(mesh) -> Dict[str, str]:
    if mesh is None or mesh.size == 1:
        return _check('output_sharding', 'skip',
                      'no mesh on this engine: the sharding audit runs on '
                      'sharded deployments')
    return _check('output_sharding', 'ok',
                  f'engine rows sharded over mesh axes '
                  f'{tuple(mesh.axis_names)}')


# ---------------------------------------------------------------------------
# Key counting: the port's analog of _cache_size()
# ---------------------------------------------------------------------------

class KeyLog:
    """An engine's ``graphs``, watched: every chunk's static key, whether
    it was met first (a capture) or again (a replay), and the phase of
    the batcher's StepProfiler it ran in.  `inner` is the engine's
    ChunkGraphs (its keys seed the log) or None, and then each chunk runs
    eagerly and only its key is recorded."""

    def __init__(self, inner=None, profiler=None):
        self.inner = inner
        self._profiler = profiler
        self._keys: Dict[Any, None] = {}
        self.events: List[tuple] = [
            ('seed', key, None) for key in (inner.keys() if inner else ())]

    @property
    def counted_by(self) -> str:
        if self.inner is not None:
            return "counted by the engine's ChunkGraphs (CUDA graphs)"
        return ('counted by a key-recording stand-in (no CUDA graphs '
                'here: each chunk ran eagerly)')

    def keys(self):
        return self.inner.keys() if self.inner is not None else list(
            self._keys)

    def run(self, key, body):
        phase = (self._profiler.current_phase()
                 if self._profiler is not None else None)
        first = key not in self.keys()
        self.events.append(('capture' if first else 'replay', key, phase))
        if self.inner is not None:
            return self.inner.run(key, body)
        self._keys[key] = None
        return body()

    def clear(self) -> None:
        self.events.append(('clear', None, None))
        if self.inner is not None:
            self.inner.clear()
        else:
            self._keys.clear()

    # ChunkGraphs' counters, for callers that read them.
    @property
    def captures(self) -> int:
        if self.inner is not None:
            return self.inner.captures
        return sum(e[0] == 'capture' for e in self.events)

    @property
    def replays(self) -> int:
        if self.inner is not None:
            return self.inner.replays
        return sum(e[0] == 'replay' for e in self.events)

    @property
    def capture_seconds(self) -> float:
        return self.inner.capture_seconds if self.inner is not None else 0.0

    def distinct(self, kind: str, phase: Optional[str] = None,
                 not_phase: Optional[str] = None) -> List[Any]:
        """The distinct keys of `kind` ('decode', 'verify') met over the
        engine's life (the reference's _cache_size: a clear drops the
        graphs, not the count), by the phase of their first capture."""
        first: Dict[Any, Optional[str]] = {}
        for ev, key, ph in self.events:
            if ev in ('seed', 'capture') and key[0] == kind \
                    and key not in first:
                first[key] = ph
        return [k for k, ph in first.items()
                if (phase is None or ph == phase)
                and (not_phase is None or ph != not_phase)]

    def visits(self) -> List[List[tuple]]:
        """The captures between two clears (a legacy plane's bucket
        visit: a migration drops every graph)."""
        out: List[List[tuple]] = [[]]
        for ev in self.events:
            if ev[0] == 'clear':
                out.append([])
            elif ev[0] in ('seed', 'capture'):
                out[-1].append(ev)
        return out


def watch(engine) -> KeyLog:
    """Put a KeyLog in the engine's ``graphs`` (once) and return it."""
    graphs = engine.graphs
    if isinstance(graphs, KeyLog):
        return graphs
    engine.graphs = KeyLog(graphs, getattr(engine, '_profiler', None))
    return engine.graphs


@contextlib.contextmanager
def _eager(engine):
    """The engine's chunks run eagerly, outside its graphs and key log."""
    graphs, engine.graphs = engine.graphs, None
    try:
        yield
    finally:
        engine.graphs = graphs


@contextlib.contextmanager
def _calls(owner, name: str):
    """Record the arguments of every call of owner.name (a module's
    function or an instance's method) inside the ``with``."""
    seen: List[tuple] = []
    orig = getattr(owner, name)
    own = isinstance(owner, types.ModuleType) or name in vars(owner)

    def recorder(*args, **kwargs):
        seen.append(args)
        return orig(*args, **kwargs)

    setattr(owner, name, recorder)
    try:
        yield seen
    finally:
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


def addresses(engine) -> Dict[str, int]:
    """The data_ptr of an engine's fixed rows and tables, and of its arena
    on the pooled plane (a legacy slot cache moves at a migration)."""
    out = {f'row{i}': t.data_ptr() for i, t in enumerate(engine._rows)}
    if getattr(engine, 'pooled', False):
        out['tables'] = engine._tables_dev.data_ptr()
        out.update({f'arena[{k}]': t.data_ptr()
                    for k, t in engine.pool.arena.items()})
    return out


def graph_budgets(engine, before: Optional[Dict[str, int]] = None
                  ) -> Dict[str, Any]:
    """The budgets of an engine that has served through a KeyLog
    (:func:`watch`): each key captured once a bucket visit; on the pooled
    plane at most 2 plain decode keys, 1 verify key and 2 fused-tail
    keys; on a legacy plane at most 2 decode keys a visit; and, with
    `before` (:func:`addresses` at the start), the same addresses now.
    Returns the counts with 'ok' and 'failures'."""
    log = engine.graphs
    fails: List[str] = []
    recaptured = []
    for i, visit in enumerate(log.visits()):
        keys = [k for _, k, _ in visit]
        recaptured += [(i, k) for k in set(keys) if keys.count(k) > 1]
    if recaptured:
        fails.append(f'keys captured twice in one visit: {recaptured}')
    pooled = getattr(engine, 'pooled', False)
    out: Dict[str, Any] = {'counted_by': log.counted_by,
                           'captures': log.captures,
                           'visits': len(log.visits())}
    if pooled:
        decode = log.distinct('decode', not_phase='fused')
        fused = log.distinct('decode', phase='fused')
        verify = log.distinct('verify')
        out.update(decode_keys=len(decode), fused_keys=len(fused),
                   verify_keys=len(verify))
        for what, keys, budget in (('decode', decode, 2),
                                   ('fused', fused, 2),
                                   ('verify', verify, 1)):
            if len(keys) > budget:
                fails.append(f'{len(keys)} {what} keys over a budget of '
                             f'{budget}: {keys}')
    else:
        per_visit = [len({k for _, k, _ in v if k[0] == 'decode'})
                     for v in log.visits()]
        out.update(decode_keys_per_visit=per_visit)
        if max(per_visit, default=0) > 2:
            fails.append(f'a bucket visit met {max(per_visit)} decode keys '
                         f'(budget 2: full chunk + tail)')
    if before is not None:
        now = addresses(engine)
        moved = sorted(k for k in before if now.get(k) != before[k])
        out['moved'] = moved
        if moved:
            fails.append(f'buffers moved: {moved}')
    out.update(ok=not fails, failures=fails)
    return out


# ---------------------------------------------------------------------------
# Tiny configs (seconds on the CPU)
# ---------------------------------------------------------------------------

# Chosen so a 40-token generation crosses EVERY cache bucket with no
# tail chunk (live_max stays >= decode_chunk below the context
# ceiling), making 'compiles == buckets visited' exact.
_AUDIT_PROMPTS = [[5, 9, 3, 7], [11, 2]]
_AUDIT_MAX_NEW = 40
_SHARED_HEAD = [7, 3, 9, 1, 4, 6, 2, 8, 5, 11, 13, 12, 10, 14, 15, 16]
_PREFIX_PROMPTS = [_SHARED_HEAD + [21, 22], _SHARED_HEAD + [23]]
_SPEC_PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 9, 9, 9]]


def _tiny_config(device=None):
    """The reference's tiny config (head_dim 16) on the CPU; on a card,
    LLAMA_DEBUG's widths (head_dim 128, f32) at the same depth and
    context."""
    from skypilot_tpu_torch.models import llama
    if resolve_device(device).type == 'cuda':
        return dataclasses.replace(llama.LLAMA_DEBUG, max_seq_len=64)
    return llama.LlamaConfig(vocab_size=128, d_model=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=128,
                             max_seq_len=64, dtype=torch.float32,
                             remat=False)


def _tiny_gen_config(**overrides):
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    kwargs = dict(max_seq_len=64, batch_size=2, prompt_buckets=[8],
                  cache_buckets=[16, 32, 64], decode_chunk=8)
    kwargs.update(overrides)
    return GeneratorConfig(**kwargs)


def _setup(device, cfg, params):
    """(device, config, parameters): random weights from seed 0 unless
    `params` is given."""
    from skypilot_tpu_torch.models import llama
    dev = resolve_device(device)
    cfg = cfg or _tiny_config(dev)
    if params is None:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return dev, cfg, params


def make_tiny_generator(mesh=None, *, device=None, cfg=None, params=None,
                        **overrides):
    """A Generator on the tiny config, watched (:func:`watch`)."""
    from skypilot_tpu_torch.infer.engine import Generator
    dev, cfg, params = _setup(device, cfg, params)
    gen = Generator(params, cfg, _tiny_gen_config(**overrides), mesh=mesh,
                    device=dev)
    watch(gen)
    return gen


def make_tiny_batcher(*, device=None, cfg=None, params=None,
                      decode_chunk: int = 8, **overrides):
    """A ContinuousBatcher on the tiny config, watched."""
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    dev, cfg, params = _setup(device, cfg, params)
    batcher = ContinuousBatcher(params, cfg, _tiny_gen_config(**overrides),
                                decode_chunk=decode_chunk, device=dev)
    watch(batcher)
    return batcher


# ---------------------------------------------------------------------------
# Checked chunks: each body once under the checker, on the engine's arena
# ---------------------------------------------------------------------------

def _sources(engine, cache=None) -> List[torch.Tensor]:
    out = _tensors(engine.params) + list(engine._rows)
    out += list((cache if cache is not None else _cache_of(engine)).values())
    for name in ('_tables_dev', '_draft', '_temp_row', '_top_p_row'):
        t = getattr(engine, name, None)
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _cache_of(engine):
    return engine.pool.arena if engine.pool is not None else engine._cache


def _scratch_rows(engine):
    """Decode rows for a checked chunk of the Generator: live rows at
    position 0 with a budget of 8 (block tables of zeros send every
    write to the garbage block)."""
    token, positions, done, limit = engine._rows
    return (torch.zeros_like(token), torch.zeros_like(positions),
            torch.zeros_like(done), torch.full_like(limit, 8))


def _generator_chunk(gen, n: int, cache=None) -> Trace:
    """One n-step decode chunk of the Generator under the checker, on its
    arena (or a legacy `cache`) with scratch rows and zero tables."""
    cache = cache if cache is not None else _cache_of(gen)
    rows = _scratch_rows(gen)
    tables = torch.zeros_like(gen._tables_dev) if gen.pooled else None
    with checked(_sources(gen, cache) + list(rows), arena=cache,
                 hold=rows, sync_debug=gen.device.type == 'cuda') as t:
        gen._decode_chunk_impl(rows[0], cache, rows[1], rows[2], rows[3],
                               tables, n)
    return t


def _generator_verify(gen) -> Trace:
    rows = _scratch_rows(gen)
    draft = torch.zeros_like(gen._draft)
    with checked(_sources(gen) + list(rows) + [draft], arena=gen.pool.arena,
                 hold=rows, sync_debug=gen.device.type == 'cuda') as t:
        gen._verify_chunk_impl(rows[0], gen.pool.arena, rows[1], rows[2],
                               rows[3], torch.zeros_like(gen._tables_dev),
                               draft)
    return t


def _batcher_chunk(batcher, n: int) -> Trace:
    """One all-greedy n-step decode chunk of an idle batcher under the
    checker, on its own rows and cache (free slots are frozen and their
    table rows point at the garbage block, as in every served chunk)."""
    batcher._upload_tables()
    with checked(_sources(batcher), arena=batcher._cache,
                 hold=batcher._rows,
                 sync_debug=batcher.device.type == 'cuda') as t:
        batcher._decode_steps(n, True, False)
    return t


def _batcher_fused(batcher, n: int) -> Trace:
    """One fused chunk (step 0 carrying a zero prefill lane at row 0 of
    the garbage block, then the n - 1 tail) of an idle batcher, eagerly
    under the checker."""
    batcher._upload_tables()
    dev = batcher.device
    lane = (torch.zeros((batcher.gen.fuse_budget,), dtype=torch.int32,
                        device=dev),
            torch.zeros((batcher.table_width,), dtype=torch.int32,
                        device=dev), 0)
    with _eager(batcher), checked(_sources(batcher) + list(lane[:2]),
                                  arena=batcher._cache,
                                  hold=batcher._rows) as t:
        batcher._decode(n, True, False, prefill_lane=lane)
    return t


def _prefill_trace(gen, bucket: int) -> Trace:
    """The Generator's cold prefill of a (B, bucket) prompt block under
    the checker: pooled, scattered into zero tables (the garbage block);
    legacy, into a fresh cache."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import llama_infer
    from skypilot_tpu_torch.infer import tp as tp_lib
    batch = gen.gen.batch_size
    dev = gen.device
    tokens = torch.zeros((batch, bucket), dtype=torch.int32, device=dev)
    lens = torch.ones((batch,), dtype=torch.int32, device=dev)
    if gen.pooled:
        cache = gen.pool.arena
        scatter = np.zeros((batch, -(-bucket // gen.block_size)), np.int32)
    else:
        cache = llama_infer.init_cache(
            tp_lib.local_config(gen.config, gen.mesh), batch,
            engine_lib.cache_bucket_for(gen.cache_buckets, bucket + 1),
            kv_dtype=gen.gen.kv_cache_dtype, device=dev)
        scatter = None
    with checked(_sources(gen, cache), arena=cache) as t:
        gen._prefill(tokens, lens, cache, scatter)
    return t


def _budget(name: str, count: int, budget: int, what: str, log: KeyLog,
            extra: str = '') -> Dict[str, str]:
    ok = count <= budget
    return _check(name, 'ok' if ok else 'fail',
                  f'{count} {what} for a budget of {budget}{extra}; '
                  f'{log.counted_by}'
                  + ('' if ok else ' -- a key now varies per chunk'))


# ---------------------------------------------------------------------------
# Entry-point audits
# ---------------------------------------------------------------------------

def audit_generator_decode(gen=None, *, device=None, cfg=None,
                           params=None) -> Dict[str, Any]:
    """The decode budget of the Generator: pooled (default), at most TWO
    decode keys (full chunk + context-ceiling tail; the block tables are
    rewritten in place, so growth never re-keys); legacy, one a cache
    bucket.  Plus the arena updated in place, and no host read or f64
    inside the chunk (legacy: at every cache bucket)."""
    gen = gen or make_tiny_generator(device=device, cfg=cfg, params=params)
    log = watch(gen)
    pooled = gen.pooled
    checks: List[Dict[str, str]] = []
    gen.generate(_AUDIT_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
    compiles = len(log.distinct('decode'))
    budget = 2 if pooled else len(gen.cache_buckets)
    checks.append(_budget(
        'compile_per_bucket', compiles, budget,
        'decode-chunk keys', log,
        ' (full chunk + tail; block tables are fixed buffers)' if pooled
        else f' cache buckets {list(gen.cache_buckets)}'))
    shapes = ['arena'] if pooled else list(gen.cache_buckets)
    traces = []
    for bucket in shapes:
        cache = None
        if not pooled:
            from skypilot_tpu_torch.infer import llama_infer
            from skypilot_tpu_torch.infer import tp as tp_lib
            cache = llama_infer.init_cache(
                tp_lib.local_config(gen.config, gen.mesh),
                gen.gen.batch_size, bucket, kv_dtype=gen.gen.kv_cache_dtype,
                device=gen.device)
        traces.append((bucket, _generator_chunk(gen, gen.gen.decode_chunk,
                                                cache)))
    checks.append(_worst_donation(traces, 'pool arena' if pooled
                                  else 'KV cache'))
    checks.extend(_worst_graph_checks(traces))
    checks.append(_sharding_check(gen.mesh))
    return {'entry': 'generator_decode', 'checks': checks,
            'compiles': compiles, 'buckets': shapes}


def _worst_donation(traces, what: str) -> Dict[str, str]:
    out = None
    for bucket, trace in traces:
        c = _donation_check(trace, what)
        if out is None or c['status'] == 'fail':
            out = dict(c, detail=f"{bucket}: {c['detail']}")
    return out


def _worst_graph_checks(traces) -> List[Dict[str, str]]:
    worst: Dict[str, Dict[str, str]] = {}
    for bucket, trace in traces:
        for c in _graph_checks(trace, str(bucket)):
            if c['status'] == 'fail' or c['name'] not in worst:
                worst[c['name']] = c
    return list(worst.values())


def audit_batcher_decode(batcher=None, *, device=None, cfg=None,
                         params=None) -> Dict[str, Any]:
    """The same budgets for the serving batcher's decode chunk (the
    arena matters more here: it is the dominant serving buffer and lives
    across requests)."""
    batcher = batcher or make_tiny_batcher(device=device, cfg=cfg,
                                           params=params)
    log = watch(batcher)
    pooled = batcher.pooled
    for prompt in _AUDIT_PROMPTS:
        batcher.submit(list(prompt), max_new_tokens=_AUDIT_MAX_NEW)
    batcher.run_until_idle()
    compiles = len(log.distinct('decode'))
    budget = 2 if pooled else len(batcher.cache_buckets)
    checks = [_budget('compile_per_bucket', compiles, budget,
                      'decode keys', log, ' (all-greedy run)')]
    trace = _batcher_chunk(batcher, batcher.decode_chunk)
    checks.append(_donation_check(trace, 'pool arena' if pooled
                                  else 'slot KV cache'))
    checks.extend(_graph_checks(trace))
    checks.append(_sharding_check(batcher.mesh))
    batcher.close()
    return {'entry': 'batcher_decode', 'checks': checks,
            'compiles': compiles,
            'buckets': (['arena'] if pooled
                        else list(batcher.cache_buckets))}


def audit_prefill(gen=None, *, device=None, cfg=None,
                  params=None) -> Dict[str, Any]:
    """Prefill at every prompt bucket: no host read, no f64.  Pooled:
    the scatter-into-arena prefill the engines run; legacy: the
    contiguous one."""
    gen = gen or make_tiny_generator(device=device, cfg=cfg, params=params)
    checks: List[Dict[str, str]] = []
    for bucket in gen.buckets:
        for c in _graph_checks(_prefill_trace(gen, bucket)):
            if c['status'] == 'fail':
                checks.append(dict(c, detail=f"bucket {bucket}: "
                                             f"{c['detail']}"))
    if not checks:
        checks = [_check('no_callbacks', 'ok',
                         f'clean across prompt buckets {list(gen.buckets)}'),
                  _check('no_f64', 'ok',
                         f'clean across prompt buckets {list(gen.buckets)}')]
    return {'entry': 'prefill', 'checks': checks}


def _prefix_generator(device, cfg, params):
    return make_tiny_generator(device=device, cfg=cfg, params=params,
                               prefix_cache_mb=4, prefix_block=8,
                               prompt_buckets=[32])


def _balanced(pool) -> bool:
    return pool.free_blocks() + pool.live_blocks() == pool.n_blocks - 1


def audit_prefix_cache(*, device=None, cfg=None,
                       params=None) -> Dict[str, Any]:
    """The radix prefix cache on the pooled plane: a cold+warm run keeps
    the decode budget (<= 2 keys), the warm run HITS, and the hit is a
    ZERO-COPY table splice: blocks shared by refcount, and
    ``prefix_cache.install_prefix`` (the legacy planes' install copy)
    never called."""
    from skypilot_tpu_torch.infer import prefix_cache
    gen = _prefix_generator(device, cfg, params)
    log = watch(gen)
    checks: List[Dict[str, str]] = []
    with _calls(prefix_cache, 'install_prefix') as installs:
        gen.generate(_PREFIX_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
        gen.generate(_PREFIX_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
    decode_compiles = len(log.distinct('decode'))
    checks.append(_budget('decode_compile_per_bucket', decode_compiles, 2,
                          'decode-chunk keys', log,
                          ' across a cold+warm prefix-cache run'))
    pc = gen.prefix
    checks.append(_check(
        'warm_run_hits', 'ok' if pc.hits > 0 else 'fail',
        f'{pc.hits} hits / {pc.misses} misses, {pc.tokens_saved} prompt '
        f'tokens saved'))
    install_compiles = len(installs)
    shares = gen.pool.prefix_shares
    checks.append(_check(
        'zero_copy_splice',
        'ok' if (install_compiles == 0 and shares > 0) else 'fail',
        f'{shares} prefix block shares, {install_compiles} install_prefix '
        f'calls (must be 0: a warm hit is a table splice, not a device '
        f'copy)'))
    checks.append(_check(
        'pool_refcount_invariant', 'ok' if _balanced(gen.pool) else 'fail',
        f'free {gen.pool.free_blocks()} + live {gen.pool.live_blocks()} == '
        f'total {gen.pool.n_blocks} - garbage'))
    return {'entry': 'prefix_cache', 'checks': checks,
            'decode_compiles': decode_compiles,
            'install_compiles': install_compiles, 'buckets': ['arena']}


def audit_block_pool(*, device=None, cfg=None,
                     params=None) -> Dict[str, Any]:
    """The block pool across a cold + warm + growth run: at most TWO
    decode keys, prefill at no more prompt-bucket shapes than there are
    buckets, the arena updated in place by the decode chunk and the
    scatter prefill, no host read or f64 in the chunk, and the free list
    balanced (free + live == total - garbage)."""
    gen = _prefix_generator(device, cfg, params)
    log = watch(gen)
    checks: List[Dict[str, str]] = []
    with _calls(gen, '_prefill') as prefills:
        gen.generate(_PREFIX_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
        gen.generate(_PREFIX_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
    decode_compiles = len(log.distinct('decode'))
    checks.append(_budget(
        'decode_compile_budget', decode_compiles, 2, 'decode-chunk keys',
        log, ' across a cold+warm+growth run (full chunk + tail; more '
        'means block-table growth re-keyed the chunk)'))
    prefill_compiles = len({args[0].shape[-1] for args in prefills})
    checks.append(_check(
        'prefill_compile_budget',
        'ok' if prefill_compiles <= len(gen.buckets) else 'fail',
        f'pooled prefill ran at {prefill_compiles} prompt-bucket shapes '
        f'for {len(gen.buckets)} prompt buckets (eager: a shape is a '
        f'compile of the reference)'))
    trace = _generator_chunk(gen, gen.gen.decode_chunk)
    checks.append(_donation_check(trace, 'pool arena (decode chunk)'))
    pf = _donation_check(_prefill_trace(gen, gen.buckets[0]),
                         'pool arena (scatter prefill)')
    pf['name'] = 'prefill_donation'
    checks.append(pf)
    checks.extend(_graph_checks(trace))
    stats = gen.pool.stats()
    balanced = (stats['blocks_free'] + stats['blocks_live']
                == stats['blocks_total'] - 1)
    checks.append(_check(
        'free_list_balance', 'ok' if balanced else 'fail',
        f"free {stats['blocks_free']} + live {stats['blocks_live']} vs "
        f"total {stats['blocks_total']} - garbage (live = trie-shared "
        f"prefix blocks)"))
    return {'entry': 'block_pool', 'checks': checks,
            'decode_compiles': decode_compiles,
            'prefill_compiles': prefill_compiles, 'pool': stats}


def audit_spec_decode(*, device=None, cfg=None,
                      params=None) -> Dict[str, Any]:
    """Speculative decoding: the draft is a FIXED (batch, spec_k), so
    verify is exactly ONE key beside the decode budget across a cold +
    warm run; the arena is written in place by the verify forward, with
    no host read or f64 in it."""
    gen = make_tiny_generator(device=device, cfg=cfg, params=params,
                              spec_k=3)
    log = watch(gen)
    checks: List[Dict[str, str]] = []
    gen.generate(_SPEC_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
    gen.generate(_SPEC_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
    verify_compiles = len(log.distinct('verify'))
    checks.append(_budget(
        'verify_compile_budget', verify_compiles, 1, 'verify-chunk keys',
        log, ' across a cold+warm run (the (batch, spec_k) draft is fixed)'))
    decode_compiles = len(log.distinct('decode'))
    checks.append(_budget(
        'decode_compile_budget', decode_compiles, 2,
        'sequential decode-chunk keys', log, ' beside verify'))
    trace = _generator_verify(gen)
    checks.append(_donation_check(trace, 'pool arena (verify chunk)'))
    checks.extend(_graph_checks(trace))
    checks.append(_sharding_check(gen.mesh))
    return {'entry': 'spec_decode', 'checks': checks,
            'verify_compiles': verify_compiles,
            'decode_compiles': decode_compiles, 'buckets': ['arena']}


def audit_fused_step(*, device=None, cfg=None,
                     params=None) -> Dict[str, Any]:
    """Chunked-prefill piggyback: the fused step pads its lane to a FIXED
    fuse_budget, so across a mixed-length all-greedy run its tails stay
    within 2 keys (step 0 carries a host start row and runs eagerly); the
    arena is written in place, with no host read or f64."""
    batcher = make_tiny_batcher(
        device=device, cfg=cfg, params=params, decode_chunk=4, batch_size=4,
        prompt_buckets=[8, 32], prefill_chunk=8, fuse_budget=6)
    log = watch(batcher)
    checks: List[Dict[str, str]] = []
    for prompt in _AUDIT_PROMPTS:
        batcher.submit(list(prompt), max_new_tokens=_AUDIT_MAX_NEW)
    batcher.submit(list(range(2, 26)), max_new_tokens=8)
    batcher.run_until_idle()
    fused_steps = batcher._fuse_policy.stats.steps
    checks.append(_check(
        'fused_steps_ran', 'ok' if fused_steps > 0 else 'fail',
        f'{fused_steps} fused steps during the mixed-length run (the '
        f'piggyback gate must engage, or the audit pins nothing)'))
    compiles = len(log.distinct('decode', phase='fused'))
    checks.append(_budget(
        'fused_compile_budget', compiles, 2, 'fused-tail keys', log,
        ' (fixed fuse_budget padding keys the tail off (n, all_greedy, '
        'nucleus) alone; all-greedy run)'))
    trace = _batcher_fused(batcher, 4)
    checks.append(_donation_check(trace, 'pool arena (fused step)'))
    checks.extend(_graph_checks(trace))
    checks.append(_sharding_check(batcher.mesh))
    batcher.close()
    return {'entry': 'fused_step', 'checks': checks,
            'compiles': compiles, 'fused_steps': fused_steps,
            'buckets': ['arena']}


def _copy_traces(tier, prefix: str, names=('gather', 'scatter')
                 ) -> List[Dict[str, str]]:
    """A one-node gather and scatter (block ids of the garbage block)
    under the checker; returns their no_callbacks/no_f64 checks, named
    f'{prefix}{label}_...', and the scatter's donation check last."""
    arena = tier.pool.arena
    ids = [0] * tier.ids_per_node
    with checked(list(arena.values()), arena=arena) as gather:
        tier.export_gather(ids)
    slot = tier._take_staging()
    with checked(list(arena.values()), arena=arena) as scatter:
        tier._scatter(slot, ids)
    out = []
    for label, trace in zip(names, (gather, scatter)):
        for c in _graph_checks(trace):
            c['name'] = f"{prefix}{label}_{c['name']}"
            out.append(c)
    out.append(_donation_check(scatter, 'ingest scatter arena'))
    return out


def audit_kv_tier(*, device=None, cfg=None, params=None) -> Dict[str, Any]:
    """The host KV tier: across a spill-heavy churn run and a hinted
    prefetch, every gather and scatter runs at ONE id-vector length
    (ids_per_node: a copy moves one trie node), with no host read or
    f64; the decode budget holds with the tier on, and the pool balances
    after a spilled prefix has round-tripped through host DRAM."""
    batcher = make_tiny_batcher(
        device=device, cfg=cfg, params=params, prefix_cache_mb=0.02,
        prefix_block=8, prompt_buckets=[32], host_tier_mb=4.0)
    log = watch(batcher)
    tier = batcher._tier
    checks: List[Dict[str, str]] = []
    try:
        vocab = batcher.config.vocab_size
        rng = np.random.default_rng(0)
        head = [int(t) for t in rng.integers(1, vocab, size=24)]
        rid = batcher.submit(head, max_new_tokens=8)
        batcher.run_until_idle()
        batcher.result(rid)
        for _ in range(8):
            p = [int(t) for t in rng.integers(1, vocab, size=24)]
            r = batcher.submit(p, max_new_tokens=4)
            batcher.run_until_idle()
            batcher.result(r)
        batcher.tier_flush()
        batcher.prefetch_hint(head)
        batcher.tier_flush()
        rid = batcher.submit(head, max_new_tokens=8)
        batcher.run_until_idle()
        batcher.result(rid)
        batcher.tier_flush()

        stats = tier.stats()
        exercised = stats['spills'] > 0 and stats['prefetches'] > 0
        checks.append(_check(
            'tier_exercised', 'ok' if exercised else 'fail',
            f"{stats['spills']} spills, {stats['prefetches']} prefetches "
            f"across the churn+hint run (both must be > 0 for the copy "
            f"budgets below to mean anything)"))
        gather_compiles = len(tier.copy_shapes['gather'])
        scatter_compiles = len(tier.copy_shapes['scatter'])
        checks.append(_check(
            'copy_compile_budget',
            'ok' if (gather_compiles <= 1 and scatter_compiles <= 1)
            else 'fail',
            f'gathers at {gather_compiles} / scatters at '
            f'{scatter_compiles} id-vector lengths '
            f'({sorted(tier.copy_shapes["gather"])} / '
            f'{sorted(tier.copy_shapes["scatter"])}; budget 1 each: a '
            f'copy moves one node of {tier.ids_per_node} ids)'))
        decode_compiles = len(log.distinct('decode'))
        checks.append(_budget(
            'decode_compile_budget', decode_compiles, 2,
            'pooled decode keys', log,
            ' with the tier on (spill/prefetch must not re-key decode)'))
        checks.extend(_copy_traces(tier, '')[:-1])
        pool = batcher.pool
        pool.check_invariant()
        checks.append(_check(
            'pool_refcount_invariant', 'ok' if _balanced(pool) else 'fail',
            f'free {pool.free_blocks()} + live {pool.live_blocks()} == '
            f'total {pool.n_blocks} - garbage after a host round-trip'))
    finally:
        batcher.close()
    return {'entry': 'kv_tier', 'checks': checks,
            'gather_compiles': gather_compiles,
            'scatter_compiles': scatter_compiles,
            'decode_compiles': decode_compiles, 'tier': stats}


def audit_disagg(*, device=None, cfg=None, params=None) -> Dict[str, Any]:
    """The prefill -> decode handoff (serve/disagg.py and the tier's
    export/ingest), for BOTH KV layouts (the model dtype and int8 with
    scales): the export gather and the ingest scatter each run at one
    id-vector length, without host reads or f64, the scatter writes the
    arena in place, greedy output equals a single-pool run, and both
    pools balance after release-after-export."""
    from skypilot_tpu_torch.serve import disagg as disagg_lib
    dev, cfg, params = _setup(device, cfg, params)
    checks: List[Dict[str, str]] = []
    per_layout: Dict[str, Dict[str, Any]] = {}
    for layout, kv_dtype in (('model', None), ('int8', 'int8')):
        def mk():
            return make_tiny_batcher(
                device=dev, cfg=cfg, params=params, prefix_cache_mb=0.5,
                prefix_block=8, prompt_buckets=[32], host_tier_mb=4.0,
                kv_cache_dtype=kv_dtype)
        rng = np.random.default_rng(7)
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, size=24)]
        ref = mk()
        try:
            rid = ref.submit(prompt, max_new_tokens=8)
            ref.run_until_idle()
            want = list(ref.result(rid))
        finally:
            ref.close()
        pre, dec = mk(), mk()
        try:
            rid = pre.submit(prompt, max_new_tokens=1)
            pre.run_until_idle()
            pre.result(rid)
            res = pre.export_handoff(prompt)
            exported = bool(res and res['payload'])
            checks.append(_check(
                f'{layout}_export_nonempty', 'ok' if exported else 'fail',
                f"{res['tokens'] if res else 0} tokens exported of "
                f'{len(prompt)} prompt tokens (whole trie nodes only)'))
            pre.pool.check_invariant()
            checks.append(_check(
                f'{layout}_prefill_pool_released',
                'ok' if _balanced(pre.pool) else 'fail',
                f'prefill pool free {pre.pool.free_blocks()} + live '
                f'{pre.pool.live_blocks()} == total {pre.pool.n_blocks} - '
                f'garbage after release-after-export'))
            gather_compiles = len(pre._tier.copy_shapes['gather'])
            got, data = [], b''
            if exported:
                data = disagg_lib.encode_kv_image(
                    prompt[:res['tokens']], 8, res['payload'])
                img = disagg_lib.decode_kv_image(data)
                dec.ingest_handoff(prompt, img.payload)
                dec.tier_flush()
                rid = dec.submit(prompt, max_new_tokens=8)
                dec.run_until_idle()
                got = list(dec.result(rid))
                dec.tier_flush()
            checks.append(_check(
                f'{layout}_greedy_parity', 'ok' if got == want else 'fail',
                f'handoff decode emitted {got} vs single-pool {want}'))
            tier_stats = dec._tier.stats()
            checks.append(_check(
                f'{layout}_ingest_exercised',
                'ok' if (tier_stats['adopted'] > 0
                         and tier_stats['prefetches'] > 0) else 'fail',
                f"{tier_stats['adopted']} nodes adopted, "
                f"{tier_stats['prefetches']} prefetches (the image must "
                f'ride the ordinary tier staging path)'))
            scatter_compiles = len(dec._tier.copy_shapes['scatter'])
            checks.append(_check(
                f'{layout}_copy_compile_budget',
                'ok' if (gather_compiles <= 1 and scatter_compiles <= 1)
                else 'fail',
                f'export gathers at {gather_compiles} / ingest scatters at '
                f'{scatter_compiles} id-vector lengths (budget 1 each per '
                f'layout)'))
            dec.pool.check_invariant()
            checks.append(_check(
                f'{layout}_decode_pool_invariant',
                'ok' if _balanced(dec.pool) else 'fail',
                f'decode pool free {dec.pool.free_blocks()} + live '
                f'{dec.pool.live_blocks()} == total {dec.pool.n_blocks} - '
                f'garbage after the spliced decode'))
            copies = _copy_traces(dec._tier, f'{layout}_',
                                  ('export_gather', 'ingest_scatter'))
            copies[-1]['name'] = f"{layout}_scatter_donation"
            checks.extend(copies)
            per_layout[layout] = {
                'gather_compiles': gather_compiles,
                'scatter_compiles': scatter_compiles,
                'exported_tokens': res['tokens'] if res else 0,
                'image_bytes': len(data),
            }
        finally:
            pre.close()
            dec.close()
    return {'entry': 'disagg', 'checks': checks, 'layouts': per_layout}


def _trainer(device, cfg):
    """A one-device Trainer of `cfg` (LLAMA_DEBUG by default) and one
    synthetic (2, 16) batch."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  synthetic_batches)
    dev = resolve_device(device)
    cfg = cfg or llama.LLAMA_DEBUG
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    trainer = Trainer(lambda p, b: llama.loss_fn(p, b, cfg), params,
                      TrainConfig(total_steps=2), device=dev)
    batch = next(synthetic_batches(2, 16, cfg.vocab_size))
    return trainer, batch


def _state_tensors(trainer) -> List[torch.Tensor]:
    return (list(trainer._leaves) + list(trainer.opt_state['mu'])
            + list(trainer.opt_state['nu']))


def _checked_step(trainer, batch):
    """One train step under the checker (the parameters and Adam's
    moments are the sources, the parameters must keep their addresses):
    (trace, the step's peak extra bytes, how they were measured)."""
    cuda = trainer.device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(trainer.device)
        torch.cuda.reset_peak_memory_stats(trainer.device)
        base = torch.cuda.memory_allocated(trainer.device)
    with checked(_state_tensors(trainer), hold=trainer._leaves,
                 track_bytes=not cuda) as trace:
        trainer.run_step(batch)
    if cuda:
        torch.cuda.synchronize(trainer.device)
        peak = torch.cuda.max_memory_allocated(trainer.device) - base
        how = "the CUDA allocator's peak"
    else:
        peak = trace.peak_bytes
        how = 'new storage live at once under the dispatch mode'
    return trace, peak, how


def audit_trainer_step(*, device=None, cfg=None) -> Dict[str, Any]:
    """Train step (the second, steady one): params updated in place
    (the steady state must not double the parameters), Adam's moments
    rebound leaf by leaf (never a second copy of the whole state live),
    no host read, no f64."""
    trainer, batch = _trainer(device, cfg)
    # The second step is the steady state: the first makes the moments'
    # first values and, on a card, a cuBLAS workspace for each stream
    # and thread (the backward's) that runs a product.
    trainer.run_step(batch)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _state_tensors(trainer))
    trace, peak, how = _checked_step(trainer, batch)
    second_copy = peak >= state_bytes
    bad = trace.moved or second_copy
    detail = (f'params + optimizer state: params updated in place '
              f'({len(trainer._leaves)} leaves kept their addresses), mu '
              f'and nu rebound leaf by leaf; peak extra {peak} bytes '
              f'({how}) beside {state_bytes} bytes of params + state')
    if trace.moved:
        detail += f'; MOVED: {trace.moved}'
    if second_copy:
        detail += ' -- a second copy of the whole state was live'
    checks = [_check('donation', 'fail' if bad else 'ok', detail)]
    checks.extend(_graph_checks(trace))
    trainer.close()
    return {'entry': 'trainer_step', 'checks': checks}


def _row_shards(named, process_index: int, process_count: int):
    """The JAX package's even_row_shard as Shard leaves: axis 0 split
    evenly over the process grid; a leaf whose leading axis does not
    divide is written whole by the owner its key hashes to."""
    from skypilot_tpu_torch.ckpt import format as format_lib
    out = []
    for key, leaf in named:
        shape = tuple(leaf.shape)
        full = [(0, d) for d in shape]
        if shape and shape[0] >= process_count \
                and shape[0] % process_count == 0:
            rows = shape[0] // process_count
            lo, hi = process_index * rows, (process_index + 1) * rows
            out.append(format_lib.Shard(leaf[lo:hi], shape,
                                        [(lo, hi)] + full[1:]))
        else:
            owner = zlib.crc32(key.encode()) % process_count
            out.append(format_lib.Shard(leaf, shape, full,
                                        owner == process_index))
    return out


def audit_ckpt_reshard(*, device=None, cfg=None) -> Dict[str, Any]:
    """Elastic-resume restore: a checkpoint written under a simulated
    4-process grid (axis-0 windows) restores into a live 1-process
    Trainer bit for bit, with no f64 promotion in host assembly, into
    the live leaves in place (the analog of a bounded compile cache: the
    restore changes no leaf's shape, dtype or address), and the step
    after it reads nothing on the host and makes no f64."""
    from skypilot_tpu_torch.ckpt import format as format_lib
    trainer, batch = _trainer(device, cfg)
    trainer.run_step(batch)
    trainer.run_step(batch)
    checks: List[Dict[str, str]] = []
    before = [t.data_ptr() for t in _state_tensors(trainer)]
    named, treedef = format_lib.flatten_with_keys(trainer._state_dict())
    host = [(k, v.detach().cpu().clone() if isinstance(v, torch.Tensor)
             else v) for k, v in named]
    probe = [t.detach().cpu().clone() for t in _state_tensors(trainer)]
    with tempfile.TemporaryDirectory() as root:
        writer_grid = 4
        for p in range(writer_grid):
            format_lib.write_process_shards(
                root, 7, format_lib.tree_unflatten(
                    treedef, _row_shards(host, p, writer_grid)),
                process_index=p, process_count=writer_grid)
        format_lib.commit(root, 7, process_count=writer_grid)
        restored_step = trainer.restore_latest(root)
    checks.append(_check(
        'reshard_restore', 'ok' if restored_step == 7 else 'fail',
        f'4-process sharded checkpoint restored under a 1-process grid '
        f'(step {restored_step})'))
    got = [t.detach().cpu() for t in _state_tensors(trainer)]
    exact = all(g.dtype == w.dtype and torch.equal(g, w)
                for g, w in zip(got, probe))
    checks.append(_check(
        'roundtrip_bit_exact', 'ok' if exact else 'fail',
        f'{len(got)} params, mu and nu leaves bit-exact and dtype-stable '
        f'across the topology change' if exact else
        'a restored leaf differs from the one saved'))
    f64 = [str(t.dtype) for t in got
           if t.dtype == torch.float64]  # the check; skytpu-allow: SKY106
    checks.append(_check(
        'no_f64', 'fail' if f64 else 'ok',
        'restored leaves silently promoted to f64' if f64 else
        'no restored leaf promoted to f64 by host assembly'))
    after = [t.data_ptr() for t in _state_tensors(trainer)]
    kept = after == before
    checks.append(_check(
        'bounded_compiles', 'ok' if kept else 'fail',
        f'the restore copied into the {len(after)} live leaves in place: '
        f'every address held (shapes and dtypes unchanged)' if kept else
        'the restore rebound live leaves: a captured step would read the '
        'old buffers'))
    checks.extend(_graph_checks(_checked_step(trainer, batch)[0]))
    trainer.close()
    return {'entry': 'ckpt_reshard', 'checks': checks}


def audit_ring_attention(*, device=None, cfg=None) -> Dict[str, Any]:
    """Ring attention's body (parallel/ring_attention.py) on a one-rank
    mesh: no host read, no f64."""
    from skypilot_tpu_torch.parallel import ring_attention as ring_lib
    from skypilot_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    dev = resolve_device(device)
    mesh = make_mesh(MeshConfig())
    q = torch.zeros((2, 16, 4, 8), dtype=torch.float32, device=dev)
    k, v = torch.zeros_like(q), torch.zeros_like(q)
    with checked([q, k, v]) as trace:
        ring_lib.ring_attention(q, k, v, mesh)
    return {'entry': 'ring_attention', 'checks': _graph_checks(trace)}


def _combines(trace: Trace) -> List[Dict[str, Any]]:
    return [c for c in trace.collectives if c['summed']]


def audit_mesh_decode(*, device=None, cfg=None,
                      params=None) -> Dict[str, Any]:
    """The SHARDED pooled decode on a tp 2 mesh of two rank processes
    (every rank calls it; skipped without a process group of 2):

    - the mesh does not re-key decode: still <= 2 keys, and verify 1;
    - the arena is updated in place;
    - megatron's collective budget: exactly 2 activation-sized
      all-reduces a layer (after wo and after w_down), each a gather of
      the partial's bytes summed in rank order (>= rows x d_model
      elements);
    - no all-gather rebuilds the arena (paged reads stay on the rank's
      KV heads);
    - with ``overlap_collectives=True, overlap_chunks=2`` no combine is
      activation-sized, and a layer issues exactly 2 x 2 span gathers:
      ``llama_infer._combine_then_project`` runs each of a layer's two
      combines (before the q/k/v and before the gate/up products) as
      ``pipelined_psum`` over ``chunk_bounds(d_model, 2)``, one gather a
      span (the last layer's w_down combine after the loop)."""
    import torch.distributed as dist
    from skypilot_tpu_torch.infer import tp as tp_lib
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != 2:
        return {'entry': 'mesh_decode', 'checks': [_check(
            'mesh', 'skip',
            f'needs a torch.distributed process group of 2 ranks, have '
            f'{world} -- run it on every rank of one (tests/_torch_ranks.py '
            f'pools them over gloo)')]}
    dev, cfg, params = _setup(device, cfg, params)
    mesh = tp_lib.make_tp_mesh(2, n_kv_heads=cfg.n_kv_heads)
    gen = make_tiny_generator(mesh=mesh, device=dev, cfg=cfg, params=params)
    log = gen.graphs
    checks: List[Dict[str, str]] = []
    gen.generate(_AUDIT_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
    compiles = len(log.distinct('decode'))
    checks.append(_budget('compile_per_bucket', compiles, 2,
                          'decode-chunk keys on the 2-rank mesh', log))
    trace = _generator_chunk(gen, 1)
    checks.append(_donation_check(trace, 'sharded pool arena'))

    rows = gen.gen.batch_size
    act_elems = rows * cfg.d_model
    sums = _combines(trace)
    big = [c for c in sums if c['elements'] >= act_elems]
    per_layer = len(big) / cfg.n_layers
    checks.append(_check(
        'collective_budget', 'ok' if per_layer == 2 else 'fail',
        f'{per_layer:g} activation-sized all-reduces per layer (megatron '
        f'rule: exactly 2, after wo and after w_down) in one decode step '
        f'of {cfg.n_layers} layers; smaller combines '
        f'(< {act_elems} elements, unbudgeted): {len(sums) - len(big)}; '
        f'collectives seen: {len(trace.collectives)}'))
    arena_bytes = sum(t.numel() * t.element_size()
                      for t in gen.pool.arena.values()) \
        * tp_lib.model_size(mesh)
    gathers = [c['bytes'] for c in trace.collectives
               if c['kind'] == 'all_gather']
    biggest = max(gathers, default=0)
    checks.append(_check(
        'no_arena_allgather', 'ok' if biggest < arena_bytes else 'fail',
        f'largest all-gather in the sharded decode moves {biggest} bytes '
        f'(the whole arena would be {arena_bytes})'))

    spec = make_tiny_generator(mesh=mesh, device=dev, cfg=cfg,
                               params=params, spec_k=3)
    spec.generate(_SPEC_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
    spec.generate(_SPEC_PROMPTS, max_new_tokens=_AUDIT_MAX_NEW)
    verify_compiles = len(spec.graphs.distinct('verify'))
    checks.append(_budget('verify_compile_budget', verify_compiles, 1,
                          'verify-chunk keys on the 2-rank mesh', spec.graphs,
                          ' across a cold+warm run'))

    ring_chunks = 2
    expected = 2 * ring_chunks
    gen2 = make_tiny_generator(mesh=mesh, device=dev, cfg=cfg, params=params,
                               overlap_collectives=True,
                               overlap_chunks=ring_chunks)
    trace2 = _generator_chunk(gen2, 1)
    sums2 = _combines(trace2)
    big2 = [c for c in sums2 if c['elements'] >= act_elems]
    spans = len(sums2) / cfg.n_layers
    checks.append(_check(
        'ring_collective_pin',
        'ok' if (not big2 and spans == expected) else 'fail',
        f'chunks={ring_chunks}: {spans:g} span gathers per layer (expected '
        f'{expected} = 2 combines x {ring_chunks} chunks, from '
        f'_combine_then_project), {len(big2)} activation-sized all-reduces '
        f'(expected 0: every combine rides the chunked gathers)'))
    return {'entry': 'mesh_decode', 'checks': checks,
            'compiles': compiles, 'allreduce_per_layer': per_layer,
            'verify_compiles': verify_compiles,
            'ring_collective_permutes_per_layer': spans}


REGISTRY: Dict[str, Callable[..., Dict[str, Any]]] = {
    'generator_decode': audit_generator_decode,
    'batcher_decode': audit_batcher_decode,
    'prefill': audit_prefill,
    'prefix_cache': audit_prefix_cache,
    'block_pool': audit_block_pool,
    'spec_decode': audit_spec_decode,
    'fused_step': audit_fused_step,
    'kv_tier': audit_kv_tier,
    'disagg': audit_disagg,
    'mesh_decode': audit_mesh_decode,
    'trainer_step': audit_trainer_step,
    'ckpt_reshard': audit_ckpt_reshard,
    'ring_attention': audit_ring_attention,
}


def run_audit(entries: Optional[List[str]] = None, *, device=None,
              cfg=None) -> Dict[str, Any]:
    """Run the registered audits on `device` (the card by default); an
    exception inside an entry is itself a failed check ('trace'), not a
    crash: that IS the regression the auditor exists to catch."""
    results = []
    for name in (entries or list(REGISTRY)):
        try:
            results.append(REGISTRY[name](device=device, cfg=cfg))
        except Exception as e:  # noqa: broad -- any error is a finding
            results.append({
                'entry': name,
                'checks': [_check(
                    'trace', 'fail',
                    f'entry point failed to run: {type(e).__name__}: {e}')],
            })
    ok = all(c['status'] != 'fail' for r in results for c in r['checks'])
    return {'entries': results, 'ok': ok}


def quick_summary(*, device=None, cfg=None) -> Dict[str, Any]:
    """Compact roll-up of the Generator's decode audit: decode keys, the
    budget and the in-place arena.  The reference's ``lint_rules`` and
    ``graph_thread_entries`` count the JAX package's own linter and call
    graph, which no path of the port needs: they are left out."""
    report = audit_generator_decode(device=device, cfg=cfg)
    by_name = {c['name']: c for c in report['checks']}
    return {
        'decode_compiles': report['compiles'],
        'cache_buckets': report['buckets'],
        'compile_budget_ok':
            by_name['compile_per_bucket']['status'] == 'ok',
        'cache_donated': by_name['donation']['status'] == 'ok',
        'failures': sum(1 for c in report['checks']
                        if c['status'] == 'fail'),
    }
