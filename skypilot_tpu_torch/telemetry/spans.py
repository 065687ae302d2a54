"""Request-lifecycle spans + step-phase attribution for the serving
data plane.

A copy of skypilot_tpu/telemetry/spans.py (the port imports nothing of
the JAX package), with the same gate variables, span record shape,
Perfetto export and phase accounting, so the two packages' spans merge
into one trace file.  Two primitives:

- ``SpanBuffer``: a bounded ring of lightweight span records
  (`trace_id`, `request_id`, name, t0/t1, attrs) with Perfetto-JSON
  export: `export()` merges `traceEvents` into the `SKYTPU_TIMELINE_FILE`
  trace under a file lock, so batcher spans land in the SAME trace file
  as the other processes' spans.  The reference takes that lock with
  the `filelock` package; this copy takes an exclusive ``fcntl.flock``
  on the same `<path>.lock` file (the written bytes are the same).  The
  module-level default buffer records WALL-clock spans and is gated by
  `enabled()` (one env/flag check per call site when off).  Instance
  buffers take their own `clock`.

- ``StepProfiler``: EXCLUSIVE host-timer attribution of one scheduler
  step to phases (admit / prefill / fused / spec_draft / spec_verify /
  decode / host_fetch / upload).  Phases nest on a stack and entering
  a nested phase PAUSES the enclosing one (a host_fetch inside the
  decode path is charged to host_fetch alone), so the per-phase times
  sum to the step wall time minus only unattributed scheduler
  bookkeeping.  On a CUDA device launches are asynchronous: a phase
  that dispatches device work measures the host's dispatch, and the
  device time lands in the `host_fetch` that waits for it, as JAX's
  async dispatch puts it there in the reference.
"""
from __future__ import annotations

import atexit
import contextlib
import fcntl
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

# Span emission is ON when either var is set: SKYTPU_TIMELINE_FILE
# (spans join the launch timeline at exit) or SKYTPU_SPANS=1 (collect
# in-process without a trace file — the bench's overhead arm and the
# HTTP /debug uses).  set_enabled() overrides both.
ENV_VAR = 'SKYTPU_SPANS'
TIMELINE_ENV_VAR = 'SKYTPU_TIMELINE_FILE'

# Default per-process ring capacity: at ~120 bytes/span this bounds
# the buffer near 8 MB; a steady replica emitting ~10 spans/tick wraps
# in hours, and `dropped` keeps the loss honest.
DEFAULT_CAPACITY = 65536

_FORCED: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force span emission on/off; None restores env gating.  The
    bench's spans-on/spans-off decode arms flip this to measure the
    emission overhead without touching the environment."""
    global _FORCED
    _FORCED = value


def enabled() -> bool:
    if _FORCED is not None:
        return _FORCED
    return bool(os.environ.get(ENV_VAR)
                or os.environ.get(TIMELINE_ENV_VAR))


class SpanBuffer:
    """Bounded ring of span records with Perfetto-JSON export.

    clock: returns CURRENT time in seconds — wall (`time.time`, the
    default) for live processes, a virtual clock for the simulator.
    pid/tid: fixed ids stamped on exported events (defaults: real pid,
    tid 0).  Fixing them is what makes simulator exports reproducible;
    live buffers keep the real pid so multi-process merges stay
    distinguishable, same as utils/timeline.py events.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None,
                 pid: Optional[int] = None,
                 tid: Optional[int] = None) -> None:
        if capacity < 1:
            raise ValueError(f'capacity must be >= 1, got {capacity}')
        self.capacity = capacity
        self.clock: Callable[[], float] = clock or time.time
        self.pid = pid
        self.tid = tid
        self.dropped = 0
        self._spans: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._spans)

    def record(self, name: str, t0: float, t1: float, *,
               trace_id: Optional[str] = None,
               request_id: Optional[int] = None,
               **attrs: Any) -> None:
        """Append one complete span [t0, t1] (seconds on this buffer's
        clock).  Instant markers pass t0 == t1."""
        span: Dict[str, Any] = {'name': name, 't0': float(t0),
                                't1': float(t1)}
        if trace_id:
            span['trace_id'] = trace_id
        if request_id is not None:
            span['request_id'] = request_id
        if attrs:
            span['attrs'] = attrs
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._spans.pop(0)
                self.dropped += 1
            self._spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, *, trace_id: Optional[str] = None,
             request_id: Optional[int] = None,
             **attrs: Any) -> Iterator[None]:
        """Record the with-block as one span on this buffer's clock."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.record(name, t0, self.clock(), trace_id=trace_id,
                        request_id=request_id, **attrs)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self._spans]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def events(self) -> List[Dict[str, Any]]:
        """Chrome-trace complete ('X') events, the utils/timeline.py
        shape — what Perfetto/chrome://tracing loads and what the
        timeline merge path concatenates."""
        pid = self.pid if self.pid is not None else os.getpid()
        tid = self.tid if self.tid is not None else 0
        events = []
        for span in self.snapshot():
            event: Dict[str, Any] = {
                'name': span['name'],
                'cat': 'skypilot_tpu_span',
                'ph': 'X',
                'ts': span['t0'] * 1e6,
                'dur': (span['t1'] - span['t0']) * 1e6,
                'pid': pid,
                'tid': tid,
            }
            args: Dict[str, Any] = dict(span.get('attrs', {}))
            if 'trace_id' in span:
                args['trace_id'] = span['trace_id']
            if 'request_id' in span:
                args['request_id'] = span['request_id']
            if args:
                event['args'] = args
            events.append(event)
        return events

    def export(self, path: str, *, extra_events:
               Optional[List[Dict[str, Any]]] = None) -> int:
        """Merge this buffer's events (plus `extra_events`, e.g. other
        replicas' buffers) into the trace file at `path` under the
        timeline's file-lock protocol — never overwrites other
        processes' spans.  Events are sorted and serialized with
        sorted keys, so a fresh-path export is byte-deterministic for
        deterministic clocks.  Returns the event count written."""
        events = self.events() + list(extra_events or [])
        events.sort(key=_event_sort_key)
        path = os.path.expanduser(path)
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        with _file_lock(path + '.lock'):
            try:
                with open(path, encoding='utf-8') as f:
                    existing = json.load(f).get('traceEvents', [])
            except (OSError, ValueError):
                existing = []
            with open(path, 'w', encoding='utf-8') as f:
                json.dump({'traceEvents': existing + events}, f,
                          sort_keys=True)
        return len(events)


@contextlib.contextmanager
def _file_lock(lock_path: str) -> Iterator[None]:
    """An exclusive advisory lock on `lock_path` for the with-block
    (created if missing), held by every process that merges into the
    same trace file."""
    with open(lock_path, 'a', encoding='utf-8') as lock:
        fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock.fileno(), fcntl.LOCK_UN)


def _event_sort_key(event: Dict[str, Any]):
    return (event['ts'], event['pid'], event['tid'], event['name'],
            event['dur'])


_DEFAULT = SpanBuffer()


def default_buffer() -> SpanBuffer:
    return _DEFAULT


def record(name: str, t0: float, t1: float, **kwargs: Any) -> None:
    """Record into the default wall-clock buffer; cheap no-op when
    span emission is disabled."""
    if not enabled():
        return
    _DEFAULT.record(name, t0, t1, **kwargs)


@contextlib.contextmanager
def span(name: str, **kwargs: Any) -> Iterator[None]:
    if not enabled():
        yield
        return
    with _DEFAULT.span(name, **kwargs):
        yield


@atexit.register
def flush() -> None:
    """Merge the default buffer into SKYTPU_TIMELINE_FILE (when set)
    so batcher/LB spans join the launch timeline; the buffer is
    cleared after a successful write, so explicit flush() plus the
    atexit call never duplicates spans."""
    path = os.environ.get(TIMELINE_ENV_VAR)
    if not path or not len(_DEFAULT):
        return
    try:
        _DEFAULT.export(path)
    except OSError:
        return
    _DEFAULT.clear()


# ---- step-phase attribution --------------------------------------------

STEP_PHASES = ('admit', 'prefill', 'fused', 'spec_draft', 'spec_verify',
               'decode', 'host_fetch', 'upload', 'collective')


class StepProfiler:
    """Attribute one scheduler step to exclusive phases with host
    timers.

    Accounting is boundary-based: `_mark` is the time of the last
    attribution boundary, and every phase enter/exit charges the
    elapsed [mark, now) to exactly one phase — the one on top of the
    stack — then advances the mark.  Entering a nested phase therefore
    PAUSES the enclosing phase (no double counting), and
    sum(phases) + unattributed == wall exactly; the unattributed
    remainder is plain-Python scheduler bookkeeping between phase
    blocks, asserted small (<10% of wall) in tests.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter
                 ) -> None:
        self._clock = clock
        self._t0: Optional[float] = None
        self._mark = 0.0
        self._stack: List[str] = []
        self._acc: Dict[str, float] = {}
        # Last finished step, kept for exporters (bench, steplog).
        self.last_phases: Dict[str, float] = {}
        self.last_wall = 0.0

    def start(self) -> None:
        self._stack = []
        self._acc = {}
        self._t0 = self._mark = self._clock()

    def current_phase(self) -> Optional[str]:
        """The innermost phase open now (None outside a phase)."""
        return self._stack[-1] if self._stack else None

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if self._t0 is None:
            # Not inside a profiled step (direct calls from tests or
            # drain paths): attribution is meaningless, stay inert.
            yield
            return
        now = self._clock()
        if self._stack:
            top = self._stack[-1]
            self._acc[top] = self._acc.get(top, 0.0) + (now - self._mark)
        self._mark = now
        self._stack.append(name)
        try:
            yield
        finally:
            now = self._clock()
            self._acc[name] = self._acc.get(name, 0.0) + (now - self._mark)
            self._stack.pop()
            self._mark = now

    def reattribute(self, src: str, dst: str, fraction: float) -> float:
        """Move `fraction` of phase `src`'s accumulated seconds to
        phase `dst` (e.g. the estimated collective share of a
        mesh-sharded decode chunk into the 'collective' phase).  Time
        is MOVED, never invented, so the exclusive-accounting
        invariant — sum(phases) <= wall — is preserved exactly.
        Returns the seconds moved (0.0 when src never ran or the
        fraction is non-positive)."""
        if src not in self._acc or fraction <= 0.0:
            return 0.0
        moved = self._acc[src] * min(fraction, 1.0)
        self._acc[src] -= moved
        self._acc[dst] = self._acc.get(dst, 0.0) + moved
        return moved

    def finish(self) -> Dict[str, float]:
        """End the step; returns {phase: seconds} and records
        last_phases/last_wall.  Empty dict when start() never ran."""
        if self._t0 is None:
            return {}
        wall = self._clock() - self._t0
        self._t0 = None
        self._stack = []
        self.last_phases = dict(self._acc)
        self.last_wall = wall
        return self.last_phases
