"""Host-DRAM KV tier behind the radix prefix cache.

Counterpart of skypilot_tpu/infer/kv_tier.py.  A byte-budgeted HOST
block store laid out like the pooled arena (one buffer per cache
component, rows are whole arena blocks, bf16 and int8 + scales alike),
with an asynchronous copy engine (bounded queue, one thread, errors
re-raised at the drain point):

- **Spill**: when the trie evicts a device-resident node
  (``PrefixCache._drop``), the tier gathers the node's arena blocks on
  the scheduler's current stream BEFORE the blocks return to the free
  list.  The blocks' next owner writes later on the same stream, so the
  gather reads them first.  A side CUDA stream waits for the current one
  and copies the gathered rows into pinned host rows
  (``non_blocking=True``); the gathered tensor stays referenced until
  the copy's event completes, which the copy thread waits for.
- **Prefetch**: admission (or a routing hint) that finds a host-resident
  continuation allocates surplus pool blocks
  (``BlockPool.alloc_for_prefetch``, never admission reservations),
  parks the request, and the copy thread fills a pinned staging buffer
  from the host rows (host work only).  At ``drain``, on the scheduler
  thread, the staging buffer goes to the card on the side stream, the
  current stream waits on that copy's event, and ``index_copy_`` writes
  the blocks into the arena along its block axis.  A staging buffer is
  reused only after its event has completed.  The parked request then
  takes the ordinary warm-hit splice.

The arena is written in place and never rebound: captured decode graphs
read it by address.  All device dispatch (gather, the side stream's
copies, the scatter) happens on the scheduler thread; the copy thread
only waits on events and moves host bytes.  Host memory (the rows and
the staging buffers) is allocated once, pinned when the arena is on a
CUDA device, when the tier is built; no copy allocates pinned memory.
On a CPU arena the same steps run synchronously, without streams.
"""
from __future__ import annotations

import logging
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics

logger = logging.getLogger(__name__)

# The copy thread's name: the JAX package's threads are 'kv-tier-copy',
# and its tests look for live threads of exactly that name.
COPY_THREAD_NAME = 'kv-tier-copy-torch'

# Byte alignment of each carve of the one host allocation.
_ALIGN = 512


class AsyncCopyEngine:
    """One daemon thread executing queued copy closures in order.

    ``try_submit`` never blocks (a full queue REJECTS the job, so eviction
    under admission pressure cannot stall the tick), and errors are kept
    with their unwind callback instead of raised on the thread: the
    callback mutates pool and trie state, so ``KVTier.drain`` runs it and
    re-raises on the scheduler thread."""

    def __init__(self, max_pending: int = 2, name: str = COPY_THREAD_NAME):
        if max_pending < 1:
            raise ValueError(f'max_pending must be >= 1, '
                             f'got {max_pending}')
        self.max_pending = max_pending
        self._queue: 'queue.Queue' = queue.Queue(maxsize=max_pending)
        self._errors: List[Tuple[BaseException,
                                 Optional[Callable[[], None]]]] = []
        self._errors_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._name = name
        self._closed = False

    # -- caller (scheduler thread) side ---------------------------------
    def try_submit(self, job: Callable[[], None],
                   on_error: Optional[Callable[[], None]] = None) -> bool:
        """Enqueue a copy closure; False (no side effects) when the
        bounded queue is full or the engine is closed."""
        if self._closed:
            return False
        self._ensure_thread()
        try:
            self._queue.put_nowait((job, on_error))
        except queue.Full:
            return False
        return True

    def wait_until_finished(self) -> None:
        """Block until every queued job ran.  Errors are not raised here:
        ``pop_errors`` hands them to the scheduler thread."""
        self._queue.join()  # skytpu-allow: SKY504

    def pop_errors(self) -> List[Tuple[BaseException,
                                       Optional[Callable[[], None]]]]:
        with self._errors_lock:
            errors, self._errors = self._errors, []
        return errors

    @property
    def in_flight(self) -> int:
        return self._queue.unfinished_tasks

    def close(self) -> None:
        """Drain, then stop and join the thread (errors of queued jobs
        were logged when they failed)."""
        self._closed = True
        thread = self._thread
        if thread is None:
            return
        self._queue.put(None)
        thread.join(timeout=60)
        self._thread = None

    # -- engine thread side ---------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=self._name)
            self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            job, on_error = item
            try:
                job()
            except BaseException as e:  # noqa: B036 — must survive any job failure
                logger.warning(f'KV tier copy job failed: {e!r}')
                with self._errors_lock:
                    self._errors.append((e, on_error))
            finally:
                self._queue.task_done()


def _complete_copy(pending) -> float:
    """Copy-thread side of a spill: wait for the side stream's
    device-to-host copies (pending = (start, end) CUDA events, timed) or
    run the host copy of a CPU arena (pending = a callable).  Returns the
    seconds the copy took."""
    if callable(pending):
        t0 = time.perf_counter()
        pending()
        return time.perf_counter() - t0
    start, end = pending
    end.synchronize()  # the copy thread's wait; skytpu-allow: SKY105
    return start.elapsed_time(end) / 1e3


def _host_tensor(buf, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor of `dtype` from an adopted buffer: a tensor, or a
    numpy array (bfloat16 as its raw 16-bit pattern, or as an ml_dtypes
    array handed over by another package)."""
    if isinstance(buf, torch.Tensor):
        return buf.detach().cpu()  # skytpu-allow: SKY105
    arr = np.ascontiguousarray(buf)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _HostEntry:
    """One host-resident trie-node equivalent: the full token prefix it
    covers (the key), its host rows, and a state: 'spilling' (copy in
    flight, not servable yet), 'host' (resident, prefetchable),
    'fetching' (host -> device copy in flight)."""

    __slots__ = ('key', 'host_ids', 'state', 'last_used')

    def __init__(self, key: Tuple[int, ...], host_ids: List[int]):
        self.key = key
        self.host_ids = host_ids
        self.state = 'spilling'
        self.last_used = 0


class KVTier:
    """Byte-budgeted host block store with async spill and prefetch.

    Host rows mirror the arena's components with the block axis leading:
    (HNB, L, BS, KV, hd) for k/v in the arena's dtype, (HNB, L, BS, KV)
    f32 for int8 scales, so a spilled block round-trips bit for bit.
    Entries are whole trie nodes (``ids_per_node`` blocks); an insert over
    budget evicts the LRU 'host' entry (entries with a copy in flight are
    never victims)."""

    def __init__(self, pool, *, host_bytes: int, ids_per_node: int,
                 tokens_per_node: int, max_pending: int = 2,
                 max_nodes: Optional[int] = None):
        """max_nodes: the longest prefetch chain in trie nodes (a
        prompt's whole-node prefix; None: the host store's capacity),
        which sizes the staging buffers."""
        if ids_per_node < 1:
            raise ValueError(f'ids_per_node must be >= 1, '
                             f'got {ids_per_node}')
        self.pool = pool
        self.ids_per_node = ids_per_node
        self.tokens_per_node = tokens_per_node
        arena = pool.arena
        self.device = arena['k'].device
        self._cuda = self.device.type == 'cuda'
        self.block_nbytes = pool.block_nbytes
        self.node_nbytes = ids_per_node * self.block_nbytes
        self.host_blocks = int(host_bytes // self.block_nbytes)
        if self.host_blocks < ids_per_node:
            raise ValueError(
                f'host tier budget {host_bytes} bytes holds '
                f'{self.host_blocks} host blocks but one trie node '
                f'needs {ids_per_node} (block {self.block_nbytes} '
                f'bytes); raise host_tier_mb to at least '
                f'{ids_per_node * self.block_nbytes / 1024 / 1024:.1f}')
        self.max_chain = self.host_blocks // ids_per_node
        if max_nodes is not None:
            self.max_chain = max(1, min(self.max_chain, max_nodes))
        # One host allocation (pinned for a CUDA arena), carved into the
        # rows of each component and max_pending + 1 staging buffers of
        # max_chain nodes each.
        comps = sorted(arena)
        row_shapes = {c: (arena[c].shape[0],) + tuple(arena[c].shape[2:])
                      for c in comps}
        n_staging = max_pending + 1
        stage_rows = self.max_chain * ids_per_node
        layout = [(('host', c), self.host_blocks) for c in comps] + [
            (('stage', s, c), stage_rows)
            for s in range(n_staging) for c in comps]
        sizes = {}
        total = 0
        for name, rows in layout:
            c = name[-1]
            nbytes = rows * math.prod(row_shapes[c]) * arena[c].element_size()
            sizes[name] = (total, nbytes, rows)
            total += -(-nbytes // _ALIGN) * _ALIGN
        t0 = time.perf_counter()
        if self._cuda:
            buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        else:
            buf = torch.zeros(total, dtype=torch.uint8)
        self.pin_seconds = time.perf_counter() - t0
        self.host_nbytes = total
        views = {name: buf[off:off + nbytes].view(arena[name[-1]].dtype)
                 .view((rows,) + row_shapes[name[-1]])
                 for name, (off, nbytes, rows) in sizes.items()}
        self._host: Dict[str, torch.Tensor] = {c: views['host', c]
                                               for c in comps}
        self._staging = [{c: views['stage', s, c] for c in comps}
                         for s in range(n_staging)]
        self._staging_busy = [False] * n_staging
        self._staging_event: List[Any] = [None] * n_staging
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        # Host-to-device copies whose seconds are not counted yet.
        self._h2d_timing: List[Tuple[Any, Any]] = []
        self._host_free: List[int] = list(
            range(self.host_blocks - 1, -1, -1))
        self._entries: Dict[Tuple[int, ...], _HostEntry] = {}
        self._clock = 0
        # The owning PrefixCache, set by the engine after construction.
        self.prefix = None
        self._engine = AsyncCopyEngine(max_pending=max_pending)
        # Outstanding = submitted jobs not yet drained: a count that
        # depends only on the scheduler's submit/drain sequence.
        self._outstanding = 0
        self._done: List[Tuple[str, Any]] = []
        self._done_lock = threading.Lock()
        self._closed = False
        # Instance mirrors of the skytpu_infer_tier_* registry families.
        self.spills = 0
        self.spill_rejects = 0
        self.spill_bytes = 0
        self.spill_seconds = 0.0
        self.prefetches = 0
        self.prefetch_bytes = 0
        self.prefetch_seconds = 0.0
        self.prefetch_staging_seconds = 0.0
        self.prefetch_h2d_seconds = 0.0
        self.host_evictions = 0
        self.host_hits = 0
        self.device_hits = 0
        self.misses = 0
        self.prefetch_late = 0
        self.adopted = 0
        # The id-vector lengths each device copy ran at: the reference's
        # jit caches of its gather and scatter, one shape each
        # (ids_per_node) when every copy moves one trie node.
        self.copy_shapes: Dict[str, set] = {'gather': set(),
                                            'scatter': set()}
        self._publish()

    # -- introspection ---------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def host_resident_blocks(self) -> int:
        return self.host_blocks - len(self._host_free)

    def can_accept(self) -> bool:
        """True when the bounded engine has a slot for one more copy:
        checked BEFORE allocating blocks or touching the trie, so a
        rejected job has nothing to unwind."""
        return (not self._closed
                and self._outstanding < self._engine.max_pending)

    def in_flight(self) -> bool:
        """True while any copy is submitted but not drained (scheduler
        bookkeeping, not a peek at the live queue)."""
        return self._outstanding > 0

    def record_lookup(self, outcome: str) -> None:
        """Admission's per-request tier consult: 'device_hit',
        'host_hit' (parked on a prefetch) or 'miss'."""
        if outcome == 'device_hit':
            self.device_hits += 1
        elif outcome == 'host_hit':
            self.host_hits += 1
        else:
            self.misses += 1
        telemetry_metrics.INFER_TIER_LOOKUPS.labels(outcome=outcome).inc()

    # -- device pieces (scheduler thread) ----------------------------------
    def _ids(self, ids: Sequence[int], copy: str) -> torch.Tensor:
        ids = list(ids)
        self.copy_shapes[copy].add(len(ids))
        # One synchronizing upload a copy: sanctioned.
        return torch.as_tensor(  # skytpu-allow: SKY105
            ids, dtype=torch.long, device=self.device)

    def _to_host(self, ids: Sequence[int], host_ids: List[int]):
        """Gather the blocks `ids` on the current stream (block-major,
        (n, L, BS, KV, hd) a component) and start their copy into the
        host rows `host_ids`: on the side stream, after the current
        stream's work, as one non-blocking copy a block; returns the
        copy's (start, end) events.  On a CPU arena: a callable that
        makes the copy."""
        idx = self._ids(ids, 'gather')
        gathered = {c: a.transpose(0, 1).index_select(0, idx)
                    for c, a in self.pool.arena.items()}

        def copy_rows():
            for c, g in gathered.items():
                host = self._host[c]
                for i, hid in enumerate(host_ids):
                    host[hid].copy_(g[i], non_blocking=self._cuda)

        if not self._cuda:
            return copy_rows
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record()
            copy_rows()
            end.record()
        for g in gathered.values():
            # The gather was allocated on the current stream: its memory
            # is not reused before the side stream's copy has read it.
            g.record_stream(side)
        return start, end

    def _scatter(self, slot: int, dev_ids: Sequence[int]) -> None:
        """Write staging buffer `slot`'s first len(dev_ids) blocks into
        the arena blocks `dev_ids` in place: host to device on the side
        stream, the current stream waits on that copy's event, then one
        ``index_copy_`` a trie node along the arena's block axis (the
        reference's per-node scatter, at its one shape)."""
        dev_ids = list(dev_ids)
        n = len(dev_ids)
        per = self.ids_per_node
        nodes = [(lo, self._ids(dev_ids[lo:lo + per], 'scatter'))
                 for lo in range(0, n, per)]
        stage = self._staging[slot]
        arena = self.pool.arena
        if not self._cuda:
            for c, a in arena.items():
                for lo, idx in nodes:
                    a.index_copy_(1, idx, stage[c][lo:lo + per]
                                  .transpose(0, 1))
            self._staging_busy[slot] = False
            return
        current = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            staged = {c: stage[c][:n].to(self.device, non_blocking=True)
                      for c in arena}
            end.record()
        current.wait_event(end)
        for c, a in arena.items():
            for lo, idx in nodes:
                a.index_copy_(1, idx, staged[c][lo:lo + per].transpose(0, 1))
            staged[c].record_stream(current)
        self._staging_event[slot] = end
        self._staging_busy[slot] = False
        self._h2d_timing.append((start, end))

    def _take_staging(self) -> int:
        """A staging buffer no prefetch holds, once its last host-to-device
        copy has completed (a host wait on its event, if it has not)."""
        slot = self._staging_busy.index(False)
        event = self._staging_event[slot]
        if event is not None:
            event.synchronize()  # staging reuse; skytpu-allow: SKY105
            self._staging_event[slot] = None
        self._staging_busy[slot] = True
        return slot

    def _settle_timings(self, wait: bool = False) -> None:
        """Count the seconds of host-to-device copies that completed
        (all of them, waiting, with wait=True)."""
        pending = []
        for start, end in self._h2d_timing:
            if wait:
                end.synchronize()  # asked to wait; skytpu-allow: SKY105
            elif not end.query():
                pending.append((start, end))
                continue
            dt = start.elapsed_time(end) / 1e3
            self.prefetch_h2d_seconds += dt
            self.prefetch_seconds += dt
            telemetry_metrics.INFER_TIER_PREFETCH_SECONDS.inc(dt)
        self._h2d_timing = pending

    # -- spill (device -> host) ------------------------------------------
    def accept_spill(self, key: Tuple[int, ...],
                     ids: Sequence[int]) -> bool:
        """Called by ``PrefixCache._drop`` BEFORE it releases the
        victim's arena blocks.  On True the gather over them is already
        enqueued (its output owns the bytes), so the caller releases the
        ids exactly as without a tier.  False = the tier passes (engine
        full, budget unfillable, duplicate key): the bytes are freed and
        forgotten."""
        ids = list(ids)
        if (self._closed or len(ids) != self.ids_per_node
                or not key or key in self._entries
                or not self.can_accept()):
            self.spill_rejects += 1
            return False
        host_ids = self._take_host_rows()
        if host_ids is None:
            self.spill_rejects += 1
            return False
        pending = self._to_host(ids, host_ids)
        entry = _HostEntry(key, host_ids)
        self._entries[key] = entry
        self._touch(entry)
        self._outstanding += 1
        self.spills += 1

        def job():
            dt = _complete_copy(pending)
            with self._done_lock:
                self._done.append(('spill', (entry, dt)))

        def unwind():
            # Failed spill: forget the entry, return its host rows.
            self._entries.pop(key, None)
            self._host_free.extend(host_ids)

        if not self._engine.try_submit(job, on_error=unwind):
            if self._cuda:
                # The rows must not be reused before the copy landed.
                pending[1].synchronize()  # skytpu-allow: SKY105
            unwind()
            self._outstanding -= 1
            self.spills -= 1
            self.spill_rejects += 1
            return False
        return True

    # -- prefetch (host -> device) ---------------------------------------
    def host_continuation(self, tokens: Sequence[int],
                          from_tokens: int) -> List[_HostEntry]:
        """The chain of host-RESIDENT entries extending a device match of
        ``from_tokens`` tokens, capped (like ``PrefixCache.match``) so
        at least one suffix token remains, and at ``max_chain`` nodes.
        'spilling'/'fetching' entries end the chain."""
        toks = tuple(int(t) for t in tokens)
        span = self.tokens_per_node
        max_tokens = max(0, (len(toks) - 1) // span * span)
        out: List[_HostEntry] = []
        depth = from_tokens
        while depth + span <= max_tokens and len(out) < self.max_chain:
            entry = self._entries.get(toks[:depth + span])
            if entry is None or entry.state != 'host':
                break
            out.append(entry)
            depth += span
        return out

    def start_prefetch(self, entries: Sequence[_HostEntry],
                       dev_ids: Sequence[int],
                       nodes: Sequence[Any]) -> None:
        """Begin the host -> device copy of a chain from
        ``host_continuation``: ``dev_ids`` are fresh pool blocks
        (``alloc_for_prefetch``, marked in flight) and ``nodes`` the
        matching 'loading' trie nodes (``PrefixCache.insert_pending``).
        The copy thread fills a staging buffer; the device copy waits for
        ``drain`` on the scheduler thread."""
        if not self.can_accept():
            raise AssertionError(
                'start_prefetch without can_accept(): callers must gate '
                'on it before allocating blocks')
        dev_ids = list(dev_ids)
        if len(dev_ids) != len(entries) * self.ids_per_node or \
                len(nodes) != len(entries) or \
                len(entries) > self.max_chain:
            raise AssertionError(
                f'prefetch shape mismatch: {len(entries)} entries, '
                f'{len(nodes)} nodes, {len(dev_ids)} device ids '
                f'(ids_per_node={self.ids_per_node}, '
                f'max_chain={self.max_chain})')
        for e in entries:
            if e.state != 'host':
                raise AssertionError(
                    f'prefetch of entry in state {e.state!r}')
            e.state = 'fetching'
            self._touch(e)
        entries = list(entries)
        nodes = list(nodes)
        slot = self._take_staging()
        self._outstanding += 1
        self.prefetches += 1

        rows = torch.as_tensor([hid for e in entries for hid in e.host_ids])

        def job():
            t0 = time.perf_counter()
            stage = self._staging[slot]
            for c, host in self._host.items():
                torch.index_select(host, 0, rows, out=stage[c][:len(rows)])
            dt = time.perf_counter() - t0
            with self._done_lock:
                self._done.append(
                    ('prefetch', (entries, dev_ids, nodes, slot, dt)))

        def unwind():
            # Failed prefetch: the bytes never left the host.  Entries
            # stay resident, the loading nodes detach deepest first
            # ('failed' tells parked requests to requeue through the cold
            # path), and the destination blocks return to the pool.
            self._staging_busy[slot] = False
            for e in entries:
                e.state = 'host'
            for n in reversed(nodes):
                n.tier = 'failed'
                if self.prefix is not None:
                    self.prefix.drop_pending(n)
            self.pool.clear_inflight(dev_ids)
            self.pool.release(dev_ids)

        if not self._engine.try_submit(job, on_error=unwind):
            self._outstanding -= 1
            self.prefetches -= 1
            unwind()
            raise AssertionError(
                'copy engine rejected a prefetch after can_accept()')

    # -- handoff (disaggregated serving) ---------------------------------
    def export_gather(self, ids: Sequence[int]) -> Dict[str, torch.Tensor]:
        """One trie node's arena blocks for a prefill -> decode handoff
        image, (L, ids_per_node, BS, KV, hd) a component (scales without
        hd), the JAX package's layout.  A device tensor: the caller
        fetches it through the engine's counted sync."""
        ids = list(ids)
        if len(ids) != self.ids_per_node:
            raise ValueError(
                f'export_gather needs exactly {self.ids_per_node} '
                f'block ids (one trie node), got {len(ids)}')
        idx = self._ids(ids, 'gather')
        return {c: a.index_select(1, idx)
                for c, a in self.pool.arena.items()}

    def has_entry(self, key: Tuple[int, ...]) -> bool:
        return tuple(key) in self._entries

    def adopt_node(self, key: Tuple[int, ...], bufs: Dict[str, Any]
                   ) -> bool:
        """Place one handed-off node's bytes straight into host rows (the
        ingest half of a handoff).  ``bufs`` uses the export layout ((L,
        ids_per_node, ...) a component; host tensors or numpy arrays,
        bfloat16 as its raw bits).  The entry is born 'host': device
        staging then rides the ordinary prefetch (alloc_for_prefetch,
        scatter, splice).  False = duplicate key or no host capacity (the
        decode replica recomputes the prefix)."""
        key = tuple(int(t) for t in key)
        if self._closed or not key or key in self._entries:
            return False
        missing = [c for c in self._host if c not in bufs]
        if missing:
            raise ValueError(f'adopt_node missing components {missing!r}')
        host_ids = self._take_host_rows()
        if host_ids is None:
            return False
        for comp, buf in bufs.items():
            host = self._host[comp]
            t = _host_tensor(buf, host.dtype)
            if t.shape[1] != self.ids_per_node:
                self._host_free.extend(host_ids)
                raise ValueError(
                    f'adopt_node component {comp!r} has {t.shape[1]} '
                    f'blocks, expected {self.ids_per_node}')
            for i, hid in enumerate(host_ids):
                host[hid].copy_(t[:, i])
        entry = _HostEntry(key, host_ids)
        entry.state = 'host'
        self._entries[key] = entry
        self._touch(entry)
        self.adopted += 1
        self._publish()
        return True

    # -- drain (scheduler thread) ----------------------------------------
    def drain(self) -> None:
        """Apply every completed copy: finalize spills (the entry becomes
        prefetchable), scatter completed prefetches into the arena in
        place and flip their trie nodes to 'device'.  Copy-engine errors
        re-raise HERE, on the scheduler thread, after their unwind
        callbacks ran."""
        with self._done_lock:
            done, self._done = self._done, []
        for kind, payload in done:
            self._outstanding -= 1
            if kind == 'spill':
                entry, dt = payload
                entry.state = 'host'
                self._touch(entry)
                self.spill_bytes += self.node_nbytes
                self.spill_seconds += dt
                telemetry_metrics.INFER_TIER_SPILL_BYTES.inc(
                    self.node_nbytes)
                telemetry_metrics.INFER_TIER_SPILL_SECONDS.inc(dt)
                continue
            entries, dev_ids, nodes, slot, dt = payload
            self._scatter(slot, dev_ids)
            for entry, node in zip(entries, nodes):
                node.tier = 'device'
                entry.state = 'host'
                self._touch(entry)
            self.pool.clear_inflight(dev_ids)
            self.prefetch_bytes += len(entries) * self.node_nbytes
            self.prefetch_staging_seconds += dt
            self.prefetch_seconds += dt
            telemetry_metrics.INFER_TIER_PREFETCH_BYTES.inc(
                len(entries) * self.node_nbytes)
            telemetry_metrics.INFER_TIER_PREFETCH_SECONDS.inc(dt)
        errors = self._engine.pop_errors()
        for _, unwind in errors:
            self._outstanding -= 1
            if unwind is not None:
                unwind()
        self._settle_timings()
        self._publish()
        if errors:
            raise errors[0][0]

    def wait_pending(self) -> None:
        """Block until every submitted copy job ran (completions still
        need a ``drain``): the batcher's parked-admission stall."""
        self._engine.wait_until_finished()

    def flush(self) -> None:
        """wait_pending + drain, and the seconds of every host-to-device
        copy counted: the deterministic barrier tests call."""
        self.wait_pending()
        self.drain()
        if self._cuda:
            self._settle_timings(wait=True)

    def close(self) -> None:
        self._closed = True
        self._engine.close()

    # -- internals --------------------------------------------------------
    def _touch(self, entry: _HostEntry) -> None:
        self._clock += 1
        entry.last_used = self._clock

    def _take_host_rows(self) -> Optional[List[int]]:
        """``ids_per_node`` free host rows, LRU-evicting resident
        ('host') entries to make room; None when the budget cannot cover
        it (everything left is in flight)."""
        while len(self._host_free) < self.ids_per_node:
            victim = None
            for e in self._entries.values():
                if e.state != 'host':
                    continue
                if victim is None or e.last_used < victim.last_used:
                    victim = e
            if victim is None:
                return None
            del self._entries[victim.key]
            self._host_free.extend(victim.host_ids)
            self.host_evictions += 1
        return [self._host_free.pop() for _ in range(self.ids_per_node)]

    def _publish(self) -> None:
        telemetry_metrics.INFER_TIER_BLOCKS.labels(tier='host').set(
            self.host_resident_blocks())
        telemetry_metrics.INFER_TIER_BLOCKS.labels(tier='device').set(
            self.pool.live_blocks())
        telemetry_metrics.INFER_TIER_BLOCKS.labels(tier='inflight').set(
            len(self.pool.inflight_blocks()))

    def stats(self) -> Dict[str, Any]:
        lookups = self.host_hits + self.device_hits + self.misses
        return {
            'host_blocks': self.host_blocks,
            'host_resident': self.host_resident_blocks(),
            'entries': len(self._entries),
            'spills': self.spills,
            'spill_rejects': self.spill_rejects,
            'spill_bytes': self.spill_bytes,
            'spill_seconds': self.spill_seconds,
            'prefetches': self.prefetches,
            'prefetch_bytes': self.prefetch_bytes,
            'prefetch_seconds': self.prefetch_seconds,
            'prefetch_staging_seconds': self.prefetch_staging_seconds,
            'prefetch_h2d_seconds': self.prefetch_h2d_seconds,
            'host_evictions': self.host_evictions,
            'host_hits': self.host_hits,
            'device_hits': self.device_hits,
            'misses': self.misses,
            'lookups': lookups,
            'prefetch_late': self.prefetch_late,
            'adopted': self.adopted,
            'host_nbytes': self.host_nbytes,
            'pin_seconds': self.pin_seconds,
        }


def make_kv_tier(gen_config, pool) -> Optional[KVTier]:
    """The host tier from a GeneratorConfig, or None when disabled
    (``host_tier_mb`` unset/0: no host buffers, no copy thread).
    Requires the pooled plane's BlockPool and the prefix cache's block
    granularity (both validated by ``GeneratorConfig``)."""
    mb = getattr(gen_config, 'host_tier_mb', None)
    if not mb or pool is None:
        return None
    return KVTier(
        pool,
        host_bytes=int(float(mb) * 1024 * 1024),
        ids_per_node=gen_config.prefix_block // pool.block_size,
        tokens_per_node=gen_config.prefix_block,
        max_nodes=max(1, (gen_config.max_seq_len - 1)
                      // gen_config.prefix_block))
