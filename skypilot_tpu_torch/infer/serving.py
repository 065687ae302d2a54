"""Continuous batching over the pooled KV arena or the bucketed slot
cache of the legacy decode planes.

Counterpart of the core of skypilot_tpu/infer/serving.py
(``ContinuousBatcher``):

- KV lives in one pooled arena for the process lifetime; each of the
  `batch_size` SLOTS addresses its context through a host-mirrored block
  table, uploaded only when it changes.  Admission reserves a request's
  worst-case block need up front, so pool exhaustion is BACKPRESSURE
  (the request stays queued), never a mid-decode error.
- Queued requests are admitted in GROUPS: one bucketed prefill forward
  covers up to 4 prompts and scatters each row into its slot's blocks.
  Prompts longer than ``prefill_chunk`` prefill one window per tick,
  interleaved with decode.
- Decode runs n-step chunks over ALL slots in lockstep: sampling and
  per-slot EOS/budget tracking stay on the device, so the host sees ONE
  transfer per chunk (``engine.host_fetch``), never one per token.  Done
  and free slots freeze: their lockstep compute rewrites one dead cache
  row (free slots' zeroed table rows route it to the garbage block) and
  emits a fill token the host drops.
- Speculative decoding (``spec_k``): the host n-gram drafter proposes
  spec_k tokens per slot, one verify forward scores the spec_k + 1
  window and the accept step commits the agreeing prefix; rejected rows
  are rolled back by the position cursor alone.  An adaptive policy
  falls back to plain chunks when drafts are rarely accepted.
- Fused steps (``fuse_budget``): while a chunked prompt is in flight and
  slots decode, a chunk of the prompt rides the first forward of the
  decode chunk instead of taking a tick of its own.  Fused ticks do not
  speculate.
- The legacy planes (``decode_impl`` 'paged', 'inplace', 'scan',
  'unroll') keep one contiguous (L, B, S, KV, hd) slot cache instead of
  the arena.  It starts at the smallest cache bucket, grows before an
  admission or a decode chunk would write past it, and shrinks when the
  live contexts fit a smaller bucket and no chunked prefill is parked at
  its last row; each migration is one copy of the cache.  They have no
  speculation and no fused steps.
- Radix prefix cache (``prefix_cache_mb``, infer/prefix_cache.py):
  admission longest-prefix-matches each prompt; a hit splices the
  matched arena blocks into the slot's table (pooled: zero device
  copies; a legacy plane installs them into the slot cache) and prefills
  only the suffix.  A prompt's head joins the trie after its prefill.
- Host KV tier (``host_tier_mb``, infer/kv_tier.py, pooled only):
  evicted trie nodes spill to pinned host rows; a prompt whose head
  continues in the host tier parks while a prefetch brings the blocks
  back, then takes the warm-hit splice.  ``prefetch_hint``,
  ``tier_flush``, ``export_session``/``drain_sessions`` (failover) and
  ``export_handoff``/``ingest_handoff`` (prefill -> decode handoff,
  serve/disagg.py frames the bytes) ride on it.

Where the JAX package jitted each piece and donated the arena, this
module updates the arena and the per-slot device rows in place, in
fixed buffers.  On a CUDA device each chunk that the reference jits is
captured once per static key as a CUDA graph and replayed
(``engine.ChunkGraphs``; ``graphs=False`` runs it eagerly, as on the
CPU): the plain decode chunk per (n, all_greedy, nucleus), led by the
cache length on a legacy plane, the verify step per (all_greedy,
nucleus), and a fused chunk's steps 1..n-1 as the plain chunk of n - 1
(its step 0, which carries the prompt chunk, stays eager).  The arena,
the slot cache and the tables are written in place, never rebound, by
every path (prefix installs, tier scatters and handoff ingests too), so
a captured graph never reads stale memory.

Telemetry, as the reference's: every tick runs under a StepProfiler
(phases admit, prefill, upload, decode, fused, spec_draft, spec_verify,
tier_wait and host_fetch; telemetry/spans.py) whose times feed the
``skytpu_infer_step_phase_seconds`` / ``_utilization`` families, an
optional per-tenant CostLedger (telemetry/accounting.py) and, with
SKYTPU_STEP_TELEMETRY_FILE set, an ``infer_step_phases`` steplog record.
Lifecycle spans (queue_wait, admit, prefill_chunk, decode_chunk,
fused_tick, spec_draft, spec_verify, delivery, the admission.* markers
and handoff.export/ingest) go to a given SpanBuffer, or to the module
buffer when SKYTPU_SPANS or SKYTPU_TIMELINE_FILE is set, keyed by the
trace id bound at submit().  None of it runs inside a captured graph,
and none of it adds a device synchronize: launches are asynchronous, so
a chunk's device time shows in the host_fetch phase that waits for it.
A key's first capture falls inside the phase that launched it
(``graphs.captures``/``capture_seconds`` report captures apart).
Under a tensor-parallel mesh (``mesh=``, infer/tp.py) every rank runs a
batcher over its shards; the pooled steps split the slot rows over 'dp'
and combine over ('tp', 'tpq'), the legacy planes run every slot over a
slot cache of the rank's KV heads with the same combines (K7 per shard
on 'paged'), and ``set_collective_share`` moves the
measured collective share of the sharded phases to the 'collective'
profiler phase.

Usage:

    batcher = ContinuousBatcher(params, config, gen_config)
    rid = batcher.submit([1, 2, 3], max_new_tokens=64)
    while not batcher.is_done(rid):
        batcher.step()
    tokens = batcher.result(rid)
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.infer import block_pool as block_pool_lib
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import fuse as fuse_lib
from skypilot_tpu_torch.infer import kv_tier as kv_tier_lib
from skypilot_tpu_torch.infer import llama_infer, prefix_cache
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.infer import spec_decode as spec_decode_lib
from skypilot_tpu_torch.infer import tp as tp_lib
from skypilot_tpu_torch.infer.engine import GeneratorConfig
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.telemetry import accounting
from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics
from skypilot_tpu_torch.telemetry import spans as spans_lib
from skypilot_tpu_torch.telemetry import steplog
from skypilot_tpu_torch.telemetry import trace as trace_lib

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    # Per-request sampling; None = server default.
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    out: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    # Chunked prefill: prompt tokens already written to the arena.
    prefill_pos: int = 0
    # Fused steps that carried a chunk of this prompt (0: every window
    # ran as a dedicated prefill).
    fused_chunks: int = 0
    # Host clock at submit() and seconds from there to the first token.
    submitted_at: float = 0.0
    ttft_s: Optional[float] = None
    # The trace id bound at submit() (trace.trace_scope) and the submit
    # instant on the span clock, for the queue_wait span.
    trace_id: Optional[str] = None
    submitted_span_at: float = 0.0
    # Cost attribution tag; 'default' when the client named none.
    tenant: str = 'default'


class ContinuousBatcher:
    """Slot-scheduled generation: decode never waits for the batch."""

    def __init__(self, params: llama.Params, config: llama.LlamaConfig,
                 gen_config: GeneratorConfig = GeneratorConfig(),
                 decode_chunk: int = 8, max_queue: Optional[int] = None,
                 device=None, graphs: Optional[bool] = None, mesh=None,
                 span_buffer: Optional[spans_lib.SpanBuffer] = None,
                 span_clock=None,
                 ledger: Optional[accounting.CostLedger] = None,
                 profiler_clock=None):
        """params: as returned by llama.init_params / params_from_numpy,
        on `device` (default: the CUDA card); gen_config.weights_dtype
        'int8' serves a quantized copy of them.

        max_queue: submit() raises PoolExhaustedError (with Retry-After
        advice) once this many requests wait; None = unbounded.

        graphs: replay each decode, verify and fused-tail chunk from a
        CUDA graph captured once per static key (``self.graphs``); None
        = on for a CUDA device, off on the CPU and under a gloo mesh
        (``graphs_off_reason`` says why); False runs every chunk
        eagerly; True where it cannot capture raises.

        mesh: a tensor-parallel mesh (infer/tp.py), on any plane;
        every rank builds its batcher with the same arguments and runs
        the same calls (infer/multihost.py replays the head's).  params
        is then the full tree (each rank keeps its blocks; int8 weights
        are quantized before the cut) or this rank's shards.

        span_buffer/span_clock: lifecycle-span sink and its clock (None:
        the module's wall-clock buffer, gated by spans.enabled()).

        ledger: a telemetry/accounting.py CostLedger that each step's
        exclusive phase seconds are apportioned into (None: nothing is
        recorded).

        profiler_clock: the StepProfiler's clock (None: the host timer,
        time.perf_counter; a tick counter makes the attribution a pure
        function of the schedule)."""
        self.device = resolve_device(device)
        engine_lib.validate_context(gen_config, config)
        if gen_config.prefill_chunk is not None and \
                gen_config.prefill_chunk <= 0:
            raise ValueError(f'prefill_chunk must be positive, got '
                             f'{gen_config.prefill_chunk}')
        if max_queue is not None and max_queue < 1:
            raise ValueError(f'max_queue must be >= 1, got {max_queue}')
        engine_lib.check_mesh(params, config, gen_config, mesh)
        self.mesh = mesh
        self.params = engine_lib.mesh_params(params, config, gen_config,
                                             mesh)
        self.overlap = engine_lib.resolve_overlap(self.params, config,
                                                  gen_config, mesh)
        if mesh is not None:
            for axis, size in mesh.shape.items():
                telemetry_metrics.INFER_MESH_DEVICES.labels(
                    axis=axis).set(size)
        # The measured collective share of the sharded dispatch phases
        # (set_collective_share; None = no 'collective' attribution).
        self._collective_share: Optional[float] = None
        self.config = config
        self.gen = gen_config
        self.decode_chunk = decode_chunk
        self.max_queue = max_queue
        self.buckets = engine_lib.derive_buckets(gen_config)
        self.cache_buckets = engine_lib.derive_cache_buckets(gen_config)

        batch = gen_config.batch_size
        self.pooled = gen_config.decode_impl == 'pooled'
        self.pool = None
        # Legacy-plane bucket migrations over the batcher's lifetime.
        self.migrations = {'grow': 0, 'shrink': 0}
        if self.pooled:
            bs = gen_config.derive_block_size()
            self.block_size = bs
            self.table_width = -(-gen_config.max_seq_len // bs)
            n_blocks = gen_config.pool_blocks
            if n_blocks is None:
                n_blocks = engine_lib.default_pool_blocks(
                    gen_config, config, bs, self.table_width)
            self.pool = block_pool_lib.BlockPool(
                tp_lib.local_config(config, mesh), n_blocks, bs,
                kv_dtype=gen_config.kv_cache_dtype, device=self.device,
                sharded=mesh is not None and mesh.size > 1)
            self._cache = self.pool.arena
            self._cache_len = self.table_width * bs
            self._host_tables = np.zeros((batch, self.table_width),
                                         np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(batch)]
            # Worst-case block ceiling and outstanding reservation per
            # slot.
            self._slot_cap = np.zeros((batch,), np.int32)
            self._slot_reserved = np.zeros((batch,), np.int32)
            # One tables tensor for the batcher's lifetime, rewritten in
            # place (a captured graph reads it at its address); made
            # once, so its synchronizing upload is sanctioned.
            self._tables_dev = torch.as_tensor(  # skytpu-allow: SKY105
                self._host_tables, device=self.device)
            self._tables_dirty = False
        else:
            # Bucketed slot cache: starts at the SMALLEST bucket and
            # migrates as admissions and live contexts cross bucket
            # edges.
            self._decode_fn = llama_infer.get_decode_fn(
                gen_config.decode_impl)
            self._cache_len = self.cache_buckets[0]
            self._cache = llama_infer.init_cache(
                tp_lib.local_config(config, mesh), batch, self._cache_len,
                kv_dtype=gen_config.kv_cache_dtype, device=self.device)

        dev = self.device
        self._token = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self._positions = torch.zeros((batch,), dtype=torch.int32,
                                      device=dev)
        # Done rows FREEZE inside the decode chunk (free slots start
        # done); limit is each active row's remaining token budget.
        self._done = torch.ones((batch,), dtype=torch.bool, device=dev)
        self._limit = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self._temp_row = torch.full((batch,), gen_config.temperature,
                                    dtype=torch.float32, device=dev)
        default_top_p = gen_config.top_p if gen_config.top_p else 1.0
        self._top_p_row = torch.full((batch,), default_top_p,
                                     dtype=torch.float32, device=dev)
        self._host_temp = np.full((batch,), gen_config.temperature,
                                  np.float32)
        self._host_top_p = np.full((batch,), default_top_p, np.float32)
        # Host mirror of _positions, so the scheduler never reads the
        # device rows on the hot path.
        self._host_pos = np.zeros((batch,), np.int64)
        # Noise of sampled (temperature > 0) requests.
        self._rng = torch.Generator(device=dev)
        self._rng.manual_seed(0)
        # The decode carry, read and written in place by every chunk.
        self._rows = (self._token, self._positions, self._done, self._limit)
        self.graphs_off_reason = (engine_lib.graphs_blocker(dev, mesh)
                                  if graphs is None else None)
        self.graphs = engine_lib.chunk_graphs(graphs, dev, (self._rng,),
                                              mesh)

        self._free: List[int] = list(range(batch))
        self._active: Dict[int, _Request] = {}       # slot -> request
        self._requests: Dict[int, _Request] = {}     # rid -> request
        self._queue: List[_Request] = []
        self._ids = itertools.count(1)
        self._admit_group = max(1, min(4, batch))
        # The in-flight chunked prefill (at most one long prompt).
        self._incremental: Optional[_Request] = None
        # Speculative decoding: the host drafter, the policy that gates
        # verify chunks, and the draft scoreboard.
        self._drafter = None
        if gen_config.spec_k:
            self._drafter = spec_decode_lib.NgramDrafter(batch,
                                                         gen_config.spec_k)
            self._spec_policy = spec_decode_lib.SpecPolicy()
            # The drafter's proposals, copied in before each verify step.
            self._draft = torch.zeros((batch, gen_config.spec_k),
                                      dtype=torch.int32, device=dev)
        self.spec_proposed = 0
        self.spec_accepted = 0
        # Radix prefix cache (None = off; block-id mode on the pooled
        # plane) and the host KV tier behind it (None = off: no host
        # buffers, no copy thread).  Requests parked on a prefetch wait in
        # _tier_parked with the trie nodes they wait for; routing hints
        # queue in _tier_hints (bounded: overflow drops the oldest).
        self._prefix = prefix_cache.make_prefix_cache(gen_config,
                                                      pool=self.pool)
        self._tier = None
        self._tier_parked: List[Any] = []
        self._tier_hints: collections.deque = collections.deque(maxlen=256)
        if self.pooled and self._prefix is not None:
            self._tier = kv_tier_lib.make_kv_tier(gen_config, self.pool)
            if self._tier is not None:
                self._tier.prefix = self._prefix
                self._prefix.tier = self._tier
        # Chunked-prefill piggyback: chunk sizing and fuse counters.
        self._fuse_policy = None
        if gen_config.fuse_budget:
            self._fuse_policy = fuse_lib.FusePolicy(gen_config.fuse_budget)
        # Steady decode throughput: real tokens appended by decode, spec
        # and fused chunks and the host seconds those chunks took (each
        # ends in the chunk's one host fetch, so the clock covers device
        # work).
        self.decode_tokens = 0
        self.decode_seconds = 0.0
        # Slot-steps of the plain and fused decode chunks (n x batch a
        # chunk) and those of them in which a slot decoded a token.
        self.slot_steps = 0
        self.live_slot_steps = 0
        # Step-phase attribution (always on: a few host-timer reads a
        # tick) and lifecycle spans (gated: _spans_on()).
        self._profiler = (spans_lib.StepProfiler(profiler_clock)
                          if profiler_clock is not None
                          else spans_lib.StepProfiler())
        self._span_buf = span_buffer
        self._span_clock = span_clock or time.time
        # Per-tenant cost attribution; the retry counter counts admission
        # backpressure.
        self._ledger = ledger
        self.backpressure_retries = 0
        self._ledger_tier_prev = (0.0, 0.0)

    # ---- tracing ---------------------------------------------------------
    def _spans_on(self) -> bool:
        return self._span_buf is not None or spans_lib.enabled()

    def _span(self, name: str, t0: float, t1: float,
              req: Optional[_Request] = None,
              trace_id: Optional[str] = None, **attrs) -> None:
        # Not `or`: an empty SpanBuffer is falsy (__len__ == 0).
        buf = (self._span_buf if self._span_buf is not None
               else spans_lib.default_buffer())
        if req is not None and trace_id is None:
            trace_id = req.trace_id
        buf.record(name, t0, t1, trace_id=trace_id,
                   request_id=req.rid if req is not None else None,
                   **attrs)

    def _fetch(self, *tensors):
        """engine.host_fetch under the host_fetch phase: the blocking
        device -> host copy is where the step waits for the device work
        it dispatched, and is charged to no dispatching phase."""
        with self._profiler.phase('host_fetch'):
            return engine_lib.host_fetch(*tensors)

    def set_collective_share(self, share: Optional[float]) -> None:
        """Install the measured collective-time share of the sharded
        dispatch phases (bench_mesh's collective_time_share_est, or an
        operator's estimate).  While set on a batcher whose mesh has
        more than one rank, each step's decode, spec_verify and fused
        seconds are split and that share moved to the 'collective'
        StepProfiler phase (and INFER_MESH_COLLECTIVE_SECONDS): a host
        timer cannot see inside the device work, so the split is an
        estimate, labelled as one.  None turns it off."""
        if share is not None and not 0.0 <= share <= 1.0:
            raise ValueError(f'collective share must be in [0, 1], '
                             f'got {share}')
        self._collective_share = share

    def _finish_step_profile(self) -> None:
        profiler = self._profiler
        if (self._collective_share and self.mesh is not None
                and self.mesh.size > 1):
            moved = sum(profiler.reattribute(
                src, 'collective', self._collective_share)
                for src in ('decode', 'spec_verify', 'fused'))
            if moved > 0.0:
                telemetry_metrics.INFER_MESH_COLLECTIVE_SECONDS.labels(
                    mode='sync' if self.overlap is None
                    else 'overlapped').inc(moved)
        phases = profiler.finish()
        if not phases:
            return
        wall = profiler.last_wall
        if self._ledger is not None:
            if self.pooled and self._active:
                self._ledger.note_blocks(
                    [(r.rid, r.tenant, len(self._slot_blocks[s]))
                     for s, r in self._active.items()])
            if self._tier is not None:
                stats = self._tier.stats()
                spill = float(stats.get('spill_bytes', 0.0))
                pref = float(stats.get('prefetch_bytes', 0.0))
                p_spill, p_pref = self._ledger_tier_prev
                self._ledger.add_tier_bytes(
                    spill=max(spill - p_spill, 0.0),
                    prefetch=max(pref - p_pref, 0.0))
                self._ledger_tier_prev = (spill, pref)
            self._ledger.end_step(phases, wall)
        for name, seconds in phases.items():
            telemetry_metrics.INFER_STEP_PHASE_SECONDS.labels(
                phase=name).observe(seconds)
            if wall > 0:
                telemetry_metrics.INFER_STEP_UTILIZATION.labels(
                    phase=name).set(seconds / wall)
        if steplog.enabled():
            steplog.write({
                'kind': 'infer_step_phases',
                'wall_s': round(wall, 9),
                'phases': {k: round(v, 9) for k, v in phases.items()},
            })

    # ---- public API ------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               tenant: Optional[str] = None) -> int:
        """temperature/top_p: per-request sampling (None = the server
        defaults in GeneratorConfig), honored per slot.  tenant: the
        cost-attribution tag (None or '' bills 'default').  The trace id
        bound in the caller's context (trace.trace_scope) keys the
        request's spans."""
        if not prompt:
            raise ValueError('Empty prompt')
        if temperature is not None and temperature < 0.0:
            raise ValueError(f'temperature must be >= 0, '
                             f'got {temperature}')
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f'top_p must be in (0, 1], got {top_p}')
        if len(prompt) >= self.gen.max_seq_len:
            raise ValueError(f'Prompt length {len(prompt)} >= max_seq_len '
                             f'{self.gen.max_seq_len}')
        if len(prompt) > self.buckets[-1]:
            raise ValueError(
                f'Prompt length {len(prompt)} exceeds the largest '
                f'prompt bucket {self.buckets[-1]}')
        if self.max_queue is not None and self.num_queued >= self.max_queue:
            retry_s = max(1.0, 0.25 * self.num_queued)
            if self._spans_on():
                now = self._span_clock()
                self._span('admission.backpressure', now, now,
                           trace_id=trace_lib.get_trace_id(),
                           retry_after_s=retry_s)
            raise block_pool_lib.PoolExhaustedError(
                f'Admission queue full ({self.num_queued} waiting, '
                f'max_queue={self.max_queue}); retry later or on '
                f'another replica.',
                retry_after_s=retry_s)
        req = _Request(next(self._ids), list(prompt),
                       min(max_new_tokens,
                           self.gen.max_seq_len - len(prompt)),
                       temperature=temperature, top_p=top_p,
                       submitted_at=time.perf_counter(),
                       trace_id=trace_lib.get_trace_id(),
                       tenant=tenant or 'default')
        if self._spans_on():
            req.submitted_span_at = self._span_clock()
        if self.pooled and self._pool_cap(req) > self.pool.n_blocks - 1:
            # Its worst-case block need exceeds the whole pool: it could
            # never be admitted.
            raise block_pool_lib.PoolExhaustedError(
                f'Request needs {self._pool_cap(req)} blocks '
                f'(prompt {len(req.prompt)} + budget '
                f'{req.max_new_tokens}) but the pool holds only '
                f'{self.pool.n_blocks - 1} allocatable blocks '
                f'(block_size={self.block_size}). Raise '
                f'GeneratorConfig.pool_blocks or shorten the request.')
        self._requests[req.rid] = req
        self._queue.append(req)
        return req.rid

    def is_done(self, rid: int) -> bool:
        return self._requests[rid].done

    def partial(self, rid: int) -> List[int]:
        """Tokens generated so far (a snapshot copy)."""
        return list(self._requests[rid].out)

    def ttft(self, rid: int) -> Optional[float]:
        """Seconds from submit() to the request's first token on the
        host (None before it has one)."""
        return self._requests[rid].ttft_s

    def result(self, rid: int) -> List[int]:
        req = self._requests[rid]
        if not req.done:
            raise ValueError(f'Request {rid} still in flight')
        del self._requests[rid]
        return req.out

    def cancel(self, rid: int) -> List[int]:
        """Abort a request wherever it lives (queued, mid-chunked-
        prefill, or decoding), release everything it holds and forget
        it; returns the tokens generated so far."""
        req = self._requests.get(rid)
        if req is None:
            raise ValueError(f'Unknown request {rid}')
        out = list(req.out)
        if req.done:
            del self._requests[rid]
            return out
        if req in self._queue:
            self._queue.remove(req)
            del self._requests[rid]
            return out
        for i, (parked, _nodes) in enumerate(self._tier_parked):
            if parked is req:
                # Parked on a prefetch: the request just leaves; the copy
                # completes anyway and warms the trie.
                del self._tier_parked[i]
                del self._requests[rid]
                return out
        if self._incremental is req:
            self._incremental = None
            req.prefill_pos = 0
            self._pool_free_slot(req.slot)
            self._free.insert(0, req.slot)
            req.slot = None
            del self._requests[rid]
            return out
        self._finish(req)
        del self._requests[rid]
        return out

    def export_session(self, rid: int) -> Dict[str, Any]:
        """Everything needed to resume this request on another replica:
        re-submit ``prompt + out`` with ``max_new_tokens - len(out)`` and
        greedy decode continues at the first token this replica never
        produced.  The tier state is folded in: a request parked on a
        prefetch (or whose prefix is mid-spill) first settles the copy
        engine, so the ``tier`` block reports the final device/host
        coverage; a copy fault unwinds inside this barrier (logged)
        instead of aborting ``drain_sessions`` halfway."""
        req = self._requests[rid]
        spec = {
            'prompt': list(req.prompt),
            'out': list(req.out),
            'max_new_tokens': req.max_new_tokens,
            'temperature': req.temperature,
            'top_p': req.top_p,
            'done': req.done,
        }
        if self._tier is not None and not req.done:
            if self._tier.in_flight() or self._tier_hints:
                try:
                    self.tier_flush()
                except Exception as e:  # noqa: BLE001 — export must survive copy faults
                    # The failed copy already unwound; the spec below
                    # reflects the state after the unwind.
                    logger.warning(f'export_session: tier fault settled '
                                   f'during the export barrier: {e!r}')
            parked = any(p is req for p, _ in self._tier_parked)
            m = self._prefix.match(req.prompt)
            try:
                host = self._tier.host_continuation(req.prompt, m.tokens)
                spec['tier'] = {
                    'parked': parked,
                    'device_tokens': m.tokens,
                    'host_tokens': len(host) * self._tier.tokens_per_node,
                }
            finally:
                m.release()
        return spec

    def drain_sessions(self) -> List[Dict[str, Any]]:
        """Preemption-notice handoff: between decode chunks, export then
        cancel every in-flight request; returns the session specs (with
        'rid') in submission order.  The batcher is left idle with every
        pool block released."""
        specs = []
        for rid in sorted(self._requests):
            if self._requests[rid].done:
                continue
            spec = self.export_session(rid)
            spec['rid'] = rid
            self.cancel(rid)
            specs.append(spec)
        return specs

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def num_queued(self) -> int:
        # The in-flight chunked prefill and the requests parked on a
        # prefetch count as queued: they are not decoding yet.
        return (len(self._queue) + (1 if self._incremental else 0)
                + len(self._tier_parked))

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f'Prompt length {length} exceeds largest bucket')

    # ---- slot cache (legacy planes) --------------------------------------
    def _migrate(self, target: int) -> None:
        """Resize the slot cache's position axis to `target` rows.  The
        graphs of the old bucket read the old cache: they are dropped."""
        self._cache = engine_lib.migrate_cache(self._cache, self._cache_len,
                                               target, self.migrations)
        self._cache_len = target
        if self.graphs is not None:
            self.graphs.clear()

    def _grow_for(self, rows: int) -> None:
        """Grow (never shrink) the slot cache to cover `rows` positions:
        an admission's prefill writes and its first decode write must
        land inside the cache.  No-op on the pooled plane."""
        if self.pooled:
            return
        target = engine_lib.cache_bucket_for(self.cache_buckets, rows)
        if target > self._cache_len:
            self._migrate(target)

    # ---- host KV tier (infer/kv_tier.py) ---------------------------------
    def prefetch_hint(self, prompt: Sequence[int]) -> bool:
        """Best-effort routing hint, ahead of the request itself: the
        prompt is queued (any thread may call this) and the scheduler
        thread issues the prefetch of its host-resident head at its next
        tick, so the copy overlaps the request's network and queue time.
        True when queued; always False without a tier."""
        if self._tier is None or not prompt:
            return False
        self._tier_hints.append([int(t) for t in prompt])
        return True

    def tier_flush(self) -> None:
        """Tier barrier: wait for every in-flight copy, then apply the
        completions.  A drain can issue new copies (hinted prefetches),
        so it loops until none is outstanding."""
        if self._tier is None:
            return
        while True:
            self._tier.wait_pending()
            self._drain_tier()
            if not self._tier.in_flight():
                self._tier.flush()
                return

    def close(self) -> None:
        """Stop background resources (the tier's copy thread, joined)
        and unlink the tier from the prefix cache (they point at each
        other: the batcher then frees without a cyclic collection).
        Idempotent; host-side state stays readable."""
        if self._tier is not None:
            self._tier.close()
            self._tier.prefix = None
            self._prefix.tier = None

    def _drain_tier(self) -> None:
        """Scheduler-thread tier tick: issue hinted prefetches, apply
        completed copies (the scatter writes the arena in place), and
        requeue parked requests whose blocks landed (front of the queue:
        they re-match as device hits and splice) or whose prefetch
        failed (they prefill cold)."""
        while self._tier_hints:
            try:
                prompt = self._tier_hints.popleft()
            except IndexError:
                break
            m = self._prefix.match(prompt)
            try:
                if not self._prefix.pending_continuation(prompt, m.tokens):
                    self._issue_prefetch(prompt, m)
            finally:
                m.release()
        self._tier.drain()
        if not self._tier_parked:
            return
        ready: List[_Request] = []
        still = []
        for req, nodes in self._tier_parked:
            if all(n.tier == 'device' for n in nodes) or \
                    any(n.tier == 'failed' for n in nodes):
                ready.append(req)
            else:
                still.append((req, nodes))
        if ready:
            self._queue[:0] = ready
            self._tier_parked = still

    def _issue_prefetch(self, prompt: Sequence[int], match):
        """Start a host -> device prefetch of the host-resident chain
        extending ``match``; returns the created 'loading' trie nodes, or
        None when there is nothing to fetch or no capacity (engine busy,
        no surplus pool blocks)."""
        if not self._tier.can_accept():
            return None
        entries = self._tier.host_continuation(prompt, match.tokens)
        if not entries:
            return None
        ids = self.pool.alloc_for_prefetch(
            len(entries) * self._prefix._ids_per_node)
        if ids is None:
            return None
        nodes = self._prefix.insert_pending(
            prompt, match.tokens // self._prefix.block, ids)
        self._tier.start_prefetch(entries, ids, nodes)
        return nodes

    def _tier_try_park(self, idx: int, head: _Request, match) -> bool:
        """Admission's tier consult: when the prompt continues in the
        host tier (or a hinted prefetch of it is in flight), pop the
        request and PARK it until the blocks land, so the copy overlaps
        the other slots' decode.  False: no host continuation; the
        ordinary admission routes proceed."""
        nodes = self._prefix.pending_continuation(head.prompt, match.tokens)
        if not nodes:
            nodes = self._issue_prefetch(head.prompt, match)
        if not nodes:
            return False
        match.release()
        req = self._queue.pop(idx)
        self._tier_parked.append((req, list(nodes)))
        self._tier.record_lookup('host_hit')
        # The request reached admission before its blocks did: this
        # prefetch is LATE (a hint that lands in time makes the lookup a
        # plain device hit).
        self._tier.prefetch_late += 1
        telemetry_metrics.INFER_TIER_PREFETCH_LATE.inc()
        if self._spans_on():
            now = self._span_clock()
            self._span('admission.tier_park', now, now, req=req,
                       blocks=len(nodes) * self._prefix._ids_per_node)
        return True

    # ---- disaggregated prefill/decode handoff (serve/disagg.py) ----------
    def export_handoff(self, prompt: Sequence[int], *,
                       release: bool = True,
                       trace_id: Optional[str] = None
                       ) -> Optional[Dict[str, Any]]:
        """Prefill side of a handoff: the prompt's device-resident prefix
        blocks as host tensors, one dict of components a trie node, (L,
        ids_per_node, BS, KV, hd) each (serve/disagg.py frames them),
        fetched with ONE counted host sync for the whole image.
        ``release=True`` then drops the exported nodes WITHOUT spilling
        (``PrefixCache.forget``): the bytes now live on the decode
        replica.  Returns {'tokens': covered, 'payload': [...]}, or None
        when the prompt has no whole-node device prefix to ship."""
        if self._tier is None or self._prefix is None:
            return None
        toks = [int(t) for t in prompt]
        t0 = self._span_clock() if self._spans_on() else 0.0
        m = self._prefix.match(toks)
        try:
            if not m.tokens or any(n.tier != 'device' for n in m.nodes):
                return None
            comps = sorted(self.pool.arena)
            gathered = [self._tier.export_gather(n.data) for n in m.nodes]
            # bf16 crosses as its bits (numpy has no bfloat16).
            flat = self._fetch(*[
                g[c].view(torch.int16) if g[c].dtype == torch.bfloat16
                else g[c] for g in gathered for c in comps])
            payload: List[Dict[str, Any]] = []
            for i, g in enumerate(gathered):
                payload.append({
                    c: (torch.from_numpy(flat[i * len(comps) + j]).view(
                        g[c].dtype)) for j, c in enumerate(comps)})
            covered = m.tokens
        finally:
            m.release()
        if release:
            self._prefix.forget(toks[:covered], spill=False)
        if self._spans_on():
            self._span('handoff.export', t0, self._span_clock(),
                       trace_id=trace_id, tokens=covered,
                       nodes=len(payload))
        return {'tokens': covered, 'payload': payload}

    def ingest_handoff(self, prompt: Sequence[int],
                       payload: Sequence[Dict[str, Any]], *,
                       trace_id: Optional[str] = None) -> int:
        """Decode side of a handoff: adopt each node's bytes into the
        host tier (``KVTier.adopt_node``, no device work here), then
        queue a prefetch hint, so the ordinary tier machinery stages the
        blocks and the request's admission takes the warm splice.
        Returns the node count adopted (already-resident nodes count; a
        full host tier ends the chain, and the suffix recomputes)."""
        if self._tier is None:
            return 0
        toks = [int(t) for t in prompt]
        span = self._prefix.block
        t0 = self._span_clock() if self._spans_on() else 0.0
        adopted = 0
        for i, bufs in enumerate(payload):
            key = tuple(toks[:(i + 1) * span])
            if len(key) < (i + 1) * span:
                break
            if self._tier.has_entry(key):
                adopted += 1
                continue
            if not self._tier.adopt_node(key, bufs):
                break
            adopted += 1
        if adopted:
            self.prefetch_hint(toks)
        if self._spans_on():
            self._span('handoff.ingest', t0, self._span_clock(),
                       trace_id=trace_id, nodes=adopted)
        return adopted

    # ---- pool helpers ----------------------------------------------------
    def _pool_cap(self, req: _Request) -> int:
        """Worst-case blocks the request can ever reference: prompt plus
        its full token budget, plus spec_k rows of verify-window slack
        when speculation is on (the window writes candidate K/V at rows
        pos..pos+k before knowing how many commit), capped at the table
        width."""
        slack = self.gen.spec_k if self._drafter is not None else 0
        total = min(len(req.prompt) + req.max_new_tokens + slack,
                    self.gen.max_seq_len)
        return min(-(-total // self.block_size), self.table_width)

    # Each _pool_* helper is a no-op off the pooled plane (no arena).
    def _pool_reserve(self, req: _Request, shared: int = 0) -> bool:
        """Claim the request's worst-case block need before it leaves the
        queue, minus the `shared` blocks a prefix hit brings for free;
        failure is admission backpressure (the prefix cache is pressed
        to evict unreferenced nodes first)."""
        if not self.pooled:
            return True
        need = self._pool_cap(req) - shared
        if need > self.pool.available() and self._prefix is not None:
            self._prefix.evict_for_pool(need)
        return self.pool.reserve(need)

    def _pool_bind_slot(self, req: _Request,
                        shared_ids: Sequence[int] = ()) -> None:
        """Give an admitted request's slot its prompt blocks: the prefix's
        shared head ids first (already refcount-bumped by splice), then
        fresh blocks drawn from its admission reservation."""
        if not self.pooled:
            return
        slot = req.slot
        cap = self._pool_cap(req)
        nb_prompt = min(-(-len(req.prompt) // self.block_size),
                        self.table_width)
        shared = len(shared_ids)
        self._host_tables[slot, :shared] = shared_ids
        fresh = self.pool.alloc(nb_prompt - shared, from_reservation=True)
        self._host_tables[slot, shared:nb_prompt] = fresh
        self._slot_blocks[slot] = list(shared_ids) + list(fresh)
        self._slot_cap[slot] = cap
        self._slot_reserved[slot] = cap - nb_prompt
        self._tables_dirty = True

    def _pool_free_slot(self, slot: int) -> None:
        """Drop a slot's block references, return its unused reservation
        and zero its table row, so its frozen lockstep write lands in
        the garbage block."""
        if not self.pooled:
            return
        if self._slot_blocks[slot]:
            self.pool.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
        if self._slot_reserved[slot]:
            self.pool.unreserve(int(self._slot_reserved[slot]))
        self._slot_reserved[slot] = 0
        self._slot_cap[slot] = 0
        self._host_tables[slot] = 0
        self._tables_dirty = True

    def _ensure_slot_blocks(self, n: int) -> None:
        """Grow each active slot's table to cover this chunk's deepest
        possible write (position + n - 1), capped at its reserved worst
        case; draws the reservation down, so it cannot exhaust the pool
        mid-decode."""
        for slot in self._active:
            need = -(-(int(self._host_pos[slot]) + n) // self.block_size)
            need = min(need, int(self._slot_cap[slot]))
            have = len(self._slot_blocks[slot])
            if need > have:
                ids = self.pool.alloc(need - have, from_reservation=True)
                self._host_tables[slot, have:need] = ids
                self._slot_blocks[slot].extend(ids)
                self._slot_reserved[slot] -= need - have
                self._tables_dirty = True

    def _upload_tables(self) -> None:
        if self._tables_dirty:
            with self._profiler.phase('upload'):
                self._tables_dev.copy_(torch.from_numpy(self._host_tables))
            self._tables_dirty = False

    # ---- device pieces ---------------------------------------------------
    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                top_ps: np.ndarray, temp_t: torch.Tensor,
                top_p_t: torch.Tensor) -> torch.Tensor:
        """Sample first tokens; the host arrays pick the greedy argmax
        when every row is greedy (no noise drawn)."""
        if not np.any(temps > 0.0):
            return sampling.sample_logits(logits, temperature=0.0)
        return sampling.sample_logits_batched(
            logits, self._rng, temp_t, top_p_t, top_k=self.gen.top_k)

    def _install_rows(self, slots: torch.Tensor, firsts: torch.Tensor,
                      lengths: torch.Tensor, limits: torch.Tensor,
                      temps: torch.Tensor, top_ps: torch.Tensor) -> None:
        """Install freshly prefilled slots' decode rows in place.  A
        request can finish ON its first token (eos, or a 1-token
        budget): its slot enters the decode loop already frozen."""
        eos = self.gen.eos_token
        first_done = limits <= 0
        if eos is not None:
            first_done = first_done | (firsts == eos)
        self._token[slots] = firsts
        self._positions[slots] = lengths
        self._done[slots] = first_done
        self._limit[slots] = limits
        self._temp_row[slots] = temps
        self._top_p_row[slots] = top_ps

    def _prefill_group(self, tokens: np.ndarray, lengths: np.ndarray,
                       slots: np.ndarray,
                       tables_scatter: Optional[np.ndarray],
                       temps: np.ndarray, top_ps: np.ndarray,
                       limits: np.ndarray) -> torch.Tensor:
        """Prefill a GROUP of prompts (G, bucket) in one forward into a
        scratch cache, move each row into its slot in place (pooled: its
        arena blocks, tables_scatter (G, nb); legacy: the slot cache's
        row, the scratch at the cache's current length), sample the first
        tokens and install the slots' rows.  Returns the first tokens
        (device)."""
        dev = self.device
        rows = (self._cache_len if tables_scatter is None
                else tables_scatter.shape[1] * self.block_size)
        scratch = llama_infer.init_cache(
            tp_lib.local_config(self.config, self.mesh), tokens.shape[0],
            rows, kv_dtype=self.gen.kv_cache_dtype, device=dev)
        # The group's host arrays go up as synchronizing uploads (the
        # host waits for the stream), once an admission: sanctioned.
        lengths_t = torch.as_tensor(  # skytpu-allow: SKY105
            lengths, device=dev)
        tokens_t = torch.as_tensor(tokens, device=dev)  # skytpu-allow: SKY105
        logits, scratch = llama_infer.prefill(
            self.params, tokens_t, self.config, scratch, lengths_t,
            mesh=self.mesh)
        slots_t = torch.as_tensor(  # skytpu-allow: SKY105
            slots, device=dev).long()
        if tables_scatter is None:
            for key, small in scratch.items():   # k/v (+ int8 scales)
                self._cache[key][:, slots_t] = small
        else:
            scatter_t = torch.as_tensor(  # skytpu-allow: SKY105
                tables_scatter, device=dev)
            llama_infer.scatter_prefill_pooled(scratch, self._cache,
                                               scatter_t)
        temps_t = torch.as_tensor(temps, device=dev)  # skytpu-allow: SKY105
        top_ps_t = torch.as_tensor(top_ps, device=dev)  # skytpu-allow: SKY105
        limits_t = torch.as_tensor(limits, device=dev)  # skytpu-allow: SKY105
        firsts = self._sample(logits, temps, top_ps, temps_t, top_ps_t)
        self._install_rows(slots_t, firsts, lengths_t, limits_t, temps_t,
                           top_ps_t)
        return firsts

    def _sample_step(self, logits: torch.Tensor, all_greedy: bool,
                     nucleus: bool) -> torch.Tensor:
        """In-loop sampling of a decode step (all_greedy draws no
        noise)."""
        if all_greedy:
            return sampling.sample_logits(logits, temperature=0.0)
        return sampling.sample_logits_batched(
            logits, self._rng, self._temp_row, self._top_p_row,
            top_k=self.gen.top_k, nucleus=nucleus)

    def _decode_steps(self, n: int, all_greedy: bool,
                      nucleus: bool) -> torch.Tensor:
        """n plain lockstep decode steps from the fixed rows, with
        on-device sampling and per-slot EOS/budget tracking; no host
        sync inside, so a graph can capture it.  Done slots freeze
        (position and feed token stop advancing) and emit the fill
        token.  Writes the rows and the cache in place; returns the
        (n, B) token block."""
        eos = self.gen.eos_token
        fill = eos if eos is not None else 0
        token, positions, done, limit = self._rows
        toks = []
        for _ in range(n):
            if self.pooled:
                logits, _ = llama_infer.decode_step_pooled(
                    self.params, token, self.config, self._cache,
                    positions, self._tables_dev, mesh=self.mesh,
                    overlap=self.overlap)
            else:
                logits, _ = self._decode_fn(self.params, token, self.config,
                                            self._cache, positions,
                                            mesh=self.mesh)
            emit, token, positions, done, limit = engine_lib.commit_step(
                self._sample_step(logits, all_greedy, nucleus), token,
                positions, done, limit, eos=eos, fill=fill)
            toks.append(emit)
        engine_lib.store_rows(self._rows, (token, positions, done, limit))
        return torch.stack(toks)

    def _chunk_key(self, n: int, all_greedy: bool, nucleus: bool):
        """The static arguments of a plain decode chunk, as the
        reference's jit of ``_decode``: (n, all_greedy, nucleus), led by
        the cache length on a legacy plane (one program per bucket)."""
        key = (n, all_greedy, nucleus)
        return key if self.pooled else (self._cache_len,) + key

    def _decode(self, n: int, all_greedy: bool, nucleus: bool,
                prefill_lane=None):
        """An n-step decode chunk over the fixed rows (_decode_steps),
        replayed from its graph when graphs are on.

        prefill_lane: (pf_tokens, pf_table_row, pf_start) makes step 0
        the fused forward (llama_infer.fused_step_pooled) that also
        carries a chunk of the in-flight prompt; it runs eagerly (its
        start row is a host int and its table row changes from tick to
        tick) and leaves its carry in the fixed rows, and steps 1..n-1
        are the plain chunk of n - 1.
        Returns (the (n, B) token block, the chunk's hiddens or None)."""
        blocks, h_pf = [], None
        if prefill_lane is not None:
            logits, h_pf, _ = llama_infer.fused_step_pooled(
                self.params, self._token, self.config, self._cache,
                self._positions, self._tables_dev, *prefill_lane,
                mesh=self.mesh, overlap=self.overlap)
            eos = self.gen.eos_token
            emit, *carry = engine_lib.commit_step(
                self._sample_step(logits, all_greedy, nucleus), *self._rows,
                eos=eos, fill=eos if eos is not None else 0)
            engine_lib.store_rows(self._rows, carry)
            blocks.append(emit[None])
            n -= 1
        if n:
            blocks.append(engine_lib.run_chunk(
                self.graphs, ('decode',) + self._chunk_key(n, all_greedy,
                                                           nucleus),
                lambda: self._decode_steps(n, all_greedy, nucleus)))
        return (blocks[0] if len(blocks) == 1 else torch.cat(blocks)), h_pf

    def _verify_step(self, all_greedy: bool, nucleus: bool):
        """The speculative chunk's device work over the fixed rows and
        draft buffer: score the spec_k + 1 window (last committed token +
        the drafter's proposals) in ONE forward, then commit each slot's
        accepted prefix with the sequential chunk's per-token semantics.
        Rejected rows are cursor rollback: positions never advance over
        them.  Writes the rows in place; returns (emitted (B, W),
        committed (B,))."""
        tokens_w = torch.cat([self._token[:, None], self._draft], dim=1)
        logits, _ = llama_infer.decode_verify_pooled(
            self.params, tokens_w, self.config, self._cache,
            self._positions, self._tables_dev, mesh=self.mesh,
            overlap=self.overlap)
        if all_greedy:
            targets, accepts = sampling.spec_accept_greedy(logits,
                                                           self._draft)
        else:
            targets, accepts = sampling.spec_accept_sampled(
                logits, self._draft, self._rng, self._temp_row,
                self._top_p_row, top_k=self.gen.top_k, nucleus=nucleus)
        eos = self.gen.eos_token
        (emitted, token, positions, done, limit,
         committed) = spec_decode_lib.accept_window(
            targets, accepts, self._done, self._limit, self._positions,
            self._token, eos=eos, fill=eos if eos is not None else 0)
        engine_lib.store_rows(self._rows, (token, positions, done, limit))
        return emitted, committed

    def _verify(self, draft: np.ndarray, all_greedy: bool, nucleus: bool):
        """One verify chunk on the drafter's (B, spec_k) proposals,
        replayed from its graph (key (all_greedy, nucleus)) when graphs
        are on.  Returns (emitted (B, W), committed (B,))."""
        self._draft.copy_(torch.from_numpy(draft))
        return engine_lib.run_chunk(
            self.graphs, ('verify', all_greedy, nucleus),
            lambda: self._verify_step(all_greedy, nucleus))

    # ---- scheduling ------------------------------------------------------
    def _request_sampling(self, req: _Request):
        default_top_p = self.gen.top_p if self.gen.top_p else 1.0
        temp = (self.gen.temperature if req.temperature is None
                else req.temperature)
        top_p = default_top_p if req.top_p is None else req.top_p
        return temp, top_p

    def _record_first(self, req: _Request, token: int) -> None:
        req.out.append(token)
        req.ttft_s = time.perf_counter() - req.submitted_at

    def _reset_drafter(self, req: _Request) -> None:
        """Seed the slot's drafter with the prompt, the trie's cached
        continuation of it (tokens another request already decoded after
        the shared head), and the first token."""
        if self._drafter is not None:
            cont = (self._prefix.cached_continuation(
                req.prompt, self.gen.max_seq_len)
                if self._prefix is not None else ())
            self._drafter.reset(req.slot, req.prompt, cont)
            self._drafter.observe(req.slot, req.out[-1:])

    def _sampling_mode(self):
        """(all_greedy, nucleus) of the active slots, from the host
        mirrors."""
        all_greedy = not any(float(self._host_temp[s]) > 0.0
                             for s in self._active)
        nucleus = any(float(self._host_top_p[s]) < 1.0
                      for s in self._active)
        return all_greedy, nucleus

    def _observe_chunk(self, prev_pos, host: np.ndarray) -> None:
        """Feed the drafter each active slot's committed tokens of a
        sequential chunk: the first (new - old position) entries of its
        row (fill follows once the lane froze)."""
        if prev_pos is None:
            return
        for slot in list(self._active):
            delta = int(self._host_pos[slot]) - prev_pos[slot]
            if delta > 0:
                self._drafter.observe(slot,
                                      [int(t) for t in host[slot, :delta]])

    def _absorb(self, host: np.ndarray, counts=None) -> int:
        """Append each active slot's fetched tokens (the first counts[slot]
        of its row when given) to its request, finishing it on EOS or
        its budget.  Returns the tokens appended."""
        eos = self.gen.eos_token
        appended = 0
        for slot, req in list(self._active.items()):
            row = host[slot] if counts is None else \
                host[slot, :int(counts[slot])]
            absorbed = 0
            for t in row:
                req.out.append(int(t))
                absorbed += 1
                if (eos is not None and req.out[-1] == eos) or \
                        len(req.out) >= req.max_new_tokens:
                    self._finish(req)
                    break
            if self._ledger is not None and absorbed:
                self._ledger.add_tokens(req.rid, req.tenant, decode=absorbed)
            appended += absorbed
        self.decode_tokens += appended
        telemetry_metrics.INFER_GENERATED_TOKENS.inc(appended)
        telemetry_metrics.INFER_HOST_SYNCS_PER_TOKEN.set(
            1.0 / max(appended, 1))
        telemetry_metrics.INFER_SLOT_OCCUPANCY.set(
            len(self._active) / self.gen.batch_size)
        return appended

    def _observe_queue_wait(self, req: _Request) -> None:
        if req.submitted_at:
            telemetry_metrics.INFER_QUEUE_WAIT_SECONDS.observe(
                time.perf_counter() - req.submitted_at)
        if self._spans_on() and req.submitted_span_at:
            self._span('queue_wait', req.submitted_span_at,
                       self._span_clock(), req=req)

    def _backpressure_retry(self, req: _Request) -> None:
        """Count (and mark) one admission that pool backpressure left
        queued."""
        self.backpressure_retries += 1
        if self._spans_on():
            now = self._span_clock()
            self._span('admission.backpressure_retry', now, now, req=req)

    def _admit(self) -> None:
        """Move queued requests into free slots: groups of up to
        _admit_group same-bucket requests prefill in ONE forward.
        Scanning is by index, so while one long chunked prefill is in
        flight, shorter requests behind it still admit into the other
        free slots.  With the prefix cache, each candidate is matched
        first: a hit splices (or installs) the cached head and prefills
        only the suffix (_admit_prefix_hit), and a long prompt whose
        unmatched suffix fits prefill_chunk takes that route instead of
        the one chunked lane; with the host tier, a prompt whose head
        continues in host memory parks on a prefetch."""
        eos = self.gen.eos_token
        chunk_w = self.gen.prefill_chunk
        idx = 0
        while self._free and idx < len(self._queue):
            head = self._queue[idx]
            match = (self._prefix.match(head.prompt)
                     if self._prefix is not None else None)
            if self._tier is not None and \
                    self._tier_try_park(idx, head, match):
                continue   # parked (match released); idx is the next one
            suffix = len(head.prompt) - (match.tokens if match else 0)
            if chunk_w and suffix > chunk_w:
                if self._incremental is not None:
                    # One long prefill in flight: keep the queue
                    # position, scan on.
                    if match is not None:
                        match.release()
                    idx += 1
                    continue
                shared = (match.tokens // self.block_size
                          if self.pooled and match is not None else 0)
                if not self._pool_reserve(head, shared):
                    # Pool backpressure: the same, counted.
                    if match is not None:
                        match.release()
                    self._backpressure_retry(head)
                    idx += 1
                    continue
                request = self._queue.pop(idx)
                request.slot = self._free.pop(0)
                self._observe_queue_wait(request)
                self._incremental = request
                # Grow BEFORE parking: the windows write rows
                # 0..len(prompt)-1 and the first decode write lands at
                # len(prompt).  (The cache does not shrink while this
                # prefill is in flight: see _decode_chunk.)
                self._grow_for(len(request.prompt) + 1)
                ids: List[int] = []
                if match is not None:
                    self._prefix.commit(match)
                    if self._tier is not None:
                        self._tier.record_lookup(
                            'device_hit' if match.hit else 'miss')
                    if match.hit:
                        # The matched head is in place before the first
                        # window: spliced (pooled) or installed (legacy).
                        if self.pooled:
                            ids = self._prefix.splice(match)
                        else:
                            self._prefix.install(self._cache, request.slot,
                                                 match)
                        request.prefill_pos = match.tokens
                    match.release()
                self._pool_bind_slot(request, ids)
                # Park the slot's frozen position at the last cache row:
                # the lockstep decode still rewrites a frozen slot's
                # CURRENT row, and row 0 would clobber the rows this
                # prefill writes.  The park row is >= len(prompt), so a
                # real decode write overwrites it before it is attended.
                park = self._cache_len - 1
                self._positions[request.slot] = park
                self._host_pos[request.slot] = park
                if self._spans_on():
                    now = self._span_clock()
                    self._span('admit', now, now, req=request,
                               mode='chunked')
                if self._ledger is not None:
                    self._ledger.charge_request('admit', request.rid,
                                                request.tenant)
                continue
            if match is not None and match.hit:
                if not self._pool_reserve(
                        head, match.tokens // self.block_size
                        if self.pooled else 0):
                    match.release()
                    self._backpressure_retry(head)
                    idx += 1
                    continue
                if self._tier is not None:
                    self._tier.record_lookup('device_hit')
                self._admit_prefix_hit(self._queue.pop(idx), match)
                continue
            if match is not None:
                self._prefix.commit(match)    # a counted miss
                match.release()
                if self._tier is not None:
                    self._tier.record_lookup('miss')
            if not self._pool_reserve(head):
                self._backpressure_retry(head)
                idx += 1
                continue
            bucket = self._bucket_for(len(head.prompt))
            group = [self._queue.pop(idx)]
            group[0].slot = self._free.pop(0)
            self._observe_queue_wait(group[0])
            while (idx < len(self._queue) and self._free
                   and len(group) < self._admit_group):
                cand = self._queue[idx]
                if self._bucket_for(len(cand.prompt)) != bucket or \
                        (chunk_w and len(cand.prompt) > chunk_w):
                    break
                if self._prefix is not None:
                    # A hit ends the group: the outer loop takes it next.
                    m = self._prefix.match(cand.prompt)
                    if m.hit:
                        m.release()
                        break
                    self._prefix.commit(m)
                    m.release()
                if not self._pool_reserve(cand):
                    break
                cand = self._queue.pop(idx)
                cand.slot = self._free.pop(0)
                self._observe_queue_wait(cand)
                group.append(cand)
            size = len(group)
            tokens = np.zeros((size, bucket), np.int32)
            lengths = np.ones((size,), np.int32)
            slots = np.zeros((size,), np.int32)
            temps = np.zeros((size,), np.float32)
            top_ps = np.ones((size,), np.float32)
            limits = np.zeros((size,), np.int32)
            for i, request in enumerate(group):
                tokens[i, :len(request.prompt)] = request.prompt
                lengths[i] = len(request.prompt)
                slots[i] = request.slot
                temps[i], top_ps[i] = self._request_sampling(request)
                # Budget AFTER the first token the prefill samples.
                limits[i] = request.max_new_tokens - 1
            # The (G, bucket) prefill writes rows 0..bucket-1 and each
            # row's first decode write lands at len(prompt).
            admit_t0 = self._span_clock() if self._spans_on() else 0.0
            self._grow_for(max(bucket, int(lengths.max()) + 1))
            try:
                tables_scatter = None
                if self.pooled:
                    # Each row claims the blocks of ITS prompt; the
                    # bucket's remaining block columns point at the
                    # garbage block.
                    nb = -(-bucket // self.block_size)
                    tables_scatter = np.full(
                        (size, nb), block_pool_lib.GARBAGE_BLOCK, np.int32)
                    for i, request in enumerate(group):
                        self._pool_bind_slot(request)
                        row = self._slot_blocks[request.slot]
                        tables_scatter[i, :len(row)] = row
                with self._profiler.phase('prefill'):
                    firsts = self._prefill_group(tokens, lengths, slots,
                                                 tables_scatter, temps,
                                                 top_ps, limits)
                self._host_temp[slots] = temps
                self._host_top_p[slots] = top_ps
            except Exception:
                # A failed dispatch must not leak the group: re-queue
                # the requests at their scan position and return their
                # slots and pool state, THEN surface the error.
                for request in reversed(group):
                    self._pool_free_slot(request.slot)
                    self._free.insert(0, request.slot)
                    request.slot = None
                    self._queue.insert(idx, request)
                raise
            # The freshly prefilled heads join the trie for the next
            # request sharing them.
            for req in group:
                self._prefix_insert(req)
            # ONE counted sync for the whole admitted group.
            (firsts,) = self._fetch(firsts)
            if self._spans_on():
                now = self._span_clock()
                for req in group:
                    self._span('admit', admit_t0, now, req=req,
                               mode='cold', group=size)
                    self._span('prefill_chunk', admit_t0, now, req=req,
                               start=0, end=len(req.prompt))
            if self._ledger is not None:
                for req in group:
                    self._ledger.charge_request('admit', req.rid,
                                                req.tenant)
                    self._ledger.charge_request('prefill', req.rid,
                                                req.tenant)
                    self._ledger.add_tokens(req.rid, req.tenant,
                                            prefill=len(req.prompt))
            for i, req in enumerate(group):
                self._host_pos[req.slot] = len(req.prompt)
                self._record_first(req, int(firsts[i]))
                self._reset_drafter(req)
                if (eos is not None and req.out[-1] == eos) or \
                        len(req.out) >= req.max_new_tokens:
                    self._finish(req)
                else:
                    self._active[req.slot] = req

    def _prefix_insert(self, req: _Request) -> None:
        """Insert a freshly prefilled prompt's head blocks into the trie:
        pooled, new nodes SHARE the slot's own blocks (refcount bumps);
        legacy, blocks not cached yet are copied out of the slot rows.
        No-op without a prefix cache."""
        if self._prefix is None:
            return
        if self.pooled:
            self._prefix.insert(req.prompt,
                                blocks=self._slot_blocks[req.slot])
        else:
            self._prefix.insert(req.prompt, functools.partial(
                self._prefix.extract, self._cache, req.slot))

    def _admit_prefix_hit(self, req: _Request,
                          match: prefix_cache.PrefixMatch) -> None:
        """Admit one prefix-HIT request: the matched head splices into
        the slot's table (pooled: zero device copies) or installs into
        its cache rows (legacy), only the suffix prefills, in
        prefill_chunk windows (prefix_block without chunking), and the
        first token's fetch is the one host sync, as on every admission
        route."""
        req.slot = self._free.pop(0)
        self._observe_queue_wait(req)
        hit_t0 = self._span_clock() if self._spans_on() else 0.0
        shared_tokens = match.tokens
        self._prefix.commit(match)
        prompt = req.prompt
        # The head and the suffix windows write rows 0..len(prompt)-1 and
        # the first decode write lands at len(prompt).
        self._grow_for(len(prompt) + 1)
        w = self.gen.prefill_chunk or self._prefix.block
        start = match.tokens
        dev = self.device
        try:
            if self.pooled:
                try:
                    ids = self._prefix.splice(match)
                finally:
                    match.release()
                self._pool_bind_slot(req, ids)
                # Once an admission (sanctioned synchronizing upload).
                table_row = torch.as_tensor(  # skytpu-allow: SKY105
                    self._host_tables[req.slot], device=dev)
            else:
                try:
                    self._prefix.install(self._cache, req.slot, match)
                finally:
                    match.release()
            h_last = None
            last_start = start
            while start < len(prompt):
                end = min(start + w, len(prompt))
                window = np.zeros((w,), np.int32)
                window[:end - start] = prompt[start:end]
                w0 = self._span_clock() if self._spans_on() else 0.0
                with self._profiler.phase('prefill'):
                    # One synchronizing upload a window: sanctioned.
                    window_t = torch.as_tensor(  # skytpu-allow: SKY105
                        window, device=dev)
                    if self.pooled:
                        h_last, _ = llama_infer.prefill_window_pooled(
                            self.params, window_t, self.config,
                            self._cache, table_row, start, mesh=self.mesh)
                    else:
                        h_last, _ = llama_infer.prefill_window(
                            self.params, window_t, self.config,
                            self._cache, req.slot, start, mesh=self.mesh)
                if self._spans_on():
                    self._span('prefill_chunk', w0, self._span_clock(),
                               req=req, start=start, end=end)
                last_start = start
                start = end
            if self.pooled:
                # Share into the trie BEFORE completion: a 1-token budget
                # finishes inside _complete_prefill, whose _finish drops
                # the slot's references.
                self._prefix_insert(req)
            self._complete_prefill(req, h_last, last_start)
            if self._spans_on():
                self._span('admit', hit_t0, self._span_clock(), req=req,
                           mode='prefix_hit', shared_tokens=shared_tokens)
            if self._ledger is not None:
                self._ledger.charge_request('admit', req.rid, req.tenant)
                self._ledger.charge_request('prefill', req.rid, req.tenant)
                self._ledger.add_tokens(req.rid, req.tenant,
                                        prefill=len(prompt) - shared_tokens)
        except Exception:
            # Reclaim the slot and re-queue before surfacing the error.
            self._pool_free_slot(req.slot)
            self._free.insert(0, req.slot)
            req.slot = None
            self._queue.insert(0, req)
            raise
        if not self.pooled:
            self._prefix_insert(req)

    def _complete_prefill(self, req: _Request, h_last: torch.Tensor,
                          last_start: int) -> None:
        """Finish a chunked prefill: logits at the prompt's last window
        row -> first token -> install the slot's decode rows; one counted
        host sync."""
        temp, top_p = self._request_sampling(req)
        dev = self.device
        with self._profiler.phase('prefill'):
            h = h_last[len(req.prompt) - 1 - last_start][None]
            logits = llama_infer.logits(h, self.params, self.mesh)
            temps = np.asarray([temp], np.float32)
            top_ps = np.asarray([top_p], np.float32)
            # The slot's rows go up as synchronizing uploads, once a
            # request: sanctioned.
            temps_t = torch.as_tensor(  # skytpu-allow: SKY105
                temps, device=dev)
            top_ps_t = torch.as_tensor(  # skytpu-allow: SKY105
                top_ps, device=dev)
            first = self._sample(logits, temps, top_ps, temps_t, top_ps_t)
            slot_t = torch.as_tensor(  # skytpu-allow: SKY105
                [req.slot], device=dev)
            length_t = torch.as_tensor(  # skytpu-allow: SKY105
                [len(req.prompt)], dtype=torch.int32, device=dev)
            limit_t = torch.as_tensor(  # skytpu-allow: SKY105
                [req.max_new_tokens - 1], dtype=torch.int32, device=dev)
            self._install_rows(slot_t, first, length_t, limit_t, temps_t,
                               top_ps_t)
        self._host_pos[req.slot] = len(req.prompt)
        self._host_temp[req.slot] = temp
        self._host_top_p[req.slot] = top_p
        (first_host,) = self._fetch(first)
        self._record_first(req, int(first_host[0]))
        if req.submitted_at:
            # TTFT split cold vs fused: did a window of this prompt ride
            # a decode chunk?
            telemetry_metrics.INFER_FUSE_TTFT.labels(
                mode='fused' if req.fused_chunks else 'cold').observe(
                    req.ttft_s)
        self._reset_drafter(req)
        eos = self.gen.eos_token
        if (eos is not None and req.out[-1] == eos) or \
                len(req.out) >= req.max_new_tokens:
            self._finish(req)
        else:
            self._active[req.slot] = req

    def _finish(self, req: _Request) -> None:
        req.done = True
        if self._spans_on():
            now = self._span_clock()
            self._span('delivery', now, now, req=req, tokens=len(req.out))
        if self._ledger is not None:
            self._ledger.finish_request(req.rid, req.tenant,
                                        session=req.trace_id)
        if req.slot is not None and req.slot in self._active:
            del self._active[req.slot]
        if req.slot is not None:
            self._free.append(req.slot)
            self._pool_free_slot(req.slot)
            # Freeze the freed slot and park it at row 0, which stays
            # inside even the smallest bucket (pooled: its zeroed table
            # row routes it to the garbage block).
            self._positions[req.slot] = 0
            self._done[req.slot] = True
            self._host_pos[req.slot] = 0

    def _requeue_incremental(self, req: _Request) -> None:
        """A failed chunked-prefill dispatch must not leak the slot or
        leave the lane set (a stuck lane would retry the failing window
        every tick): re-queue the request to restart from zero."""
        self._incremental = None
        req.prefill_pos = 0
        self._pool_free_slot(req.slot)
        self._free.insert(0, req.slot)
        req.slot = None
        self._queue.insert(0, req)

    def _advance_prefill(self) -> None:
        """One window of the in-flight chunked prefill; on the final
        window, sample the first token and promote the request to the
        decode batch."""
        req = self._incremental
        if req is None:
            return
        w = self.gen.prefill_chunk
        start = req.prefill_pos
        end = min(start + w, len(req.prompt))
        window = np.zeros((w,), np.int32)
        window[:end - start] = req.prompt[start:end]
        w0 = self._span_clock() if self._spans_on() else 0.0
        try:
            with self._profiler.phase('prefill'):
                # One synchronizing upload a window: sanctioned.
                window_t = torch.as_tensor(  # skytpu-allow: SKY105
                    window, device=self.device)
                if self.pooled:
                    table_t = torch.as_tensor(  # skytpu-allow: SKY105
                        self._host_tables[req.slot], device=self.device)
                    h_last, _ = llama_infer.prefill_window_pooled(
                        self.params, window_t, self.config, self._cache,
                        table_t, start, mesh=self.mesh)
                else:
                    h_last, _ = llama_infer.prefill_window(
                        self.params, window_t, self.config, self._cache,
                        req.slot, start, mesh=self.mesh)
            req.prefill_pos = end
            if self._spans_on():
                self._span('prefill_chunk', w0, self._span_clock(),
                           req=req, start=start, end=end)
            if self._ledger is not None:
                self._ledger.charge_request('prefill', req.rid, req.tenant)
                self._ledger.add_tokens(req.rid, req.tenant,
                                        prefill=end - start)
            if end < len(req.prompt):
                return
            if self.pooled:
                # Insert BEFORE completion: a 1-token budget finishes
                # inside _complete_prefill and _finish drops the slot's
                # references; the trie's own keep the prompt cached.
                self._prefix_insert(req)
            self._complete_prefill(req, h_last, start)
        except Exception:
            self._requeue_incremental(req)
            raise
        self._incremental = None
        if not self.pooled:
            self._prefix_insert(req)

    def _decode_chunk(self, n: int, prefill_lane=None, lane_span=None):
        """One n-step decode chunk over all active slots and its ONE
        host fetch: the token block plus the positions steering the next
        tick (frozen slots did not advance, so they come back exact).
        prefill_lane: as _decode's (the chunk runs under the 'fused'
        phase, else 'decode'); a failed fused dispatch re-queues the
        in-flight prompt.  lane_span: the attributes of the fused chunk's
        'fused_tick' span (a plain chunk records 'decode_chunk').
        Returns (the lane's hiddens or None, the tokens appended)."""
        prev_pos = ({s: int(self._host_pos[s]) for s in self._active}
                    if self._drafter is not None else None)
        if self.pooled:
            self._ensure_slot_blocks(n)
            self._upload_tables()
        else:
            # Bucket crossing: this chunk's deepest live write lands at
            # row live_max + n - 1.  Shrinking waits while a chunked
            # prefill is parked at the cache's last row.
            live_max = max(int(self._host_pos[s]) for s in self._active)
            target = engine_lib.cache_bucket_for(self.cache_buckets,
                                                 live_max + n)
            if target > self._cache_len or (target < self._cache_len
                                            and self._incremental is None):
                self._migrate(target)
        all_greedy, nucleus = self._sampling_mode()
        active_slots = len(self._active)
        spans_on = self._spans_on()
        parties = ([(r.rid, r.tenant) for r in self._active.values()]
                   if (spans_on or self._ledger is not None) else [])
        if self._ledger is not None and prefill_lane is None:
            self._ledger.charge_batch('decode', parties)
        c0 = self._span_clock() if spans_on else 0.0
        chunk_start = time.perf_counter()
        try:
            with self._profiler.phase('decode' if prefill_lane is None
                                      else 'fused'):
                toks, h_pf = self._decode(n, all_greedy, nucleus,
                                          prefill_lane)
        except Exception:
            if prefill_lane is not None:
                # The decode rows rode this dispatch too; the replica
                # treats an engine error as a fault either way.
                self._requeue_incremental(self._incremental)
            raise
        host, host_pos = self._fetch(toks.t(), self._positions)
        chunk_dt = time.perf_counter() - chunk_start
        self.decode_seconds += chunk_dt
        if spans_on and prefill_lane is None:
            self._span('decode_chunk', c0, self._span_clock(), n=n,
                       slots=active_slots,
                       rids=sorted(rid for rid, _ in parties))
        elif spans_on:
            self._span('fused_tick', c0, self._span_clock(), **lane_span)
        # A slot decoded a token in a step iff its position advanced.
        self.slot_steps += n * self.gen.batch_size
        self.live_slot_steps += int((host_pos - self._host_pos).sum())
        self._host_pos = host_pos.astype(np.int64)
        self._observe_chunk(prev_pos, host)
        telemetry_metrics.INFER_DECODE_CHUNK_SECONDS.observe(chunk_dt)
        telemetry_metrics.INFER_DECODE_BUCKET_CHUNKS.labels(
            bucket=str(self._cache_len)).inc()
        telemetry_metrics.INFER_DECODE_CACHE_ROWS.set(self._cache_len)
        if chunk_dt > 0:
            telemetry_metrics.INFER_STEADY_TOKENS_PER_SEC.set(
                n * active_slots / chunk_dt)
        return h_pf, self._absorb(host)

    def _step_fused(self, n: int) -> None:
        """One fused prefill+decode chunk: the decode batch advances n
        tokens with step()'s semantics while the chunk's first forward
        also carries the next piece of the in-flight prompt, sized by
        the leftover-budget policy and padded to fuse_budget.  One
        counted host fetch for the chunk; the final piece adds
        _complete_prefill's first-token fetch, as a dedicated final
        window would."""
        req = self._incremental
        start = req.prefill_pos
        chunk = self._fuse_policy.chunk(len(req.prompt) - start,
                                        len(self._active))
        end = start + chunk
        window = np.zeros((self.gen.fuse_budget,), np.int32)
        window[:chunk] = req.prompt[start:end]
        dev = self.device
        active_slots = len(self._active)
        if self._ledger is not None:
            # The fused dispatch serves every decoding slot and the
            # prefill lane's owner: all of them split the phase.
            self._ledger.charge_batch(
                'fused', [(r.rid, r.tenant) for r in self._active.values()]
                + [(req.rid, req.tenant)])
            self._ledger.add_tokens(req.rid, req.tenant, prefill=chunk)
        # The lane's window and table row: one synchronizing upload
        # each a fused tick (sanctioned).
        window_t = torch.as_tensor(window, device=dev)  # skytpu-allow: SKY105
        table_t = torch.as_tensor(  # skytpu-allow: SKY105
            self._host_tables[req.slot], device=dev)
        h_pf, _ = self._decode_chunk(n, prefill_lane=(window_t, table_t,
                                                      start),
            lane_span=dict(req=req, prefill_chunk=chunk, n=n,
                           slots=active_slots))
        req.prefill_pos = end
        req.fused_chunks += 1
        self._fuse_policy.record_fused(chunk)
        telemetry_metrics.INFER_FUSE_STEPS.inc()
        telemetry_metrics.INFER_FUSE_PREFILL_TOKENS.inc(chunk)
        telemetry_metrics.INFER_FUSE_BUDGET_UTILIZATION.set(
            self._fuse_policy.utilization(chunk))
        if end < len(req.prompt):
            return
        try:
            self._prefix_insert(req)
            self._complete_prefill(req, h_pf, start)
        except Exception:
            self._requeue_incremental(req)
            raise
        self._incremental = None

    def _step_spec(self) -> None:
        """One draft-verify chunk over all active slots: the drafter
        proposes spec_k tokens per slot on the host, one verify forward
        scores the window, and each slot commits its agreeing prefix.
        Exactly one counted host fetch.  Block tables, refcounts and the
        free list are untouched by rejected rows."""
        win = self.gen.spec_k + 1
        # The window writes candidate K/V at rows pos..pos+k before the
        # accept decision; _pool_cap's slack covers the deepest one.
        self._ensure_slot_blocks(win)
        self._upload_tables()
        all_greedy, nucleus = self._sampling_mode()
        live = list(self._active)
        spans_on = self._spans_on()
        d0 = self._span_clock() if spans_on else 0.0
        with self._profiler.phase('spec_draft'):
            draft = self._drafter.propose_batch(live, self.gen.batch_size)
        if spans_on:
            self._span('spec_draft', d0, self._span_clock(),
                       k=self.gen.spec_k, slots=len(live))
        v0 = self._span_clock() if spans_on else 0.0
        chunk_start = time.perf_counter()
        with self._profiler.phase('spec_verify'):
            toks, committed = self._verify(draft, all_greedy, nucleus)
        # ONE transfer: the emitted window rows, the positions steering
        # the next tick and each lane's committed count (the host absorbs
        # exactly that prefix; the rest is rejected tail).
        host, host_pos, host_committed = self._fetch(
            toks, self._positions, committed)
        chunk_dt = time.perf_counter() - chunk_start
        self.decode_seconds += chunk_dt
        if spans_on:
            self._span('spec_verify', v0, self._span_clock(),
                       k=self.gen.spec_k, slots=len(live))
        self._host_pos = host_pos.astype(np.int64)
        telemetry_metrics.INFER_DECODE_CHUNK_SECONDS.observe(chunk_dt)
        telemetry_metrics.INFER_DECODE_BUCKET_CHUNKS.labels(
            bucket=str(self._cache_len)).inc()
        telemetry_metrics.INFER_DECODE_CACHE_ROWS.set(self._cache_len)
        # committed - 1 of each lane's tokens were drafter proposals (the
        # +1 is the target's own token at the first mismatch).
        accepted = sum(max(int(host_committed[s]) - 1, 0) for s in live)
        proposed = self.gen.spec_k * len(live)
        self._spec_policy.record(accepted, proposed)
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        telemetry_metrics.INFER_SPEC_PROPOSED.inc(proposed)
        telemetry_metrics.INFER_SPEC_ACCEPTED.inc(accepted)
        telemetry_metrics.INFER_SPEC_ACCEPT_RATE.observe(
            accepted / max(proposed, 1))
        if self._ledger is not None:
            parties = [(self._active[s].rid, self._active[s].tenant)
                       for s in live if s in self._active]
            self._ledger.charge_batch('spec_draft', parties)
            self._ledger.charge_batch('spec_verify', parties)
            self._ledger.add_spec(parties, proposed=proposed,
                                  accepted=accepted)
        for slot in list(self._active):
            c = int(host_committed[slot])
            if c > 0:
                self._drafter.observe(slot, [int(t) for t in host[slot, :c]])
        appended = self._absorb(host, host_committed)
        if chunk_dt > 0:
            telemetry_metrics.INFER_STEADY_TOKENS_PER_SEC.set(
                appended / chunk_dt)
        telemetry_metrics.INFER_SPEC_TOKENS_PER_SYNC.set(float(appended))

    def step(self) -> None:
        """One scheduler tick: admit queued requests, advance the
        in-flight chunked prefill by one window (or piggyback it on the
        decode chunk when fusing is on), then one decode chunk for all
        active slots: a verify chunk when speculation is on and the
        policy agrees, else n lockstep steps.  With the host tier, the
        completed copies apply (and hinted prefetches issue) before
        admission, so blocks that landed serve this tick's requests as
        device hits.

        Every tick runs under the StepProfiler, whose phase times land
        in the step-phase families (and the ledger) even when the tick
        raises."""
        if self._ledger is not None:
            self._ledger.begin_step()
        self._profiler.start()
        try:
            self._step_inner()
        finally:
            self._finish_step_profile()

    def _step_inner(self) -> None:
        if self._tier is not None:
            with self._profiler.phase('tier_wait'):
                self._drain_tier()
        with self._profiler.phase('admit'):
            self._admit()
        if self._tier is not None and self._tier_parked and \
                not self._active and self._incremental is None:
            # The tick's only work left is in-flight prefetches: wait for
            # the copy engine (the parked-admission stall), so
            # run_until_idle makes progress instead of spinning.
            with self._profiler.phase('tier_wait'):
                self._tier.wait_pending()
                self._drain_tier()
            with self._profiler.phase('admit'):
                self._admit()
        # Fuse gate: a chunked prefill in flight AND a decode batch to
        # ride on.  Fused ticks do not speculate: while a cold prompt is
        # in flight TTFT is the binding metric, and a verify window
        # cannot carry the prefill lane.
        fused = (self._fuse_policy is not None
                 and self._incremental is not None and bool(self._active))
        if not fused:
            if self._fuse_policy is not None and \
                    self._incremental is not None:
                self._fuse_policy.record_dedicated()
            self._advance_prefill()
        if not self._active:
            telemetry_metrics.INFER_SLOT_OCCUPANCY.set(0.0)
            return
        # Capacity from the host-side position mirror (reading the
        # device rows would cost a sync per tick).
        live_max = max(int(self._host_pos[s]) for s in self._active)
        if not fused and self._drafter is not None and \
                live_max + self.gen.spec_k + 1 <= self.gen.max_seq_len \
                and self._spec_policy.should_speculate():
            self._step_spec()
            return
        n = max(1, min(self.decode_chunk, self.gen.max_seq_len - live_max))
        if fused:
            self._step_fused(n)
        else:
            self._decode_chunk(n)

    def run_until_idle(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self._queue and not self._active and \
                    self._incremental is None and not self._tier_parked:
                return
            self.step()
        raise RuntimeError('run_until_idle exceeded max_ticks')
