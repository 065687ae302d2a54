"""Continuous batching over the pooled KV arena.

Counterpart of the core of skypilot_tpu/infer/serving.py
(``ContinuousBatcher`` with ``decode_impl='pooled'``):

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

Where the JAX package jitted each piece and donated the arena, this
module runs eagerly and updates the arena and the per-slot device rows
in place.  Left for later slices (ROADMAP.md Queue A): telemetry, spans
and the cost ledger (item 13), the prefix cache and host tier (item 9),
speculative decoding and the fused step (item 8), and meshes (item 10).

Usage:

    batcher = ContinuousBatcher(params, config, gen_config)
    rid = batcher.submit([1, 2, 3], max_new_tokens=64)
    while not batcher.is_done(rid):
        batcher.step()
    tokens = batcher.result(rid)
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.infer import block_pool as block_pool_lib
from skypilot_tpu_torch.infer import engine as engine_lib
from skypilot_tpu_torch.infer import llama_infer, quant, sampling
from skypilot_tpu_torch.infer.engine import GeneratorConfig
from skypilot_tpu_torch.models import llama


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
    # Host clock at submit() and seconds from there to the first token.
    submitted_at: float = 0.0
    ttft_s: Optional[float] = None


class ContinuousBatcher:
    """Slot-scheduled generation: decode never waits for the batch."""

    def __init__(self, params: llama.Params, config: llama.LlamaConfig,
                 gen_config: GeneratorConfig = GeneratorConfig(),
                 decode_chunk: int = 8, max_queue: Optional[int] = None,
                 device=None):
        """params: as returned by llama.init_params / params_from_numpy,
        on `device` (default: the CUDA card).

        max_queue: submit() raises PoolExhaustedError (with Retry-After
        advice) once this many requests wait; None = unbounded."""
        self.device = resolve_device(device)
        engine_lib.validate_context(gen_config, config)
        if gen_config.prefill_chunk is not None and \
                gen_config.prefill_chunk <= 0:
            raise ValueError(f'prefill_chunk must be positive, got '
                             f'{gen_config.prefill_chunk}')
        if max_queue is not None and max_queue < 1:
            raise ValueError(f'max_queue must be >= 1, got {max_queue}')
        self.params = params
        self.config = config
        self.gen = gen_config
        self.decode_chunk = decode_chunk
        self.max_queue = max_queue
        self.buckets = engine_lib.derive_buckets(gen_config)

        batch = gen_config.batch_size
        bs = gen_config.derive_block_size()
        self.block_size = bs
        self.table_width = -(-gen_config.max_seq_len // bs)
        n_blocks = gen_config.pool_blocks
        if n_blocks is None:
            # "Cannot exhaust" sizing: every slot to max_seq_len, plus
            # the garbage block.
            n_blocks = 1 + batch * self.table_width
        self.pool = block_pool_lib.BlockPool(
            config, n_blocks, bs, kv_dtype=gen_config.kv_cache_dtype,
            device=self.device)
        self._cache_len = self.table_width * bs
        self._host_tables = np.zeros((batch, self.table_width), np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch)]
        # Worst-case block ceiling and outstanding reservation per slot.
        self._slot_cap = np.zeros((batch,), np.int32)
        self._slot_reserved = np.zeros((batch,), np.int32)
        self._tables_dev = torch.as_tensor(self._host_tables,
                                           device=self.device)
        self._tables_dirty = False

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

        self._free: List[int] = list(range(batch))
        self._active: Dict[int, _Request] = {}       # slot -> request
        self._requests: Dict[int, _Request] = {}     # rid -> request
        self._queue: List[_Request] = []
        self._ids = itertools.count(1)
        self._admit_group = max(1, min(4, batch))
        # The in-flight chunked prefill (at most one long prompt).
        self._incremental: Optional[_Request] = None
        # Steady decode throughput: real tokens appended by decode
        # chunks and the host seconds those chunks took (each ends in
        # the chunk's one host fetch, so the clock covers device work).
        self.decode_tokens = 0
        self.decode_seconds = 0.0

    # ---- public API ------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None) -> int:
        """temperature/top_p: per-request sampling (None = the server
        defaults in GeneratorConfig), honored per slot."""
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
            raise block_pool_lib.PoolExhaustedError(
                f'Admission queue full ({self.num_queued} waiting, '
                f'max_queue={self.max_queue}); retry later or on '
                f'another replica.',
                retry_after_s=max(1.0, 0.25 * self.num_queued))
        req = _Request(next(self._ids), list(prompt),
                       min(max_new_tokens,
                           self.gen.max_seq_len - len(prompt)),
                       temperature=temperature, top_p=top_p,
                       submitted_at=time.perf_counter())
        if self._pool_cap(req) > self.pool.n_blocks - 1:
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

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def num_queued(self) -> int:
        # The in-flight chunked prefill counts as queued: it is not
        # decoding yet.
        return len(self._queue) + (1 if self._incremental else 0)

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f'Prompt length {length} exceeds largest bucket')

    # ---- pool helpers ----------------------------------------------------
    def _pool_cap(self, req: _Request) -> int:
        """Worst-case blocks the request can ever reference: prompt plus
        its full token budget, capped at the table width."""
        total = min(len(req.prompt) + req.max_new_tokens,
                    self.gen.max_seq_len)
        return min(-(-total // self.block_size), self.table_width)

    def _pool_reserve(self, req: _Request) -> bool:
        """Claim the request's worst-case block need before it leaves the
        queue; failure is admission backpressure."""
        return self.pool.reserve(self._pool_cap(req))

    def _pool_bind_slot(self, req: _Request) -> None:
        """Give an admitted request's slot its prompt blocks, drawn from
        its admission reservation."""
        slot = req.slot
        cap = self._pool_cap(req)
        nb_prompt = min(-(-len(req.prompt) // self.block_size),
                        self.table_width)
        fresh = self.pool.alloc(nb_prompt, from_reservation=True)
        self._host_tables[slot, :nb_prompt] = fresh
        self._slot_blocks[slot] = list(fresh)
        self._slot_cap[slot] = cap
        self._slot_reserved[slot] = cap - nb_prompt
        self._tables_dirty = True

    def _pool_free_slot(self, slot: int) -> None:
        """Drop a slot's block references, return its unused reservation
        and zero its table row, so its frozen lockstep write lands in
        the garbage block."""
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
            self._tables_dev = torch.as_tensor(self._host_tables,
                                               device=self.device)
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
                       slots: np.ndarray, tables_scatter: np.ndarray,
                       temps: np.ndarray, top_ps: np.ndarray,
                       limits: np.ndarray) -> torch.Tensor:
        """Prefill a GROUP of prompts (G, bucket) in one forward into a
        scratch cache, scatter each row into its slot's arena blocks in
        place, sample the first tokens and install the slots' rows.
        Returns the first tokens (device)."""
        dev = self.device
        nb = tables_scatter.shape[1]
        scratch = llama_infer.init_cache(
            self.config, tokens.shape[0], nb * self.block_size,
            device=dev)
        lengths_t = torch.as_tensor(lengths, device=dev)
        logits, scratch = llama_infer.prefill(
            self.params, torch.as_tensor(tokens, device=dev), self.config,
            scratch, lengths_t)
        llama_infer.scatter_prefill_pooled(
            scratch, self.pool.arena, torch.as_tensor(tables_scatter,
                                                      device=dev))
        temps_t = torch.as_tensor(temps, device=dev)
        top_ps_t = torch.as_tensor(top_ps, device=dev)
        firsts = self._sample(logits, temps, top_ps, temps_t, top_ps_t)
        self._install_rows(torch.as_tensor(slots, device=dev).long(),
                           firsts, lengths_t,
                           torch.as_tensor(limits, device=dev), temps_t,
                           top_ps_t)
        return firsts

    def _decode(self, n: int, all_greedy: bool,
                nucleus: bool) -> torch.Tensor:
        """n lockstep decode steps with on-device sampling and per-slot
        EOS/budget tracking; no host sync inside.  Done slots freeze
        (position and feed token stop advancing) and emit the fill
        token.  Updates the device rows and the arena in place and
        returns the (n, B) token block."""
        eos = self.gen.eos_token
        fill = eos if eos is not None else 0
        batch = self._token.shape[0]
        tables = self._tables_dev
        toks = torch.empty((n, batch), dtype=torch.int32,
                           device=self.device)
        token, positions = self._token, self._positions
        done, limit = self._done, self._limit
        for i in range(n):
            logits, _ = llama_infer.decode_step_pooled(
                self.params, token, self.config, self.pool.arena,
                positions, tables)
            if all_greedy:
                nxt = sampling.sample_logits(logits, temperature=0.0)
            else:
                nxt = sampling.sample_logits_batched(
                    logits, self._rng, self._temp_row, self._top_p_row,
                    top_k=self.gen.top_k, nucleus=nucleus)
            live = torch.logical_not(done)
            live_i = live.to(torch.int32)
            toks[i] = torch.where(live, nxt, fill)
            limit = limit - live_i
            hit = (limit <= 0) if eos is None else (nxt == eos) | (limit <= 0)
            done = done | (live & hit)
            positions = positions + live_i
            token = torch.where(live, nxt, token)
        self._token, self._positions = token, positions
        self._done, self._limit = done, limit
        return toks

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

    def _admit(self) -> None:
        """Move queued requests into free slots: groups of up to
        _admit_group same-bucket requests prefill in ONE forward.
        Scanning is by index, so while one long chunked prefill is in
        flight, shorter requests behind it still admit into the other
        free slots."""
        eos = self.gen.eos_token
        chunk_w = self.gen.prefill_chunk
        idx = 0
        while self._free and idx < len(self._queue):
            head = self._queue[idx]
            if chunk_w and len(head.prompt) > chunk_w:
                if self._incremental is not None or \
                        not self._pool_reserve(head):
                    # One long prefill in flight, or pool backpressure:
                    # keep the queue position, scan on.
                    idx += 1
                    continue
                request = self._queue.pop(idx)
                request.slot = self._free.pop(0)
                self._incremental = request
                self._pool_bind_slot(request)
                # Park the slot's frozen position at the last cache row:
                # the lockstep decode still rewrites a frozen slot's
                # CURRENT row, and row 0 would clobber the rows this
                # prefill writes.  The park row is >= len(prompt), so a
                # real decode write overwrites it before it is attended.
                park = self._cache_len - 1
                self._positions[request.slot] = park
                self._host_pos[request.slot] = park
                continue
            if not self._pool_reserve(head):
                idx += 1
                continue
            bucket = self._bucket_for(len(head.prompt))
            group = [self._queue.pop(idx)]
            group[0].slot = self._free.pop(0)
            while (idx < len(self._queue) and self._free
                   and len(group) < self._admit_group):
                cand = self._queue[idx]
                if self._bucket_for(len(cand.prompt)) != bucket or \
                        (chunk_w and len(cand.prompt) > chunk_w):
                    break
                if not self._pool_reserve(cand):
                    break
                cand = self._queue.pop(idx)
                cand.slot = self._free.pop(0)
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
            try:
                # Each row claims the blocks of ITS prompt; the bucket's
                # remaining block columns point at the garbage block.
                nb = -(-bucket // self.block_size)
                tables_scatter = np.full(
                    (size, nb), block_pool_lib.GARBAGE_BLOCK, np.int32)
                for i, request in enumerate(group):
                    self._pool_bind_slot(request)
                    row = self._slot_blocks[request.slot]
                    tables_scatter[i, :len(row)] = row
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
            # ONE counted sync for the whole admitted group.
            (firsts,) = engine_lib.host_fetch(firsts)
            for i, req in enumerate(group):
                self._host_pos[req.slot] = len(req.prompt)
                self._record_first(req, int(firsts[i]))
                if (eos is not None and req.out[-1] == eos) or \
                        len(req.out) >= req.max_new_tokens:
                    self._finish(req)
                else:
                    self._active[req.slot] = req

    def _complete_prefill(self, req: _Request, h_last: torch.Tensor,
                          last_start: int) -> None:
        """Finish a chunked prefill: logits at the prompt's last window
        row -> first token -> install the slot's decode rows; one counted
        host sync."""
        temp, top_p = self._request_sampling(req)
        dev = self.device
        h = h_last[len(req.prompt) - 1 - last_start][None]
        logits = quant.matmul(h, self.params['lm_head'],
                              out_dtype=torch.float32)
        temps = np.asarray([temp], np.float32)
        top_ps = np.asarray([top_p], np.float32)
        temps_t = torch.as_tensor(temps, device=dev)
        top_ps_t = torch.as_tensor(top_ps, device=dev)
        first = self._sample(logits, temps, top_ps, temps_t, top_ps_t)
        self._install_rows(
            torch.as_tensor([req.slot], device=dev), first,
            torch.as_tensor([len(req.prompt)], dtype=torch.int32,
                            device=dev),
            torch.as_tensor([req.max_new_tokens - 1], dtype=torch.int32,
                            device=dev), temps_t, top_ps_t)
        self._host_pos[req.slot] = len(req.prompt)
        self._host_temp[req.slot] = temp
        self._host_top_p[req.slot] = top_p
        (first_host,) = engine_lib.host_fetch(first)
        self._record_first(req, int(first_host[0]))
        eos = self.gen.eos_token
        if (eos is not None and req.out[-1] == eos) or \
                len(req.out) >= req.max_new_tokens:
            self._finish(req)
        else:
            self._active[req.slot] = req

    def _finish(self, req: _Request) -> None:
        req.done = True
        if req.slot is not None and req.slot in self._active:
            del self._active[req.slot]
        if req.slot is not None:
            self._free.append(req.slot)
            self._pool_free_slot(req.slot)
            # Freeze the freed slot and park it at row 0, which its
            # zeroed table row routes to the garbage block.
            self._positions[req.slot] = 0
            self._done[req.slot] = True
            self._host_pos[req.slot] = 0

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
        try:
            h_last, _ = llama_infer.prefill_window_pooled(
                self.params, torch.as_tensor(window, device=self.device),
                self.config, self.pool.arena,
                torch.as_tensor(self._host_tables[req.slot],
                                device=self.device), start)
            req.prefill_pos = end
            if end < len(req.prompt):
                return
            self._complete_prefill(req, h_last, start)
        except Exception:
            # A failed window must not leak the slot or leave the lane
            # set (a stuck lane would retry the failing window every
            # tick): re-queue the request to restart from zero.
            self._incremental = None
            req.prefill_pos = 0
            self._pool_free_slot(req.slot)
            self._free.insert(0, req.slot)
            req.slot = None
            self._queue.insert(0, req)
            raise
        self._incremental = None

    def step(self) -> None:
        """One scheduler tick: admit queued requests, advance the
        in-flight chunked prefill by one window, then one decode chunk
        for all active slots."""
        self._admit()
        self._advance_prefill()
        if not self._active:
            return
        # Capacity from the host-side position mirror (reading the
        # device rows would cost a sync per tick).
        live_max = max(int(self._host_pos[s]) for s in self._active)
        n = max(1, min(self.decode_chunk, self.gen.max_seq_len - live_max))
        self._ensure_slot_blocks(n)
        self._upload_tables()
        all_greedy = not any(float(self._host_temp[s]) > 0.0
                             for s in self._active)
        nucleus = any(float(self._host_top_p[s]) < 1.0
                      for s in self._active)
        chunk_start = time.perf_counter()
        toks = self._decode(n, all_greedy, nucleus)
        # ONE transfer for the whole chunk: the token block plus the
        # positions steering the next tick (frozen slots did not
        # advance, so they come back exact).
        host, host_pos = engine_lib.host_fetch(toks.t(), self._positions)
        self.decode_seconds += time.perf_counter() - chunk_start
        self._host_pos = host_pos.astype(np.int64)
        eos = self.gen.eos_token
        for slot, req in list(self._active.items()):
            for t in host[slot]:
                req.out.append(int(t))
                self.decode_tokens += 1
                if (eos is not None and req.out[-1] == eos) or \
                        len(req.out) >= req.max_new_tokens:
                    self._finish(req)
                    break

    def run_until_idle(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self._queue and not self._active and \
                    self._incremental is None:
                return
            self.step()
        raise RuntimeError('run_until_idle exceeded max_ticks')
