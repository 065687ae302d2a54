"""Generation engine: the lockstep ``Generator`` and the config and
helpers it shares with the batcher.

Counterpart of skypilot_tpu/infer/engine.py: ``GeneratorConfig`` with
the same validation errors, ``derive_buckets``, ``derive_cache_buckets``,
``validate_context``, ``prepare_params``, ``host_fetch``,
``commit_step``, ``ChunkGraphs`` (the reference's jitted chunk programs
as CUDA graphs) and ``Generator`` on every decode plane: the pooled
block arena (with speculative verify) and the legacy contiguous planes
('paged', 'inplace', 'scan', 'unroll') with their bucket migrations,
each with the radix prefix cache (``prefix_cache_mb``: a warm hit is a
block-table splice on the pooled plane, an install copy on a legacy
one).  The host KV tier (``host_tier_mb``) belongs to the batcher.
Options the port does not carry yet raise ``NotImplementedError``
naming their ROADMAP.md item: meshes and collective overlap (item 10).
Telemetry (item 13) is left out; a Generator keeps its last run's counts
in ``last_stats``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.infer import block_pool as block_pool_lib
from skypilot_tpu_torch.infer import llama_infer, prefix_cache, quant
from skypilot_tpu_torch.infer import sampling
from skypilot_tpu_torch.infer import spec_decode as spec_decode_lib
from skypilot_tpu_torch.ops import _kernels
from skypilot_tpu_torch.ops import decode_attention as decode_attention_ops


def _deferred(option: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f'{option} is not ported yet: ROADMAP.md Queue A item {item}')


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    max_seq_len: int = 2048
    batch_size: int = 1
    # Prompt buckets (right-padded): ascending; the largest must not
    # exceed max_seq_len.  None -> powers of two from 64.
    prompt_buckets: Optional[Sequence[int]] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    # None = model dtype; 'int8' = quantized KV arena (per-row absmax
    # scales) / weight-only int8 linear weights (per-out-channel scales).
    kv_cache_dtype: Optional[str] = None
    weights_dtype: Optional[str] = None
    # 'pooled' (default): the block-arena data plane.  The legacy
    # planes keep one contiguous (L, B, S, KV, hd) slot cache whose
    # length S follows the live contexts through cache_buckets: 'paged'
    # attends through the K7 kernel (every bucket % 64 == 0, head_dim %
    # 128 == 0); 'inplace', 'scan' and 'unroll' with plain masked math.
    decode_impl: str = 'pooled'
    # Chunked prefill: prompts LONGER than this many tokens prefill in
    # prefill_chunk-sized windows interleaved with decode ticks.
    # None = whole-prompt prefill.
    prefill_chunk: Optional[int] = None
    # Cache-length buckets of the legacy planes (ascending): the slot
    # cache is allocated at the smallest bucket covering the live
    # positions and migrated as they cross bucket edges.  None = powers
    # of two from 64 up to max_seq_len.
    cache_buckets: Optional[Sequence[int]] = None
    # Steps per decode chunk of the lockstep Generator (the batcher takes
    # its own decode_chunk argument).
    decode_chunk: int = 32
    # Radix prefix KV cache (infer/prefix_cache.py): device-byte budget
    # of cached prompt heads, matched in prefix_block-token blocks.
    # None/0 = off.
    prefix_cache_mb: Optional[float] = None
    prefix_block: int = 64
    # Pooled arena block size in cache rows.  None -> 64 capped at
    # max_seq_len.
    kv_block_size: Optional[int] = None
    # Physical blocks in the arena including the garbage block 0.
    # None -> enough for every slot to reach max_seq_len.
    pool_blocks: Optional[int] = None
    # Speculative decoding: the n-gram drafter proposes spec_k tokens per
    # slot and one verify forward scores spec_k + 1 positions.  0 = off.
    spec_k: int = 0
    # Collective overlap for sharded decode (Queue A item 10).
    overlap_collectives: Optional[bool] = None
    overlap_chunks: Optional[int] = None
    # Host-DRAM KV tier (infer/kv_tier.py, ContinuousBatcher only): byte
    # budget of pinned host rows that evicted prefix-cache blocks spill
    # to and prefetch back from.  Needs the pooled plane and
    # prefix_cache_mb.  None/0 = off.
    host_tier_mb: Optional[float] = None
    # Chunked-prefill piggyback: token columns of a fused step's first
    # forward (decode slots + prompt chunk).  None = dedicated windows.
    fuse_budget: Optional[int] = None

    def __post_init__(self):
        legacy = self.decode_impl != 'pooled'
        if self.fuse_budget is not None:
            if self.fuse_budget < 1:
                raise ValueError(f'fuse_budget must be >= 1, got '
                                 f'{self.fuse_budget}')
            if legacy:
                raise ValueError(
                    f"fuse_budget={self.fuse_budget} requires the "
                    f"pooled data plane (decode_impl='pooled'); the "
                    f"legacy '{self.decode_impl}' plane has no fused "
                    f'prefill+decode path')
            if self.prefill_chunk is None:
                raise ValueError(
                    f'fuse_budget={self.fuse_budget} piggybacks the '
                    f'chunked-prefill lane; set prefill_chunk (the '
                    f'threshold above which prompts prefill '
                    f'incrementally) to enable it')
        if self.host_tier_mb is not None and self.host_tier_mb < 0:
            raise ValueError(f'host_tier_mb must be >= 0, got '
                             f'{self.host_tier_mb}')
        if self.host_tier_mb:
            if legacy:
                raise ValueError(
                    f"host_tier_mb={self.host_tier_mb} requires the "
                    f"pooled data plane (decode_impl='pooled'); the "
                    f"legacy '{self.decode_impl}' plane has no block "
                    f'arena to spill from')
            if not self.prefix_cache_mb:
                raise ValueError(
                    f'host_tier_mb={self.host_tier_mb} spills evicted '
                    f'prefix-cache blocks; set prefix_cache_mb (the '
                    f'device-tier budget the host tier sits behind) '
                    f'to enable it')
        if self.overlap_chunks is not None and self.overlap_chunks < 1:
            raise ValueError(f'overlap_chunks must be >= 1, got '
                             f'{self.overlap_chunks}')
        if self.overlap_collectives and legacy:
            raise ValueError(
                f"overlap_collectives=True requires the pooled data "
                f"plane (decode_impl='pooled'); the legacy "
                f"'{self.decode_impl}' plane has no manual-region "
                f'layer stack')
        if self.spec_k < 0:
            raise ValueError(f'spec_k must be >= 0, got {self.spec_k}')
        if self.spec_k and legacy:
            raise ValueError(
                f"spec_k={self.spec_k} requires the pooled data plane "
                f"(decode_impl='pooled'); the legacy "
                f"'{self.decode_impl}' plane has no verify-window path")
        if self.spec_k and self.spec_k + 1 >= self.max_seq_len:
            raise ValueError(
                f'spec_k={self.spec_k} leaves no room for a verify '
                f'window inside max_seq_len={self.max_seq_len}')
        if self.kv_block_size is not None and self.kv_block_size < 1:
            raise ValueError(f'kv_block_size must be >= 1, got '
                             f'{self.kv_block_size}')
        if self.pool_blocks is not None and self.pool_blocks < 2:
            raise ValueError(f'pool_blocks must be >= 2 (garbage block '
                             f'+ 1), got {self.pool_blocks}')
        if not legacy:
            bs = self.derive_block_size()
            if self.prefix_cache_mb and self.prefix_block % bs:
                raise ValueError(
                    f'prefix_block={self.prefix_block} must be a '
                    f'multiple of kv_block_size={bs} under the pooled '
                    f'data plane (a trie node must map to whole arena '
                    f'blocks); pick kv_block_size from the divisors of '
                    f'prefix_block')
        if self.decode_impl == 'paged':
            # K7 reads the cache in DEFAULT_BLOCK-row blocks: every
            # bucket the decode loop can allocate must be a multiple.
            block = decode_attention_ops.DEFAULT_BLOCK
            bad = [b for b in derive_cache_buckets(self) if b % block]
            if bad:
                raise ValueError(
                    f"decode_impl='paged' requires every cache bucket "
                    f'to be a multiple of the kernel block '
                    f'{block}, but cache_buckets derive to '
                    f'{derive_cache_buckets(self)} (offending: {bad}). '
                    f'Round the buckets up, or use the default pooled '
                    f'data plane which has no bucket constraint.')
        for name in ('kv_cache_dtype', 'weights_dtype'):
            value = getattr(self, name)
            if value not in (None, 'int8'):
                raise ValueError(f"{name} must be None or 'int8', "
                                 f'got {value!r}')
        if self.overlap_collectives:
            raise _deferred('overlap_collectives=True', 10)

    def derive_block_size(self) -> int:
        """Resolved pooled-arena block size (kv_block_size default)."""
        if self.kv_block_size is not None:
            return self.kv_block_size
        bs = min(64, self.max_seq_len)
        if self.prefix_cache_mb and self.prefix_block:
            bs = math.gcd(bs, self.prefix_block)
        return bs


def validate_context(gen_config: GeneratorConfig, model_config) -> None:
    """The engine's context window must fit the model's positional
    ceiling."""
    if gen_config.max_seq_len > model_config.max_seq_len:
        raise ValueError(
            f'GeneratorConfig.max_seq_len={gen_config.max_seq_len} '
            f'exceeds the model\'s context ceiling '
            f'{model_config.max_seq_len} (for Mistral this is the '
            f'sliding window — serving beyond it would silently change '
            f'attention semantics)')


def prepare_params(params, gen_config: GeneratorConfig):
    """Apply GeneratorConfig.weights_dtype to a parameter tree: the tree
    itself for None, a copy with int8 linear weights for 'int8' (the
    caller's tree is left as it is)."""
    if gen_config.weights_dtype is None:
        return params
    return quant.quantize_weights(params)


def derive_buckets(gen_config: GeneratorConfig):
    """Prompt buckets for a GeneratorConfig; validates that the largest
    bucket fits max_seq_len."""
    if gen_config.prompt_buckets:
        buckets = sorted(gen_config.prompt_buckets)
    else:
        buckets, b = [], 64
        while b < gen_config.max_seq_len:
            buckets.append(b)
            b *= 2
        buckets.append(gen_config.max_seq_len)
    if buckets[-1] > gen_config.max_seq_len:
        raise ValueError(
            f'Largest prompt bucket {buckets[-1]} exceeds '
            f'max_seq_len {gen_config.max_seq_len}')
    return buckets


def derive_cache_buckets(gen_config: GeneratorConfig):
    """Cache-length buckets of the legacy planes (shared by Generator
    and ContinuousBatcher).  The largest is forced to max_seq_len, so
    any admitted generation can run to the context ceiling."""
    if gen_config.cache_buckets:
        buckets = sorted(set(int(b) for b in gen_config.cache_buckets))
        if buckets[0] <= 0:
            raise ValueError(
                f'cache_buckets must be positive, got {buckets}')
        if buckets[-1] > gen_config.max_seq_len:
            raise ValueError(
                f'Largest cache bucket {buckets[-1]} exceeds '
                f'max_seq_len {gen_config.max_seq_len}')
        if buckets[-1] != gen_config.max_seq_len:
            buckets.append(gen_config.max_seq_len)
        return buckets
    buckets, b = [], 64
    while b < gen_config.max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(gen_config.max_seq_len)
    return buckets


def default_pool_blocks(gen_config: GeneratorConfig, model_config,
                        block_size: int, table_width: int) -> int:
    """"Cannot exhaust" pool sizing (GeneratorConfig.pool_blocks None):
    every slot to max_seq_len, plus the prefix cache's whole byte budget,
    plus the garbage block."""
    n_blocks = 1 + gen_config.batch_size * table_width
    if gen_config.prefix_cache_mb:
        n_blocks += int(gen_config.prefix_cache_mb * 1e6
                        // block_pool_lib.block_nbytes(
                            model_config, block_size,
                            gen_config.kv_cache_dtype)) + 1
    return n_blocks


def cache_bucket_for(cache_buckets: Sequence[int], rows: int) -> int:
    """Smallest cache bucket with at least `rows` position rows (the
    largest, max_seq_len, when none has)."""
    for b in cache_buckets:
        if rows <= b:
            return b
    return cache_buckets[-1]


def migrate_cache(cache, cache_len: int, target: int, migrations: dict):
    """Resize a legacy cache's position axis from `cache_len` to `target`
    rows (one copy of the cache on the device), counted in
    migrations['grow'] or ['shrink']; returns the new cache."""
    migrations['grow' if target > cache_len else 'shrink'] += 1
    return llama_infer.resize_cache(cache, target)


def host_fetch(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """THE device -> host transfer point of the decode data path: every
    fetch of decode results (token blocks, positions, done flags) goes
    through this one call, so the contract of O(1) transfers per decode
    CHUNK, never per token, is countable (``host_fetch.calls``) and
    testable.  Several tensors fetched together count as ONE sync."""
    host_fetch.calls += 1
    return tuple(t.to('cpu').numpy() for t in tensors)


host_fetch.calls = 0


def commit_step(nxt: torch.Tensor, token: torch.Tensor,
                positions: torch.Tensor, done: torch.Tensor,
                limit: torch.Tensor, *, eos: Optional[int], fill: int):
    """One decode step's per-row bookkeeping on the device: live rows
    emit their sampled token, spend one of their budget, stop on eos or
    an empty budget, and advance; done rows FREEZE (position and feed
    token stay) and emit `fill`.  Returns (emit, token, positions, done,
    limit)."""
    live = torch.logical_not(done)
    live_i = live.to(torch.int32)
    emit = torch.where(live, nxt, fill)
    limit = limit - live_i
    hit = (limit <= 0) if eos is None else (nxt == eos) | (limit <= 0)
    done = done | (live & hit)
    return (emit, torch.where(live, nxt, token), positions + live_i, done,
            limit)


# One capture stream per device for every engine of the process, as
# torch.cuda.graph shares one: cuBLAS keeps a workspace for each stream
# it has run on until the process ends, so a stream per engine would
# leak a workspace per engine.  (Two engines must not capture at once.)
_CAPTURE_STREAMS = {}


class _CudaGraphs:
    """The card's side of :class:`ChunkGraphs`: the capture stream and one
    memory pool for all of an engine's graphs (they never run at once),
    with the engine's sampling generators registered in each graph so
    that every replay draws fresh noise."""

    def __init__(self, device: torch.device, generators):
        self.device = device
        self.generators = tuple(generators)
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        if index not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
        self.stream = _CAPTURE_STREAMS[index]
        self.pool = torch.cuda.graph_pool_handle()

    def clear(self) -> None:
        """Start a new memory pool: a pool whose graphs are all gone
        cannot take another capture.  (The old pool's memory returns to
        the card when the allocator next empties its cache.)"""
        self.pool = torch.cuda.graph_pool_handle()

    def eager(self, body):
        """body() on the capture stream, ordered after the work queued on
        the current stream and before the work queued on it later."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = body()
        current.wait_stream(self.stream)
        return out

    def capture(self, body):
        """(graph, body's outputs): body recorded, not run.  Thread-local
        capture mode: a handler thread's CUDA work cannot invalidate it.
        (``torch.cuda.graph`` would also collect garbage and empty the
        allocator's cache first: seconds in a process that holds tens of
        GB cached, to free memory that the pool does not need.)"""
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(self.device)       # as torch.cuda.graph
        with torch.cuda.stream(self.stream):
            graph.capture_begin(self.pool, capture_error_mode='thread_local')
            try:
                out = body()
            finally:
                graph.capture_end()
        return graph, out


@dataclasses.dataclass
class _Captured:
    graph: object
    out: object                    # body's outputs, rewritten by replay()
    launches: Tuple[int, ...]      # launch counts one replay adds


class ChunkGraphs:
    """An engine's device chunks as CUDA graphs, one per static key: the
    counterpart of the reference's jit of each chunk program per static
    argument set (``jax.disable_jit`` is the engines' ``graphs=False``).

    ``run(key, body)``: the first call of a key runs body() eagerly (the
    chunk's real work, and every first use inside it: the kernel
    library's load, shared-memory attributes, cached rope tables, cuBLAS
    workspaces), then captures body into a graph, which launches nothing;
    each later call replays the graph and returns the tensors that the
    capture returned, rewritten.  So body must read and write only
    tensors whose addresses hold across calls (the engine's fixed rows
    and tables, the arena, the weights), allocate the rest inside itself,
    and decide nothing on the host from device values; a caller drops the
    graphs (:meth:`clear`) when it replaces a tensor they read.

    The kernel wrappers count launches in Python (``_kernels.COUNTERS``):
    a capture ticks them though no kernel runs, and a replay launches
    without ticking them.  So a capture records the counts it added and
    restores them, and each replay adds that delta: the counts go on
    meaning kernels that ran.

    A failed capture or replay raises; nothing falls back to eager.
    `backend` stands in for the card (tests): ``eager(body)``,
    ``capture(body) -> (graph, outputs)`` with ``graph.replay()``, and
    ``clear()``."""

    def __init__(self, device: torch.device, generators=(), backend=None):
        self.backend = backend or _CudaGraphs(device, generators)
        self._graphs = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0

    def keys(self):
        return list(self._graphs)

    def clear(self) -> None:
        """Drop every graph (their inputs are about to be replaced)."""
        self._graphs.clear()
        self.backend.clear()

    def run(self, key, body):
        entry = self._graphs.get(key)
        if entry is not None:
            entry.graph.replay()
            _kernels.set_launch_counts(
                [a + b for a, b in zip(_kernels.launch_counts(),
                                       entry.launches)])
            self.replays += 1
            return entry.out
        out = self.backend.eager(body)
        start = time.perf_counter()
        before = _kernels.launch_counts()
        try:
            graph, captured = self.backend.capture(body)
            delta = tuple(a - b for a, b in zip(_kernels.launch_counts(),
                                                before))
        finally:
            _kernels.set_launch_counts(before)
        self._graphs[key] = _Captured(graph, captured, delta)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - start
        return out


def chunk_graphs(graphs: Optional[bool], device: torch.device,
                 generators=()) -> Optional[ChunkGraphs]:
    """An engine's ``graphs`` argument resolved: None captures on a CUDA
    device and runs eagerly on the CPU; True on the CPU raises."""
    if graphs is None:
        graphs = device.type == 'cuda'
    if not graphs:
        return None
    if device.type != 'cuda':
        raise ValueError(f'graphs=True captures CUDA graphs and needs a '
                         f'CUDA device, got {device}')
    return ChunkGraphs(device, generators)


def run_chunk(graphs: Optional[ChunkGraphs], key, body):
    """body() through graphs' entry for key, or eagerly without graphs."""
    return body() if graphs is None else graphs.run(key, body)


def store_rows(rows: Sequence[torch.Tensor],
               values: Sequence[torch.Tensor]) -> None:
    """Copy a chunk's final carry (token, positions, done, limit) into
    the engine's fixed rows in place: a graph reads and writes them at
    their addresses."""
    for row, value in zip(rows, values):
        row.copy_(value)


@dataclasses.dataclass
class DecodeState:
    """Host-side view of one generation in flight."""
    tokens: List[int]
    done: bool = False


class Generator:
    """Single-model generation engine: up to batch_size rows decoded in
    lockstep, each finishing on its own (eos, or its token budget).

    Prompts are right-padded to a prompt bucket and prefilled in one
    forward; decode runs n-step chunks with sampling and per-row eos and
    budget tracking on the device and ONE host fetch a chunk.  The
    pooled plane keeps one block arena for the Generator's lifetime and
    grows per-row block tables (with speculative verify chunks under
    spec_k); the legacy planes allocate the contiguous cache at the
    smallest cache bucket that covers the prompts and migrate it
    (``llama_infer.resize_cache``) when a chunk would cross a bucket
    edge.

    On a CUDA device the pooled plane's decode chunk (per n) and verify
    chunk are captured once as CUDA graphs and replayed (``self.graphs``)
    across generate() calls, over fixed rows and tables; the legacy
    planes allocate a fresh cache in every generate() and stay eager."""

    def __init__(self, params, config, gen_config: GeneratorConfig =
                 GeneratorConfig(), mesh=None, device=None,
                 graphs: Optional[bool] = None):
        """params: on `device` (default: the CUDA card); mesh: not
        ported yet.  graphs: as ContinuousBatcher's (None = on for a
        CUDA device on the pooled plane, off on the CPU and on a legacy
        plane; True on the CPU or on a legacy plane raises)."""
        if mesh is not None:
            raise _deferred('Generator(mesh=...)', 10)
        self.device = resolve_device(device)
        validate_context(gen_config, config)
        self.params = prepare_params(params, gen_config)
        self.config = config
        self.gen = gen_config
        self.buckets = derive_buckets(gen_config)
        self.cache_buckets = derive_cache_buckets(gen_config)
        if gen_config.decode_chunk < 1:
            raise ValueError(f'decode_chunk must be >= 1, got '
                             f'{gen_config.decode_chunk}')
        batch = gen_config.batch_size
        self.pooled = gen_config.decode_impl == 'pooled'
        self.pool = None
        if self.pooled:
            bs = gen_config.derive_block_size()
            self.block_size = bs
            self.table_width = -(-gen_config.max_seq_len // bs)
            n_blocks = gen_config.pool_blocks
            if n_blocks is None:
                n_blocks = default_pool_blocks(gen_config, config, bs,
                                               self.table_width)
            self.pool = block_pool_lib.BlockPool(
                config, n_blocks, bs, kv_dtype=gen_config.kv_cache_dtype,
                device=self.device)
            self._host_tables = np.zeros((batch, self.table_width),
                                         np.int32)
            self._row_blocks: List[List[int]] = [[] for _ in range(batch)]
            self._tables_dev = torch.as_tensor(self._host_tables,
                                               device=self.device)
            self._tables_dirty = False
        else:
            self._decode_fn = llama_infer.get_decode_fn(
                gen_config.decode_impl)
        self._drafter = None
        if self.pooled and gen_config.spec_k:
            self._drafter = spec_decode_lib.NgramDrafter(batch,
                                                         gen_config.spec_k)
            self._spec_policy = spec_decode_lib.SpecPolicy()
        # Noise of sampled (temperature > 0) generations, reseeded by
        # generate(seed=...).
        self._rng = torch.Generator(device=self.device)
        # The decode carry (token, positions, done, limit), read and
        # written in place by every chunk, and the drafter's proposals.
        self._rows = tuple(
            torch.zeros((batch,), dtype=dtype, device=self.device)
            for dtype in (torch.int32, torch.int32, torch.bool, torch.int32))
        if self._drafter is not None:
            self._draft = torch.zeros((batch, gen_config.spec_k),
                                      dtype=torch.int32, device=self.device)
        if not self.pooled and graphs:
            raise _deferred(f"graphs=True on the legacy "
                            f"'{gen_config.decode_impl}' plane of the "
                            f'Generator', 15)
        self.graphs = chunk_graphs(graphs if self.pooled else False,
                                   self.device, (self._rng,))
        # Radix prefix cache (None = off): a prompt matching cached head
        # blocks prefills only its suffix, in prefix_block windows
        # through the start-offset path.  Pooled: the matched blocks
        # splice into the row's table (no device copy); legacy: they are
        # installed into the fresh slot cache.
        self.prefix = prefix_cache.make_prefix_cache(gen_config,
                                                     pool=self.pool)
        # Legacy-plane bucket migrations over the Generator's lifetime.
        self.migrations = {'grow': 0, 'shrink': 0}
        # Counts of the last generate(): seconds to the first token,
        # decode seconds and tokens, host fetches, final cache rows.
        self.last_stats: dict = {}

    # ---- device pieces ---------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sampling.sample_logits(
            logits, self._rng, temperature=self.gen.temperature,
            top_k=self.gen.top_k, top_p=self.gen.top_p)

    def _prefill(self, tokens: torch.Tensor, lengths: torch.Tensor, cache,
                 tables_scatter: Optional[np.ndarray]) -> torch.Tensor:
        """Prefill (B, bucket) prompts; returns next-token logits.  The
        pooled plane prefills into a scratch cache and scatters each row
        into its arena blocks (tables_scatter (B, nb)); a legacy cache
        is filled in place."""
        if tables_scatter is None:
            logits, _ = llama_infer.prefill(self.params, tokens, self.config,
                                            cache, lengths)
            return logits
        nb = tables_scatter.shape[1]
        scratch = llama_infer.init_cache(
            self.config, tokens.shape[0], nb * self.block_size,
            kv_dtype=self.gen.kv_cache_dtype, device=self.device)
        logits, scratch = llama_infer.prefill(self.params, tokens,
                                              self.config, scratch, lengths)
        llama_infer.scatter_prefill_pooled(
            scratch, cache, torch.as_tensor(tables_scatter,
                                            device=self.device))
        return logits

    def _prefix_prefill(self, prompts, cache) -> torch.Tensor:
        """Warm prefill: per row, put the longest-prefix-matched blocks in
        place (pooled: a table splice; legacy: install copies into the
        slot cache), window-prefill only the suffix in prefix_block
        windows, and insert the prompt's head blocks into the trie.  No
        host sync here (the caller's first-token fetch is the barrier).
        Returns next-token logits (B, vocab) f32 (zeros on pad rows)."""
        pc = self.prefix
        blk = pc.block
        dev = self.device
        rows = []
        for i, p in enumerate(prompts):
            m = pc.match(p)
            pc.commit(m)
            if self.pooled:
                ids = pc.splice(m)
                self._host_tables[i, :len(ids)] = ids
                self._row_blocks[i].extend(ids)
                need = -(-len(p) // self.block_size)
                if need > len(ids):
                    fresh = self.pool.alloc(need - len(ids))
                    self._host_tables[i, len(ids):need] = fresh
                    self._row_blocks[i].extend(fresh)
                self._tables_dirty = True
                table_row = torch.as_tensor(self._host_tables[i], device=dev)
            else:
                pc.install(cache, i, m)
            h_last = None
            last_start = start = m.tokens
            while start < len(p):
                end = min(start + blk, len(p))
                window = np.zeros((blk,), np.int32)
                window[:end - start] = np.asarray(p[start:end], np.int32)
                window_t = torch.as_tensor(window, device=dev)
                if self.pooled:
                    h_last, _ = llama_infer.prefill_window_pooled(
                        self.params, window_t, self.config, cache,
                        table_row, start)
                else:
                    h_last, _ = llama_infer.prefill_window(
                        self.params, window_t, self.config, cache, i, start)
                last_start = start
                start = end
            m.release()
            rows.append(quant.matmul(
                h_last[len(p) - 1 - last_start][None],
                self.params['lm_head'], out_dtype=torch.float32)[0])
            if self.pooled:
                # The row's own blocks back the new trie nodes (shared).
                pc.insert(p, blocks=self._row_blocks[i])
            else:
                pc.insert(p, functools.partial(pc.extract, cache, i))
        rows.extend(torch.zeros_like(rows[0])
                    for _ in range(self.gen.batch_size - len(prompts)))
        return torch.stack(rows)

    def _decode_chunk_impl(self, token, cache, positions, done, limit,
                           tables, n: int):
        """n decode steps on the device with in-loop sampling and per-row
        eos/budget tracking (:func:`commit_step`): no host sync inside.
        Returns (the (B, n) token block, token, positions, done,
        limit); the cache is updated in place."""
        eos = self.gen.eos_token
        fill = eos if eos is not None else 0
        toks = []
        for _ in range(n):
            if self.pooled:
                logits, _ = llama_infer.decode_step_pooled(
                    self.params, token, self.config, cache, positions,
                    tables)
            else:
                logits, _ = self._decode_fn(self.params, token, self.config,
                                            cache, positions)
            emit, token, positions, done, limit = commit_step(
                self._sample(logits), token, positions, done, limit,
                eos=eos, fill=fill)
            toks.append(emit)
        return torch.stack(toks, dim=1), token, positions, done, limit

    def _verify_chunk_impl(self, token, cache, positions, done, limit,
                           tables, draft):
        """One draft-verify chunk on the device: the last committed token
        plus the k drafted proposals through the W = k + 1 verify
        forward, the target's token at every window position, and the
        agreeing prefix committed with the sequential chunk's eos/limit
        semantics.  Returns (emitted (B, W), token, positions, done,
        limit, committed (B,))."""
        eos = self.gen.eos_token
        logits, _ = llama_infer.decode_verify_pooled(
            self.params, torch.cat([token[:, None], draft], dim=1),
            self.config, cache, positions, tables)
        if self.gen.temperature == 0.0:
            targets, accepts = sampling.spec_accept_greedy(logits, draft)
        else:
            batch = token.shape[0]
            t_row = torch.full((batch,), self.gen.temperature,
                               dtype=torch.float32, device=self.device)
            top_p = self.gen.top_p
            p_row = torch.full((batch,), top_p if top_p is not None else 1.0,
                               dtype=torch.float32, device=self.device)
            targets, accepts = sampling.spec_accept_sampled(
                logits, draft, self._rng, t_row, p_row, top_k=self.gen.top_k,
                nucleus=top_p is not None and 0.0 < top_p < 1.0)
        return spec_decode_lib.accept_window(
            targets, accepts, done, limit, positions, token, eos=eos,
            fill=eos if eos is not None else 0)

    # ---- host bookkeeping ------------------------------------------------
    def _ensure_blocks(self, rows, host_positions, n: int) -> None:
        """Grow the block tables so every live row can write through
        position + n - 1 this chunk: ids from the free list appended to
        the host mirror, uploaded once per chunk if it changed."""
        for i in rows:
            need = -(-(int(host_positions[i]) + n) // self.block_size)
            need = min(need, self.table_width)
            have = len(self._row_blocks[i])
            if need > have:
                ids = self.pool.alloc(need - have)
                self._host_tables[i, have:need] = ids
                self._row_blocks[i].extend(ids)
                self._tables_dirty = True

    def _upload_tables(self) -> None:
        """Rewrite the one tables tensor in place from the host mirror (a
        captured graph reads it at its address)."""
        if self._tables_dirty:
            self._tables_dev.copy_(torch.from_numpy(self._host_tables))
            self._tables_dirty = False

    def _chunk(self, cache, n: int) -> torch.Tensor:
        """An n-step decode chunk over the fixed rows, replayed from its
        graph (key n) when graphs are on; returns the (B, n) token
        block."""
        tables = self._tables_dev if self.pooled else None

        def body():
            token, positions, done, limit = self._rows
            toks, *carry = self._decode_chunk_impl(token, cache, positions,
                                                   done, limit, tables, n)
            store_rows(self._rows, carry)
            return toks
        return run_chunk(self.graphs, ('decode', n), body)

    def _verify_chunk(self, cache, draft: np.ndarray):
        """One verify chunk over the fixed rows on the drafter's (B, k)
        proposals, replayed from its graph when graphs are on; returns
        (emitted (B, W), committed (B,))."""
        self._draft.copy_(torch.from_numpy(draft))

        def body():
            token, positions, done, limit = self._rows
            toks, *carry, committed = self._verify_chunk_impl(
                token, cache, positions, done, limit, self._tables_dev,
                self._draft)
            store_rows(self._rows, carry)
            return toks, committed
        return run_chunk(self.graphs, ('verify',), body)

    def _release_rows(self) -> None:
        """Drop every row's blocks and zero the table mirror, so freed
        blocks can never be addressed again."""
        for i in range(self.gen.batch_size):
            if self._row_blocks[i]:
                self.pool.release(self._row_blocks[i])
                self._row_blocks[i] = []
        self._host_tables[:] = 0
        self._tables_dirty = True

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(
            f'Prompt length {length} exceeds the largest bucket '
            f'{self.buckets[-1]} (max_seq_len {self.gen.max_seq_len})')

    def warmup(self, bucket: Optional[int] = None) -> None:
        """Run the smallest prompt bucket's prefill and one full decode
        chunk, so the first request sees steady-state latency."""
        self.generate([[1] * 2], max_new_tokens=min(
            1 + self.gen.decode_chunk, self.gen.max_seq_len - 2),
            _bucket=bucket or self.buckets[0])

    # ---- entry point -----------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 64, seed: int = 0,
                 _bucket: Optional[int] = None) -> List[List[int]]:
        """prompts: token-id lists (at most batch_size).  Returns the
        newly generated ids per row (prompt not included)."""
        batch = self.gen.batch_size
        if len(prompts) > batch:
            raise ValueError(f'{len(prompts)} prompts > batch {batch}')
        if any(len(p) == 0 for p in prompts):
            raise ValueError('Empty prompt')
        lengths = [len(p) for p in prompts]
        bucket = _bucket or self._bucket_for(max(lengths))
        max_new = min(max_new_tokens, self.gen.max_seq_len - max(lengths))
        if max_new <= 0:
            return [[] for _ in prompts]
        dev = self.device
        tokens = np.zeros((batch, bucket), np.int32)
        lens = np.ones((batch,), np.int32)  # pad rows: length 1
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = np.asarray(p, np.int32)
            lens[i] = len(p)
        tokens_t = torch.as_tensor(tokens, device=dev)
        lens_t = torch.as_tensor(lens, device=dev)
        self._rng.manual_seed(seed)

        prefill_start = time.perf_counter()
        tables_scatter = None
        if self.pooled:
            # Each row owns blocks covering the prompt bucket; decode
            # grows the tables, so there is no cache length to migrate.
            cache_len = self.table_width * self.block_size
            cache = self.pool.arena
        else:
            # The smallest bucket covering the prefill write (bucket
            # rows) and the first decode write (max prompt len + 1).
            cache_len = cache_bucket_for(self.cache_buckets,
                                         max(bucket, max(lengths) + 1))
            cache = llama_infer.init_cache(
                self.config, batch, cache_len,
                kv_dtype=self.gen.kv_cache_dtype, device=dev)
        try:
            if self.prefix is not None:
                # Per-row windows, so matched head blocks are skipped and
                # missed prompts still fill the trie.
                logits = self._prefix_prefill(prompts, cache)
            elif self.pooled:
                nb = -(-bucket // self.block_size)
                tables_scatter = np.zeros((batch, nb), np.int32)
                for i in range(batch):
                    ids = self.pool.alloc(nb)
                    self._host_tables[i, :nb] = ids
                    self._row_blocks[i].extend(ids)
                    tables_scatter[i] = ids
                self._tables_dirty = True
        except block_pool_lib.PoolExhaustedError:
            # Return the rows claimed so far.
            self._release_rows()
            raise
        if self.prefix is None:
            logits = self._prefill(tokens_t, lens_t, cache, tables_scatter)
        token = self._sample(logits)
        # The host fetch is the barrier that makes this a real time to
        # the first token.
        (first_host,) = host_fetch(token)
        syncs = 1
        ttft = time.perf_counter() - prefill_start

        eos = self.gen.eos_token
        out: List[List[int]] = [[] for _ in range(batch)]
        finished = [False] * batch

        def absorb(host_tokens: np.ndarray, counts=None) -> bool:
            """Append a (B, n) host chunk, trimming at eos; counts (spec
            chunks): only the first counts[i] columns of row i were
            committed.  True once every requested row has finished."""
            for i in range(len(prompts)):
                row = host_tokens[i]
                if counts is not None:
                    row = row[:int(counts[i])]
                for t in row:
                    if finished[i] or len(out[i]) >= max_new:
                        break
                    out[i].append(int(t))
                    if eos is not None and int(t) == eos:
                        finished[i] = True
            return all(finished[i] or len(out[i]) >= max_new
                       for i in range(len(prompts)))

        if self._drafter is not None:
            # Each row's n-gram table starts from its prompt and the
            # trie's cached continuation of it (tokens another request
            # already decoded after the shared head).
            for i, p in enumerate(prompts):
                cont = (self.prefix.cached_continuation(
                    p, self.gen.max_seq_len)
                    if self.prefix is not None else ())
                self._drafter.reset(i, p, cont)
                self._drafter.observe(i, [int(first_host[i])])

        # Device rows: done rows freeze inside a chunk (pad rows start
        # done, a first-token eos finishes a row before any chunk);
        # limit is the budget left after the first token.
        host_positions = lens.copy()
        host_done = np.ones((batch,), bool)
        limit0 = np.zeros((batch,), np.int32)
        for i in range(len(prompts)):
            host_done[i] = eos is not None and int(first_host[i]) == eos
            limit0[i] = max_new - 1
        token_row, positions, done_row, limit_row = self._rows
        token_row.copy_(token)
        positions.copy_(lens_t)
        done_row.copy_(torch.from_numpy(host_done))
        limit_row.copy_(torch.from_numpy(limit0))

        decode_seconds = 0.0
        dispatched = 0
        # Row-steps of the plain chunks in which a row decoded a token
        # (its position advanced), against the dispatched n x rows.
        live_steps = 0
        try:
            if absorb(first_host[:, None]):
                return [out[i] for i in range(len(prompts))]
            chunk = self.gen.decode_chunk
            while True:
                live = [i for i in range(len(prompts))
                        if not host_done[i] and not finished[i]
                        and len(out[i]) < max_new]
                if not live:
                    break
                # A FULL chunk whenever the context allows, even past
                # max_new (the device limit freezes rows, the host
                # trims); a shorter one only at the context ceiling.
                live_max = max(int(host_positions[i]) for i in live)
                win = self.gen.spec_k + 1
                if (self._drafter is not None
                        and live_max + win <= self.gen.max_seq_len
                        and self._spec_policy.should_speculate()):
                    self._ensure_blocks(live, host_positions, win)
                    self._upload_tables()
                    draft = self._drafter.propose_batch(live, batch)
                    chunk_start = time.perf_counter()
                    toks, committed = self._verify_chunk(cache, draft)
                    (host_toks, host_positions, host_done,
                     host_committed) = host_fetch(toks, positions, done_row,
                                                  committed)
                    syncs += 1
                    decode_seconds += time.perf_counter() - chunk_start
                    accepted = sum(max(int(host_committed[i]) - 1, 0)
                                   for i in live)
                    self._spec_policy.record(accepted,
                                             self.gen.spec_k * len(live))
                    dispatched += sum(int(host_committed[i]) for i in live)
                    for i in live:
                        c = int(host_committed[i])
                        if c:
                            self._drafter.observe(i, host_toks[i, :c])
                    if absorb(host_toks, host_committed):
                        break
                    continue
                n = min(chunk, self.gen.max_seq_len - live_max)
                if n <= 0:
                    break
                prev_pos = {i: int(host_positions[i]) for i in live}
                if self.pooled:
                    # Growth is a free-list append to the host tables.
                    self._ensure_blocks(live, host_positions, n)
                    self._upload_tables()
                else:
                    # Frozen rows (eos, spent budget, pad rows) still
                    # write K/V at their position every step, while the
                    # bucket follows the live rows only: park them at
                    # row 0, inside even the smallest bucket, so a
                    # shrink never leaves a write past the cache's end.
                    positions.masked_fill_(done_row, 0)
                    # Bucket crossing: this chunk's last write lands at
                    # row live_max + n - 1, so migrate before dispatch.
                    target = cache_bucket_for(self.cache_buckets,
                                              live_max + n)
                    if target != cache_len:
                        cache = migrate_cache(cache, cache_len, target,
                                              self.migrations)
                        cache_len = target
                chunk_start = time.perf_counter()
                toks = self._chunk(cache, n)
                # ONE transfer for the whole chunk: the token block and
                # the rows that steer the next iteration.
                prev_host = host_positions
                host_toks, host_positions, host_done = host_fetch(
                    toks, positions, done_row)
                syncs += 1
                decode_seconds += time.perf_counter() - chunk_start
                dispatched += n * len(prompts)
                # (A legacy plane parked done rows at row 0: no step.)
                live_steps += int(np.clip(host_positions - prev_host, 0,
                                          None).sum())
                if self._drafter is not None:
                    # Keep the n-gram history current through the plain
                    # chunks too: each row's valid prefix is its
                    # position delta.
                    for i in live:
                        delta = int(host_positions[i]) - prev_pos[i]
                        if delta > 0:
                            self._drafter.observe(i, host_toks[i, :delta])
                if absorb(host_toks):
                    break
            return [out[i] for i in range(len(prompts))]
        finally:
            if self.pooled:
                # Every row's blocks return: free + live == total holds
                # between generate() calls.
                self._release_rows()
            self.last_stats = {
                'ttft_s': ttft, 'decode_seconds': decode_seconds,
                'decode_tokens': dispatched, 'host_fetches': syncs,
                'live_slot_steps': live_steps,
                'cache_len': cache_len,
                'generated_tokens': sum(len(out[i])
                                        for i in range(len(prompts)))}
