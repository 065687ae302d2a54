"""The metric families of the port's data plane: the Trainer, the
checkpoint manager, the serving engines (prefill, decode chunks, queue
wait, slot occupancy, host syncs, bucket chunks, migrations,
speculation, fused steps, step phases), the prefix cache, the block
pool, the host KV tier and the per-tenant cost ledger.

Counterpart of the ``TRAIN_*``, ``CKPT_*``, ``INFER_*`` and ``ACCT_*``
families of skypilot_tpu/telemetry/metrics.py, with the same family
names, labels and buckets (the ``INFER_MESH_*`` families of sharded
serving among them), and of its ``histogram_quantile``; and of the
serving fleet's ``SERVE_*`` families (policies, autoscalers, failover,
chaos, disaggregation, SLO burn) and ``DOCTOR_INCIDENTS``, with
``record_autoscaler_decisions``.  They live on the port's own
prometheus registry, ``REGISTRY`` (read a sample with
``REGISTRY.get_sample_value(name, labels)``); the
JAX package's families stay on its own.  An update is a mutex-guarded
float add, no I/O.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import prometheus_client

REGISTRY = prometheus_client.CollectorRegistry()

_SECONDS = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 15, 60, 300)

# ---- train (train/trainer.py) ------------------------------------------

TRAIN_STEP_SECONDS = prometheus_client.Histogram(
    'skytpu_train_step_duration_seconds',
    'Train step wall time; phase=warmup covers the first steps (each '
    'ends in a host fetch), phase=steady is the end-to-end-timed block '
    '(per-step average, one final fetch), phase=sync one run_step that '
    'ends in a device synchronize (SKYTPU_STEP_METRICS set)',
    ['phase'], buckets=_SECONDS[:-1], registry=REGISTRY)

TRAIN_TOKENS_PER_SEC = prometheus_client.Gauge(
    'skytpu_train_tokens_per_second',
    'Steady-state training throughput (all cards)', registry=REGISTRY)

TRAIN_MFU = prometheus_client.Gauge(
    'skytpu_train_mfu_ratio',
    'Model FLOPs utilization of the steady block (0..1)', registry=REGISTRY)

TRAIN_LOSS = prometheus_client.Gauge(
    'skytpu_train_loss', 'Most recently fetched training loss',
    registry=REGISTRY)

TRAIN_GRAD_NORM = prometheus_client.Gauge(
    'skytpu_train_grad_norm', 'Most recently fetched global gradient norm',
    registry=REGISTRY)

TRAIN_STEPS = prometheus_client.Counter(
    'skytpu_train_steps_total', 'Train steps dispatched', registry=REGISTRY)

# ---- ckpt (ckpt/manager.py, ckpt/writer.py) ----------------------------

CKPT_SAVE_SECONDS = prometheus_client.Histogram(
    'skytpu_ckpt_save_duration_seconds',
    'Checkpoint save wall time; phase=snapshot is the caller-thread '
    'device->host copy (the only stall an async save imposes on the '
    'step loop), phase=write is the background serialize+hash+commit, '
    'phase=blocking is an end-to-end synchronous save',
    ['phase'], buckets=_SECONDS, registry=REGISTRY)

CKPT_BYTES_WRITTEN = prometheus_client.Counter(
    'skytpu_ckpt_bytes_written_total',
    'Checkpoint shard + manifest bytes written to storage',
    registry=REGISTRY)

CKPT_QUEUE_DEPTH = prometheus_client.Gauge(
    'skytpu_ckpt_async_queue_depth',
    'Async checkpoint saves in flight (snapshots taken, bytes not yet '
    'committed); bounded by the writer double-buffer', registry=REGISTRY)

CKPT_SAVES = prometheus_client.Counter(
    'skytpu_ckpt_saves_total',
    'Committed checkpoint saves, by kind (interval/blocking/emergency)',
    ['kind'], registry=REGISTRY)

CKPT_RESTORES = prometheus_client.Counter(
    'skytpu_ckpt_restores_total', 'Successful checkpoint restores',
    registry=REGISTRY)

CKPT_CORRUPT_SKIPS = prometheus_client.Counter(
    'skytpu_ckpt_corrupt_skips_total',
    'Checkpoint step dirs skipped by discovery/restore as untrustworthy '
    '(uncommitted, torn commit, bad hash, unreadable manifest)',
    registry=REGISTRY)

CKPT_EMERGENCY_SAVES = prometheus_client.Counter(
    'skytpu_ckpt_emergency_saves_total',
    'Emergency saves triggered by SIGTERM/maintenance signals',
    registry=REGISTRY)

CKPT_GC_DELETED = prometheus_client.Counter(
    'skytpu_ckpt_gc_deleted_total',
    'Committed checkpoints deleted by retention GC (keep_last/keep_every)',
    registry=REGISTRY)

CKPT_RESHARD_RESTORES = prometheus_client.Counter(
    'skytpu_ckpt_reshard_restores_total',
    'Resharded (topology-crossing) checkpoint restores, by direction '
    'relative to the writer grid: grow = more reader processes, '
    'shrink = fewer (incl. down-to-single-host), same = equal grid '
    'but windowed/sharded layout',
    ['direction'], registry=REGISTRY)

CKPT_RESHARD_SECONDS = prometheus_client.Histogram(
    'skytpu_ckpt_reshard_restore_duration_seconds',
    'Wall time of one resharded restore: global index-map planning + '
    'reading only the shard files overlapping this process window + '
    'window assembly', buckets=_SECONDS, registry=REGISTRY)

CKPT_RESHARD_BYTES_READ = prometheus_client.Counter(
    'skytpu_ckpt_reshard_bytes_read_total',
    'Shard bytes read by resharded restores (only files overlapping '
    'the requested windows are read)', registry=REGISTRY)

CKPT_RESHARD_SHARDS_SKIPPED = prometheus_client.Counter(
    'skytpu_ckpt_reshard_shards_skipped_total',
    'Shard files skipped by resharded restores because they do not '
    'overlap this process window', registry=REGISTRY)

# ---- infer prefix cache (infer/prefix_cache.py) ------------------------

INFER_PREFIX_HITS = prometheus_client.Counter(
    'skytpu_infer_prefix_hits_total',
    'Admissions whose prompt longest-prefix-matched >=1 cached block '
    'in the radix prefix KV cache (prefill skipped the matched head)',
    registry=REGISTRY)

INFER_PREFIX_MISSES = prometheus_client.Counter(
    'skytpu_infer_prefix_misses_total',
    'Admissions with the prefix cache enabled that matched no cached '
    'block (full prefill from token 0)',
    registry=REGISTRY)

INFER_PREFIX_TOKENS_SAVED = prometheus_client.Counter(
    'skytpu_infer_prefix_tokens_saved_total',
    'Prompt tokens whose prefill compute was skipped because their K/V '
    'was installed from the prefix cache instead',
    registry=REGISTRY)

INFER_PREFIX_EVICTIONS = prometheus_client.Counter(
    'skytpu_infer_prefix_evictions_total',
    'Prefix-cache blocks evicted by the byte-budget LRU '
    '(prefix_cache_mb); ref-counted in-use blocks are never evicted',
    registry=REGISTRY)

INFER_PREFIX_BYTES = prometheus_client.Gauge(
    'skytpu_infer_prefix_bytes',
    'Device bytes currently pinned by prefix-cache K/V blocks',
    registry=REGISTRY)

# ---- infer block pool (infer/block_pool.py) ----------------------------

INFER_POOL_PREFIX_SHARES = prometheus_client.Counter(
    'skytpu_infer_pool_prefix_block_shares_total',
    'Refcount shares of arena blocks between prefix-cache nodes and '
    'live sequences (each share replaces an install/extract device '
    'copy of one block)',
    registry=REGISTRY)

# ---- infer host KV tier (infer/kv_tier.py) -----------------------------

INFER_TIER_BLOCKS = prometheus_client.Gauge(
    'skytpu_infer_tier_blocks',
    'KV blocks per residency tier: device = arena blocks pinned by the '
    'prefix cache, host = DRAM-resident spilled blocks, inflight = '
    'blocks with a spill or prefetch copy outstanding',
    ['tier'],
    registry=REGISTRY)

INFER_TIER_SPILL_BYTES = prometheus_client.Counter(
    'skytpu_infer_tier_spill_bytes_total',
    'KV bytes copied device -> host DRAM by the async spill engine '
    '(evicted prefix-cache blocks that stay warm instead of being '
    'freed-and-forgotten)',
    registry=REGISTRY)

INFER_TIER_SPILL_SECONDS = prometheus_client.Counter(
    'skytpu_infer_tier_spill_seconds_total',
    'Seconds the spill copies took (on a card: the side stream\'s '
    'device-to-host copies, timed with CUDA events); '
    'rate(bytes)/rate(seconds) is the achieved spill bandwidth',
    registry=REGISTRY)

INFER_TIER_PREFETCH_BYTES = prometheus_client.Counter(
    'skytpu_infer_tier_prefetch_bytes_total',
    'KV bytes staged host DRAM -> device by the prefetch engine '
    '(host-resident prefixes pulled back into arena blocks ahead of '
    'admission)',
    registry=REGISTRY)

INFER_TIER_PREFETCH_SECONDS = prometheus_client.Counter(
    'skytpu_infer_tier_prefetch_seconds_total',
    'Seconds the prefetch copies took (the copy thread\'s staging '
    'copy plus, on a card, the host-to-device copy timed with CUDA '
    'events); rate(bytes)/rate(seconds) is the achieved prefetch '
    'bandwidth',
    registry=REGISTRY)

INFER_TIER_LOOKUPS = prometheus_client.Counter(
    'skytpu_infer_tier_lookups_total',
    'Admission tier consults by outcome: device_hit (served from the '
    'device-resident trie), host_hit (host-resident prefix — request '
    'parks on a prefetch), miss (cold prefill)',
    ['outcome'],
    registry=REGISTRY)

INFER_TIER_PREFETCH_LATE = prometheus_client.Counter(
    'skytpu_infer_tier_prefetch_late_total',
    'Requests that parked at admission because their prefetch had not '
    'landed yet — a high rate means routing hints fire too late (or '
    'not at all) relative to request arrival',
    registry=REGISTRY)

# ---- infer (infer/engine.py, infer/serving.py) -----------------------

INFER_PREFILL_SECONDS = prometheus_client.Histogram(
    'skytpu_infer_prefill_duration_seconds',
    'Prefill dispatch-to-first-token wall time, by prompt bucket',
    ['bucket'],
    buckets=(0.002, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 10, 60),
    registry=REGISTRY)

INFER_DECODE_CHUNK_SECONDS = prometheus_client.Histogram(
    'skytpu_infer_decode_chunk_duration_seconds',
    'On-device decode chunk wall time (dispatch to host fetch)',
    buckets=(0.002, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 10, 60),
    registry=REGISTRY)

INFER_QUEUE_WAIT_SECONDS = prometheus_client.Histogram(
    'skytpu_infer_queue_wait_seconds',
    'Continuous-batcher admission wait: submit() to slot assignment',
    buckets=(0.001, 0.01, 0.05, 0.25, 1, 5, 15, 60, 300),
    registry=REGISTRY)

INFER_SLOT_OCCUPANCY = prometheus_client.Gauge(
    'skytpu_infer_slot_occupancy_ratio',
    'Active decode slots / batch_size after the last scheduler tick',
    registry=REGISTRY)

INFER_STEADY_TOKENS_PER_SEC = prometheus_client.Gauge(
    'skytpu_infer_steady_tokens_per_second',
    'Decode throughput of the most recent chunk/generation '
    '(tokens dispatched / decode wall time, all slots)',
    registry=REGISTRY)

INFER_GENERATED_TOKENS = prometheus_client.Counter(
    'skytpu_infer_generated_tokens_total',
    'Tokens returned to callers (post eos/max-token trim)',
    registry=REGISTRY)

INFER_HOST_SYNCS = prometheus_client.Counter(
    'skytpu_infer_host_syncs_total',
    'Device→host transfers on the decode data path (engine.host_fetch '
    'calls) — the sync-free streaming contract is O(1) per decode '
    'chunk, not per token',
    registry=REGISTRY)

INFER_HOST_SYNCS_PER_TOKEN = prometheus_client.Gauge(
    'skytpu_infer_host_syncs_per_token',
    'Host syncs / generated tokens of the most recent generation or '
    'scheduler tick (1.0 would mean a round-trip per token; fused '
    'multi-step decode targets 1/decode_chunk)',
    registry=REGISTRY)

INFER_DECODE_CACHE_ROWS = prometheus_client.Gauge(
    'skytpu_infer_decode_cache_rows',
    'Position capacity (rows) of the live KV cache bucket the decode '
    'loop is currently compiled against',
    registry=REGISTRY)

INFER_DECODE_BUCKET_CHUNKS = prometheus_client.Counter(
    'skytpu_infer_decode_bucket_chunks_total',
    'Decode chunks dispatched per cache-length bucket (bucket '
    'occupancy: which compiled cache sizes actually serve traffic)',
    ['bucket'],
    registry=REGISTRY)

INFER_CACHE_MIGRATIONS = prometheus_client.Counter(
    'skytpu_infer_cache_migrations_total',
    'KV cache bucket migrations (pad-grow or truncate-shrink of the '
    'position axis) — each costs one cache copy on device',
    ['direction'],
    registry=REGISTRY)

# ---- infer block pool gauges (infer/block_pool.py) -------------------

INFER_POOL_BLOCKS_TOTAL = prometheus_client.Gauge(
    'skytpu_infer_pool_blocks_total',
    'Physical KV blocks in the pooled arena (including the reserved '
    'garbage block 0)',
    registry=REGISTRY)

INFER_POOL_BLOCKS_LIVE = prometheus_client.Gauge(
    'skytpu_infer_pool_blocks_live',
    'Arena blocks currently referenced by >=1 sequence block table or '
    'prefix-cache node (refcount > 0)',
    registry=REGISTRY)

INFER_POOL_BLOCKS_FREE = prometheus_client.Gauge(
    'skytpu_infer_pool_blocks_free',
    'Arena blocks on the free list (allocatable; free + live + 1 '
    'garbage == total at all times)',
    registry=REGISTRY)

INFER_POOL_HWM = prometheus_client.Gauge(
    'skytpu_infer_pool_hwm',
    'High-water mark of live arena blocks since pool creation — the '
    'number to size pool_blocks against',
    registry=REGISTRY)

INFER_POOL_TABLE_APPENDS = prometheus_client.Counter(
    'skytpu_infer_pool_block_table_appends_total',
    'Blocks appended to sequence block tables from the free list (the '
    'pooled replacement for bucket grow migrations: an append is a '
    'table write, not a cache copy)',
    registry=REGISTRY)

# ---- infer serving mesh (infer/tp.py, infer/serving.py) ---------------

INFER_MESH_DEVICES = prometheus_client.Gauge(
    'skytpu_infer_mesh_devices',
    'Serving-mesh axis sizes (axis = dp | tp | tpq); set at engine '
    'construction, absent on single-chip engines',
    ['axis'],
    registry=REGISTRY)

INFER_MESH_COLLECTIVE_TIME_SHARE = prometheus_client.Gauge(
    'skytpu_infer_mesh_collective_time_share',
    'Estimated fraction of a sharded decode chunk spent in collectives '
    '(1 - single-device time / mesh time per token, clamped to [0, 1]; '
    'measured by bench_mesh, an efficiency complement rather than a '
    'per-op trace)',
    registry=REGISTRY)

INFER_MESH_OVERLAP_RATIO = prometheus_client.Gauge(
    'skytpu_infer_mesh_overlap_ratio',
    'Hidden-communication fraction of the overlapped sharded decode '
    'path: 1 - overlapped collective share / sync collective share, '
    'clamped to [0, 1] (0 = sync path or no hiding; measured by '
    'bench_mesh from the sync-vs-overlapped step timings)',
    registry=REGISTRY)

INFER_MESH_COLLECTIVE_SECONDS = prometheus_client.Counter(
    'skytpu_infer_mesh_collective_seconds',
    'Cumulative estimated seconds sharded decode steps spent in '
    'collectives, split by combine schedule (mode = sync | '
    'overlapped); fed by the StepProfiler collective phase (the '
    'decode/verify/fused share reattributed via the measured '
    'collective_time_share) and by bench_mesh',
    ['mode'],
    registry=REGISTRY)

INFER_MESH_POOL_BLOCKS_PER_SHARD = prometheus_client.Gauge(
    'skytpu_infer_mesh_pool_blocks_live_per_shard',
    'Live arena blocks each tp shard holds a KV-head slice of (block '
    'ids are global — sharding splits heads, not blocks — so this '
    'equals blocks_live; exported only for sharded pools so per-shard '
    'HBM dashboards need no join against the mesh shape)',
    registry=REGISTRY)

# ---- infer speculative decoding (infer/serving.py, infer/engine.py) ---

INFER_SPEC_PROPOSED = prometheus_client.Counter(
    'skytpu_infer_spec_proposed_tokens_total',
    'Draft tokens proposed by the speculative n-gram drafter (spec_k '
    'per live slot per verify chunk)',
    registry=REGISTRY)

INFER_SPEC_ACCEPTED = prometheus_client.Counter(
    'skytpu_infer_spec_accepted_tokens_total',
    'Draft tokens the target model accepted (each one is a decode '
    'token produced WITHOUT its own sequential forward)',
    registry=REGISTRY)

INFER_SPEC_ACCEPT_RATE = prometheus_client.Histogram(
    'skytpu_infer_spec_chunk_accept_rate',
    'Per-verify-chunk draft acceptance rate (accepted / proposed '
    'across live slots); the adaptive SpecPolicy gates speculation on '
    'an EMA of this',
    buckets=(0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
    registry=REGISTRY)

INFER_SPEC_TOKENS_PER_SYNC = prometheus_client.Gauge(
    'skytpu_infer_spec_tokens_per_host_sync',
    'Committed tokens per counted host_fetch of the last generation '
    'or tick with speculation enabled (the inverse of '
    'host_syncs_per_token; rises with acceptance)',
    registry=REGISTRY)

# ---- infer chunked-prefill piggyback (infer/fuse.py, serving.py) -----

INFER_FUSE_STEPS = prometheus_client.Counter(
    'skytpu_infer_fuse_steps_total',
    'Fused prefill+decode chunks dispatched (one chunked-prefill '
    'window piggybacked onto a lockstep decode chunk)',
    registry=REGISTRY)

INFER_FUSE_PREFILL_TOKENS = prometheus_client.Counter(
    'skytpu_infer_fuse_prefill_tokens_total',
    'Real prompt tokens carried by fused steps\' prefill lanes '
    '(excludes the fixed fuse_budget padding)',
    registry=REGISTRY)

INFER_FUSE_BUDGET_UTILIZATION = prometheus_client.Gauge(
    'skytpu_infer_fuse_budget_utilization_ratio',
    'Fraction of the last fused step\'s fuse_budget-wide prefill lane '
    'carrying real prompt tokens (chronically low: lower fuse_budget '
    'or raise decode_chunk)',
    registry=REGISTRY)

INFER_FUSE_TTFT = prometheus_client.Histogram(
    'skytpu_infer_fuse_ttft_seconds',
    'Submit-to-first-token latency of chunked prefills, split by '
    'whether any window piggybacked on a decode chunk (fused) or '
    'every window ran dedicated (cold)',
    ['mode'],
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
             60),
    registry=REGISTRY)

# ---- step-phase attribution (telemetry/spans.py, infer/serving.py) ---

INFER_STEP_PHASE_SECONDS = prometheus_client.Histogram(
    'skytpu_infer_step_phase_seconds',
    'Host time one batcher step() spent in each exclusive phase '
    '(admit / prefill / fused / spec_draft / spec_verify / decode / '
    'host_fetch / upload / tier_wait); phases sum to ~step wall time, '
    'so the per-phase rate() ratio is the step-time breakdown',
    ['phase'],
    buckets=(1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1, 5),
    registry=REGISTRY)

INFER_STEP_UTILIZATION = prometheus_client.Gauge(
    'skytpu_infer_step_utilization',
    'Fraction of the last step() wall time attributed to each phase '
    '(instantaneous view of the same breakdown as '
    'skytpu_infer_step_phase_seconds)',
    ['phase'],
    registry=REGISTRY)

# ---- per-tenant cost attribution (telemetry/accounting.py) -----------

ACCT_DEVICE_SECONDS = prometheus_client.Counter(
    'skytpu_acct_device_seconds_total',
    'Exclusive StepProfiler phase wall time apportioned to tenants: '
    'batch-wide phases (decode / fused / spec_verify) split evenly '
    'across the slots active in that step, per-request phases '
    '(prefill / admit) charged to the owning request — summed over a '
    'run the per-tenant totals conserve the profiler wall within 5%',
    ['tenant', 'phase'],
    registry=REGISTRY)

ACCT_TOKENS = prometheus_client.Counter(
    'skytpu_acct_tokens_total',
    'Tokens attributed per tenant, by kind: prefill (prompt tokens '
    'prefilled, including fused/piggybacked chunks) and decode '
    '(committed output tokens)',
    ['tenant', 'kind'],
    registry=REGISTRY)

ACCT_BLOCK_SECONDS = prometheus_client.Counter(
    'skytpu_acct_block_seconds_total',
    'Pooled-KV arena occupancy per tenant: sum over steps of '
    '(blocks held by the tenant\'s slots x step wall seconds) — the '
    'HBM-residency component of a tenant\'s bill',
    ['tenant'],
    registry=REGISTRY)

ACCT_TIER_BYTES = prometheus_client.Counter(
    'skytpu_acct_tier_bytes_total',
    'Host-tier bytes attributed per tenant by direction: spill '
    '(device->host copies of blocks the tenant\'s eviction pressure '
    'displaced) and prefetch (host->device staging its admissions '
    'consumed)',
    ['tenant', 'direction'],
    registry=REGISTRY)

ACCT_SPEC_WASTE_TOKENS = prometheus_client.Counter(
    'skytpu_acct_spec_waste_tokens_total',
    'Speculative-decoding waste per tenant: draft tokens proposed '
    'minus accepted on verify chunks the tenant\'s slots took part in '
    '(the compute the drafter burned without committing output)',
    ['tenant'],
    registry=REGISTRY)

ACCT_REQUESTS = prometheus_client.Counter(
    'skytpu_acct_requests_total',
    'Requests finalized into the cost ledger per tenant',
    ['tenant'],
    registry=REGISTRY)


# ---- serve fleet (serve/load_balancing_policies.py, serve/autoscalers.py)

SERVE_LB_SELECTIONS = prometheus_client.Counter(
    'skytpu_serve_lb_selections_total',
    'Replica selections made by the load-balancing policy, per policy '
    'name (every select_replica that returned a replica)',
    ['policy'],
    registry=REGISTRY)

SERVE_REPLICA_INFLIGHT = prometheus_client.Gauge(
    'skytpu_serve_replica_inflight',
    'In-flight requests per replica as the LB policy sees them '
    '(pre/post execute hook accounting)',
    ['replica'],
    registry=REGISTRY)

SERVE_AFFINITY_HITS = prometheus_client.Counter(
    'skytpu_serve_affinity_hits_total',
    'prefix_affinity selections that landed on the fingerprint\'s '
    'consistent-hash primary owner (warm-cache routing preserved)',
    registry=REGISTRY)

SERVE_AFFINITY_MISSES = prometheus_client.Counter(
    'skytpu_serve_affinity_misses_total',
    'prefix_affinity selections diverted off the primary owner '
    '(bounded-load fallback) or carrying no reusable prompt head',
    registry=REGISTRY)

SERVE_AUTOSCALER_DECISIONS = prometheus_client.Counter(
    'skytpu_serve_autoscaler_decisions_total',
    'Autoscaler decisions emitted, per service and operator',
    ['service', 'operator'],
    registry=REGISTRY)

# ---- serve failover (serve/failover.py, traffic/simulator.py chaos)

SERVE_FAILOVER_SESSIONS = prometheus_client.Counter(
    'skytpu_serve_failover_sessions_total',
    'Sessions moved off a failed or draining replica, by outcome: '
    'recovered (replayed on a survivor after a circuit opened), '
    'handed_off (drained cleanly on preemption notice), lost (no '
    'survivor to replay on), truncated_stream (LB mid-stream failure '
    'with bytes already delivered — ended truncated)',
    ['outcome'],
    registry=REGISTRY)

SERVE_FAILOVER_LATENCY_SECONDS = prometheus_client.Histogram(
    'skytpu_serve_failover_latency_seconds',
    'Fault detection (circuit open) to the first replayed token '
    'delivered on the survivor, per recovered session',
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 120),
    registry=REGISTRY)

SERVE_FAILOVER_REPLAYED_TOKENS = prometheus_client.Counter(
    'skytpu_serve_failover_replayed_tokens_total',
    'Committed tokens re-prefilled on a survivor during session '
    'replay (the exactly-once resume cost; warm prefix hits shrink '
    'the actual prefill charge)',
    registry=REGISTRY)

SERVE_FAILOVER_CIRCUIT_TRANSITIONS = prometheus_client.Counter(
    'skytpu_serve_failover_circuit_transitions_total',
    'Circuit-breaker transitions per replica and new state (open = '
    'consecutive-failure threshold tripped, closed = half-open probe '
    'succeeded)',
    ['replica', 'state'],
    registry=REGISTRY)

SERVE_FAILOVER_BACKPRESSURE_DIVERTS = prometheus_client.Counter(
    'skytpu_serve_failover_backpressure_diverts_total',
    'Requests diverted to another replica after a 503 + Retry-After '
    '(admission backpressure honored instead of retry-storming the '
    'full replica)',
    registry=REGISTRY)

SERVE_CHAOS_FAULTS = prometheus_client.Counter(
    'skytpu_serve_chaos_faults_total',
    'Faults injected by the chaos layer, per kind '
    '(kill / preempt / stall / partition)',
    ['kind'],
    registry=REGISTRY)

# ---- disaggregated prefill/decode serving (serve/disagg.py)

SERVE_DISAGG_HANDOFFS = prometheus_client.Counter(
    'skytpu_serve_disagg_handoffs_total',
    'Prefill->decode KV handoffs, by outcome: shipped (image exported '
    'and sent), ingested (decode replica adopted the image), late '
    '(the decode slot waited past the handoff-late threshold for its '
    'image), failed (no decode target / corrupt image — fell back to '
    'cold prefill)',
    ['outcome'],
    registry=REGISTRY)

SERVE_DISAGG_EXPORT_BYTES = prometheus_client.Counter(
    'skytpu_serve_disagg_export_bytes_total',
    'KV image payload bytes exported by prefill replicas (charged '
    'against the exporter\'s spill bandwidth in the cost model)',
    registry=REGISTRY)

SERVE_DISAGG_INGEST_BYTES = prometheus_client.Counter(
    'skytpu_serve_disagg_ingest_bytes_total',
    'KV image payload bytes adopted by decode replicas (staged to '
    'device through the ordinary tier prefetch path)',
    registry=REGISTRY)

SERVE_DISAGG_TRANSFER_SECONDS = prometheus_client.Histogram(
    'skytpu_serve_disagg_transfer_seconds',
    'Handoff export-to-ingest latency per image: export gather+fetch '
    'through transfer to adoption on the decode replica (the window '
    'the parked request waits out)',
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5),
    registry=REGISTRY)

SERVE_DISAGG_POOL_REPLICAS = prometheus_client.Gauge(
    'skytpu_serve_disagg_pool_replicas',
    'Current replica count per disaggregated pool role '
    '(prefill / decode)',
    ['role'],
    registry=REGISTRY)

# ---- SLO burn (serve/slo.py) and the fleet doctor (telemetry/doctor.py)

SERVE_SLO_BURN_RATE = prometheus_client.Gauge(
    'skytpu_serve_slo_burn_rate',
    'SRE-style error-budget burn rate per rolling window (fast/slow): '
    'violating_fraction / (1 - objective) over the window; 1.0 burns '
    'the budget exactly at the SLO rate, sustained >>1 is page '
    'material',
    ['window'],
    registry=REGISTRY)

DOCTOR_INCIDENTS = prometheus_client.Counter(
    'skytpu_doctor_incidents_total',
    'Incidents opened by the fleet doctor rules engine, per rule code '
    '(see the incident taxonomy in docs/observability.md)',
    ['rule'],
    registry=REGISTRY)


def record_autoscaler_decisions(service_name: str,
                                decisions: List[Any]) -> None:
    """Count a generate_scaling_decisions() result (one inc per
    decision, labeled scale_up/scale_down)."""
    for decision in decisions:
        op = getattr(decision, 'operator', decision)
        op = getattr(op, 'value', op)
        SERVE_AUTOSCALER_DECISIONS.labels(
            service=service_name, operator=str(op).lower()).inc()


def histogram_quantile(hist: prometheus_client.Histogram, q: float,
                       labels: Optional[Dict[str, str]] = None
                       ) -> Optional[float]:
    """Prometheus-style quantile estimate from a histogram's cumulative
    bucket counts (upper-bound of the bucket containing the q-th
    observation — the resolution /metrics consumers get).  labels
    filters to one child; None aggregates every child.  Returns None
    when the histogram is empty."""
    buckets: Dict[float, float] = {}
    for family in hist.collect():
        for sample in family.samples:
            if not sample.name.endswith('_bucket'):
                continue
            if labels and any(sample.labels.get(k) != v
                              for k, v in labels.items()):
                continue
            le = float(sample.labels['le'])
            buckets[le] = buckets.get(le, 0.0) + sample.value
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]           # +Inf bucket = observation count
    if total <= 0:
        return None
    target = q * total
    finite = [b for b in bounds if not math.isinf(b)]
    for le in bounds:
        if buckets[le] >= target:
            # Observations above every finite bound: report the largest
            # finite upper bound (what promQL's histogram_quantile does).
            return finite[-1] if math.isinf(le) and finite else le
    return finite[-1] if finite else None
