"""The metric families that the Trainer, the checkpoint manager, the
prefix cache, the block pool and the host KV tier update.

Counterpart of the ``TRAIN_*``, ``CKPT_*``, ``INFER_PREFIX_*``,
``INFER_POOL_PREFIX_SHARES`` and ``INFER_TIER_*`` families of
skypilot_tpu/telemetry/metrics.py, with the same family names, labels and
buckets.  They live on the port's own prometheus registry, ``REGISTRY``
(read a sample with ``REGISTRY.get_sample_value(name, labels)``); the
JAX package's families stay on its own.  An update is a mutex-guarded
float add, no I/O.
"""
from __future__ import annotations

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
