"""The metric families that the Trainer and the checkpoint manager update.

Counterpart of the ``TRAIN_*`` and ``CKPT_*`` families of
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
