"""CheckpointManager: interval/async saves, retention GC, discovery,
emergency (preemption) saves.

Counterpart of skypilot_tpu/ckpt/manager.py.  The manager owns one
checkpoint root and composes the pieces:

- ``save(step, pytree)`` — device→host snapshot on the caller thread,
  then the sharded-format write + atomic commit either inline
  (``blocking=True``) or on the bounded background writer.
- ``should_save(step)`` — interval gate (``save_interval_steps``).
- retention GC — after each commit (and only then), keep the newest
  ``keep_last`` checkpoints plus every step divisible by ``keep_every``;
  delete the rest.  GC runs post-commit on the writer thread, so a
  failed save can never delete the checkpoints it was meant to replace.
- ``latest_step()`` / ``restore_latest()`` — discovery that trusts only
  committed dirs; restore verifies shard hashes and walks down to the
  next older step on corruption (counted in
  ``skytpu_ckpt_corrupt_skips_total``).
- ``install_signal_handlers()`` — SIGTERM (and any maintenance signal
  the caller picks) triggers one blocking emergency save of the state
  returned by the registered provider, then chains to the previous
  handler so normal termination semantics are preserved.  A caller that
  updates that state in place in several statements (the port's
  optimizer writes leaf after leaf) wraps the update in
  ``hold_signals()``: a signal landing inside is handled when the block
  ends, so the emergency save sees the state between two steps, as the
  JAX package's handler does around its one jitted step.

Multihost: pass ``process_index``/``process_count`` (default: the
``torch.distributed`` rank and world size when a process group is
initialised, else (0, 1)) and every process writes its own shard files;
process 0 commits the manifest and GCs.  When ``process_count > 1`` and
no ``barrier`` is supplied, the manager wires
``torch.distributed.barrier`` as the cross-process rendezvous — saves are
never allowed to run barrier-less on multihost (see ckpt/format.py for
the clean/write/commit protocol).

Legacy Orbax dirs (``step_<N>`` with neither manifest nor marker) are
discovered as the JAX package discovers them, but this package cannot
read them: ``restore`` raises, and ``restore_latest`` walks past them.
"""
from __future__ import annotations

import contextlib
import logging
import os
import signal as signal_module
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.ckpt import format as format_lib
from skypilot_tpu_torch.ckpt.writer import AsyncCheckpointWriter
from skypilot_tpu_torch.telemetry import metrics

logger = logging.getLogger(__name__)


class LegacyCheckpointError(Exception):
    """A committed step this package cannot read (a legacy Orbax dir)."""


def _default_process_grid() -> Tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _multihost_barrier(tag: str) -> None:
    """Default multihost rendezvous: every process blocks until all
    processes reach the same point (the tag orders nothing here: every
    process passes the same barriers in the same order)."""
    del tag
    torch.distributed.barrier()


def _snapshot(pytree):
    """A host copy of every leaf, on the caller thread.

    This is the synchronization point of an async save: ``.to('cpu')``
    of a tensor on the card waits for the work that produced it.  The
    copy is forced for CPU tensors and numpy arrays too: the trainer
    updates its parameters in place, and a save must hold the values of
    the step it was asked for, not of a later one."""
    named, treedef = format_lib.flatten_with_keys(pytree)

    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to('cpu', copy=True)
        return np.array(leaf, copy=True)

    return format_lib.tree_unflatten(treedef,
                                     [copy(leaf) for _, leaf in named])


class CheckpointManager:
    """Manages the checkpoints of one training run under one root."""

    def __init__(self,
                 directory: str,
                 save_interval_steps: int = 0,
                 keep_last: Optional[int] = None,
                 keep_every: Optional[int] = None,
                 max_pending: int = 2,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 barrier: Optional[Callable[[str], None]] = None,
                 max_consecutive_failures: int = 3,
                 shard_spec: Optional[format_lib.ShardSpecFn] = None):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f'keep_last must be >= 1, got {keep_last}')
        self.directory = directory
        self.save_interval_steps = save_interval_steps
        self.keep_last = keep_last
        self.keep_every = keep_every
        default_index, default_count = _default_process_grid()
        self.process_index = (default_index if process_index is None
                              else process_index)
        self.process_count = (default_count if process_count is None
                              else process_count)
        if barrier is None and self.process_count > 1:
            # Multihost saves must rendezvous or process 0's staging
            # cleanup / commit races the peer shard writes.
            barrier = _multihost_barrier
        self._barrier = barrier
        # Layout of saves AND the default restore window per process:
        # None = replicated whole-leaf round-robin (the classic layout);
        # e.g. format.even_row_shard = axis-0 partitioning per process.
        self.shard_spec = shard_spec
        self.max_consecutive_failures = max_consecutive_failures
        self._writer = AsyncCheckpointWriter(
            max_pending=max_pending,
            depth_callback=metrics.CKPT_QUEUE_DEPTH.set)
        self._save_lock = threading.Lock()
        self._save_lock_owner: Optional[threading.Thread] = None
        self._state_provider: Optional[Callable[[], Tuple[int, Any]]] = None
        self._prev_handlers: Dict[int, Any] = {}
        self._in_emergency_save = False
        # hold_signals(): nesting depth, and the signals that landed
        # inside, handled when the outermost block ends.
        self._hold_depth = 0
        self._held: List[Tuple[int, Any]] = []
        # Guards the save-status fields below, which the writer thread
        # mutates while the step loop reads them.  RLock, not Lock: the
        # SIGTERM emergency-save path runs on the main thread and must
        # not self-deadlock if the signal lands while the main thread
        # already holds it.
        self._status_lock = threading.RLock()
        self._last_saved_step: Optional[int] = None
        self._consecutive_failures = 0
        self._last_write_error: Optional[BaseException] = None

    # -- interval gate -----------------------------------------------------
    def should_save(self, step: int) -> bool:
        if self.save_interval_steps <= 0:
            return False
        with self._status_lock:
            if step == self._last_saved_step:
                return False
        return step % self.save_interval_steps == 0

    # -- save --------------------------------------------------------------
    def save(self, step: int, pytree,
             blocking: bool = False,
             metadata: Optional[Dict[str, Any]] = None,
             kind: Optional[str] = None) -> None:
        """Checkpoint ``pytree`` as ``step``.

        blocking=False: snapshot here, write/commit on the background
        writer (the step loop keeps running).  blocking=True: the full
        pipeline runs on the caller thread.  Either way the on-disk
        commit is atomic (see ckpt/format.py).

        Blocking saves surface write errors directly.  Async save
        errors are re-raised from ``wait_until_finished()``; to keep a
        persistently failing writer (disk full, dead mount) from
        silently eating every checkpoint of a long run, ``save`` itself
        fails once ``max_consecutive_failures`` async saves in a row
        have failed."""
        with self._status_lock:
            failures = self._consecutive_failures
            last_error = self._last_write_error
        if not blocking and failures >= self.max_consecutive_failures:
            raise RuntimeError(
                f'{failures} consecutive checkpoint '
                f'saves under {self.directory} failed; refusing to '
                f'queue more (last error: {last_error!r})'
            ) from last_error
        kind = kind or ('blocking' if blocking else 'interval')
        start = time.perf_counter()
        host_tree = _snapshot(pytree)
        snapshot_s = time.perf_counter() - start
        metrics.CKPT_SAVE_SECONDS.labels(phase='snapshot').observe(
            snapshot_s)
        with self._status_lock:
            self._last_saved_step = step
        if blocking:
            self._write_and_commit(step, host_tree, metadata, kind)
            metrics.CKPT_SAVE_SECONDS.labels(phase='blocking').observe(
                time.perf_counter() - start)
        else:
            self._writer.submit(
                lambda: self._write_and_commit(step, host_tree, metadata,
                                               kind))

    def wait_until_finished(self) -> None:
        """Block until every queued async save has committed; re-raises
        the first failure."""
        self._writer.wait_until_finished()

    def close(self) -> None:
        self._writer.close()
        self.uninstall_signal_handlers()

    def _write_and_commit(self, step: int, host_tree,
                          metadata: Optional[Dict[str, Any]],
                          kind: str) -> None:
        try:
            self._do_write_and_commit(step, host_tree, metadata, kind)
        except BaseException as e:
            with self._status_lock:
                self._consecutive_failures += 1
                self._last_write_error = e
                if self._last_saved_step == step:
                    # The step was NOT durably saved; let a retry through
                    # should_save and keep latest-save bookkeeping honest.
                    self._last_saved_step = None
            raise
        with self._status_lock:
            self._consecutive_failures = 0

    def _do_write_and_commit(self, step: int, host_tree,
                             metadata: Optional[Dict[str, Any]],
                             kind: str) -> None:
        start = time.perf_counter()
        with self._save_lock:
            # Written only under _save_lock; the one cross-thread reader
            # is the SIGTERM emergency-save path, which deliberately
            # reads it lock-free (taking a lock in a signal handler
            # could self-deadlock) and tolerates a stale value.
            self._save_lock_owner = threading.current_thread()
            try:
                # Stale-staging cleanup happens inside save_pytree, on
                # process 0 only, before the pre-write barrier — never
                # here, where it would race peer processes' writes.
                committed = format_lib.save_pytree(
                    self.directory, step, host_tree,
                    process_index=self.process_index,
                    process_count=self.process_count,
                    metadata=dict(metadata or {}, kind=kind,
                                  time=time.time()),
                    barrier=self._barrier,
                    shard_spec=self.shard_spec)
                if committed is not None:
                    manifest = format_lib.load_manifest(self.directory,
                                                        step)
                    metrics.CKPT_BYTES_WRITTEN.inc(manifest.get('bytes', 0))
                    metrics.CKPT_SAVES.labels(kind=kind).inc()
                    self._gc()
            finally:
                self._save_lock_owner = None
        metrics.CKPT_SAVE_SECONDS.labels(phase='write').observe(
            time.perf_counter() - start)
        logger.debug(f'Checkpoint step {step} committed under '
                     f'{self.directory} ({kind})')

    # -- retention ---------------------------------------------------------
    def _gc(self) -> None:
        """Post-commit retention: keep the newest ``keep_last`` steps and
        every ``keep_every`` multiple; delete other committed steps.
        Only process 0 (the committer) GCs.  Legacy Orbax step dirs are
        exempt: the manager only ever deletes checkpoints it wrote."""
        if self.keep_last is None or self.process_index != 0:
            return
        committed, _ = format_lib.scan_steps(self.directory)
        sharded = [info for info in committed if info.fmt == 'sharded']
        steps = [info.step for info in sharded]
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep.update(s for s in steps if s % self.keep_every == 0)
        for info in sharded:
            if info.step in keep:
                continue
            try:
                format_lib.remove_step(self.directory, info.step)
                metrics.CKPT_GC_DELETED.inc()
            except OSError as e:
                logger.warning(f'Checkpoint GC could not remove step '
                               f'{info.step}: {e}')

    # -- discovery / restore ----------------------------------------------
    def latest_step(self) -> Optional[int]:
        """Newest committed step (uncommitted/torn dirs are skipped and
        counted in skytpu_ckpt_corrupt_skips_total)."""
        committed, corrupt = format_lib.scan_steps(self.directory)
        if corrupt:
            metrics.CKPT_CORRUPT_SKIPS.inc(len(corrupt))
            logger.warning(
                f'Skipping {len(corrupt)} uncommitted/torn checkpoint '
                f'dir(s) under {self.directory}: {corrupt}')
        return committed[-1].step if committed else None

    def all_steps(self) -> List[int]:
        committed, _ = format_lib.scan_steps(self.directory)
        return [info.step for info in committed]

    def writer_topology(self, step: int) -> Optional[int]:
        """Process count of the grid that WROTE ``step`` (None for
        legacy Orbax dirs, which carry no manifest)."""
        info = self._step_info(step)
        if info is None or info.fmt != 'sharded':
            return None
        manifest = format_lib.load_manifest(self.directory, step)
        return int(manifest.get('process_count', 1))

    def restore(self, step: int, template) -> Any:
        """Restore one step as CPU tensors shaped like template.
        Checkpoints are hash-verified.  When the checkpoint was written
        by a different process grid than this manager's (or in a sharded
        layout), the restore goes through the resharding path — a
        topology change can never make a committed checkpoint
        unrestorable."""
        self._checked_step_info(step)
        writer_count = self.writer_topology(step)
        if writer_count != self.process_count or self.shard_spec is not None:
            return self.restore_resharded(step, template)
        restored = format_lib.restore_pytree(self.directory, step, template)
        metrics.CKPT_RESTORES.inc()
        return restored

    def restore_resharded(self, step: int, template,
                          shard_spec: Optional[
                              format_lib.ShardSpecFn] = None) -> Any:
        """Restore ``step`` under THIS manager's process grid, whatever
        grid wrote it.  Each leaf is loaded by global index-map: only
        shard files overlapping this process's window (``shard_spec``,
        default the manager's own; None → the full replicated leaf) are
        read and hash-verified, then re-sliced to the current topology.
        Works for any N→M process-count change — grow, shrink, or
        down-to-single-host — in both sharded and replicated layouts."""
        self._checked_step_info(step)
        stats: Dict[str, int] = {}
        start = time.perf_counter()
        restored = format_lib.restore_pytree_resharded(
            self.directory, step, template,
            shard_spec=shard_spec or self.shard_spec,
            process_index=self.process_index,
            process_count=self.process_count,
            stats=stats)
        elapsed = time.perf_counter() - start
        writer_count = int(stats.get('writer_process_count', 1))
        if writer_count < self.process_count:
            direction = 'grow'
        elif writer_count > self.process_count:
            direction = 'shrink'
        else:
            direction = 'same'
        metrics.CKPT_RESHARD_RESTORES.labels(direction=direction).inc()
        metrics.CKPT_RESHARD_SECONDS.observe(elapsed)
        metrics.CKPT_RESHARD_BYTES_READ.inc(stats.get('bytes_read', 0))
        metrics.CKPT_RESHARD_SHARDS_SKIPPED.inc(
            stats.get('files_skipped', 0))
        metrics.CKPT_RESTORES.inc()
        logger.info(
            f'Resharded restore of step {step}: writer grid '
            f'{writer_count} -> reader grid {self.process_count} '
            f'({direction}), {stats.get("files_read", 0)} shard(s) '
            f'read / {stats.get("files_skipped", 0)} skipped, '
            f'{stats.get("bytes_read", 0)} bytes in {elapsed:.3f}s')
        return restored

    def restore_latest(self, template) -> Optional[Tuple[int, Any]]:
        """Restore the newest trustworthy checkpoint, walking down past
        corrupt steps (each skip is logged + counted).  Returns
        (step, pytree) or None when nothing restorable exists."""
        committed, corrupt = format_lib.scan_steps(self.directory)
        if corrupt:
            metrics.CKPT_CORRUPT_SKIPS.inc(len(corrupt))
            logger.warning(
                f'Skipping {len(corrupt)} uncommitted/torn checkpoint '
                f'dir(s) under {self.directory}: {corrupt}')
        for info in reversed(committed):
            try:
                restored = self.restore(info.step, template)
            except (format_lib.CorruptCheckpointError,
                    LegacyCheckpointError) as e:
                metrics.CKPT_CORRUPT_SKIPS.inc()
                logger.warning(f'Checkpoint step {info.step} '
                               f'unrestorable, trying older: {e}')
                continue
            return info.step, restored
        return None

    def _step_info(self, step: int) -> Optional[format_lib.StepInfo]:
        committed, _ = format_lib.scan_steps(self.directory)
        for info in committed:
            if info.step == step:
                return info
        return None

    def _checked_step_info(self, step: int) -> format_lib.StepInfo:
        info = self._step_info(step)
        if info is None:
            raise FileNotFoundError(
                f'No committed checkpoint for step {step} under '
                f'{self.directory}')
        if info.fmt == 'orbax':
            raise LegacyCheckpointError(
                f'{info.path} is a legacy Orbax checkpoint (no manifest, '
                f'no {format_lib.MARKER} marker); this package reads only '
                f'the sharded format: restore it with the JAX package and '
                f'save it again')
        return info

    # -- emergency save ----------------------------------------------------
    def register_state_provider(
            self, provider: Callable[[], Tuple[int, Any]]) -> None:
        """Register the callable the emergency path snapshots:
        ``provider() -> (step, pytree)``."""
        self._state_provider = provider

    def install_signal_handlers(
            self, signals: Tuple[int, ...] = (signal_module.SIGTERM,)
    ) -> bool:
        """Install the emergency-save hook; returns False when not on
        the main thread (signal.signal is main-thread-only)."""
        if self._state_provider is None:
            raise RuntimeError('register_state_provider first')
        try:
            for sig in signals:
                self._prev_handlers[sig] = signal_module.signal(
                    sig, self._handle_signal)
        except ValueError:
            # Not the main thread: callers on worker threads (e.g. a
            # managed-job monitor) simply don't get the hook.
            logger.warning('Emergency-save signal hook skipped: not on '
                           'the main thread')
            self._prev_handlers.clear()
            return False
        return True

    def uninstall_signal_handlers(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal_module.signal(sig, prev)
            except (ValueError, TypeError, OSError) as e:
                logger.debug(f'Could not restore handler for signal '
                             f'{sig}: {e}')
        self._prev_handlers.clear()

    @contextlib.contextmanager
    def hold_signals(self) -> Iterator[None]:
        """Defer the emergency-save signals across a block that updates
        the provider's state in place.  A signal landing inside is
        handled when the outermost block ends: the emergency save then
        sees the whole update, never part of it.  If the block raises,
        the state may be torn, so the held signals only chain to the
        previous handlers, with no save."""
        self._hold_depth += 1
        completed = False
        try:
            yield
            completed = True
        finally:
            self._hold_depth -= 1
            if not self._hold_depth and self._held:
                held, self._held = self._held, []
                for signum, frame in held:
                    self._handle_signal(signum, frame, save=completed)

    def _handle_signal(self, signum, frame, save: bool = True) -> None:
        if self._hold_depth:
            self._held.append((signum, frame))
            return
        if save and not self._in_emergency_save:
            self._in_emergency_save = True
            try:
                self.emergency_save()
            finally:
                self._in_emergency_save = False
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal_module.SIG_DFL:
            # Preserve termination semantics: re-deliver with the
            # default handler so SIGTERM still terminates the process.
            signal_module.signal(signum, signal_module.SIG_DFL)
            os.kill(os.getpid(), signum)

    def emergency_save(self) -> Optional[int]:
        """One blocking save of the provider's current state (skipped if
        that step is already committed).  Returns the step saved."""
        if self._state_provider is None:
            return None
        if self._save_lock_owner is threading.current_thread():
            # The signal interrupted this very thread mid-save: the
            # in-flight blocking save already covers the state, and
            # waiting on the non-reentrant save lock we hold ourselves
            # would deadlock until SIGKILL.
            logger.info('Emergency save skipped: a blocking save on '
                        'this thread is already in flight')
            return None
        metrics.CKPT_EMERGENCY_SAVES.inc()
        step, pytree = self._state_provider()
        if step in set(self.all_steps()):
            logger.info(f'Emergency save: step {step} already '
                        f'committed; nothing to do')
            return step
        logger.info(f'Emergency save of step {step} to {self.directory}')
        # Drain queued async saves first: their snapshots are older than
        # ours, and the writer thread shares the save lock.
        try:
            self.wait_until_finished()
        except Exception as e:  # pylint: disable=broad-except
            logger.warning(f'Pending async save failed during emergency '
                           f'drain (continuing): {e}')
        self.save(step, pytree, blocking=True, kind='emergency')
        return step
