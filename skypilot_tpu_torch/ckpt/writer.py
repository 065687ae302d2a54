"""Bounded background writer: the async half of the save pipeline.

A copy of skypilot_tpu/ckpt/writer.py.  Split of labor for one async
save (manager.save(blocking=False)):

- caller thread: device→host snapshot (``Tensor.cpu`` — waits for the
  work on the stream that produced the tensors, then copies to host
  RAM).  This is the only stall the train loop pays.
- writer thread: serialize + hash + write shards, commit, retention GC.
  One daemon thread, fed by a bounded queue (``max_pending``, default 2
  = classic double buffering): if saves arrive faster than the disk
  drains them, ``submit`` blocks the caller instead of queueing
  unbounded host snapshots.

Failure contract: a failed write job is logged immediately and the
exception is re-raised from the next ``wait_until_finished()`` — saves
are durability-critical, so errors must not vanish into a daemon
thread.  The queue is drained with blocking ``Queue.get`` (no polling).
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)


class AsyncCheckpointWriter:
    """Single background thread executing queued save closures in order."""

    def __init__(self, max_pending: int = 2,
                 depth_callback: Optional[Callable[[int], None]] = None):
        if max_pending < 1:
            raise ValueError(f'max_pending must be >= 1, got {max_pending}')
        self._queue: 'queue.Queue[Optional[Callable[[], None]]]' = \
            queue.Queue(maxsize=max_pending)
        self._depth_callback = depth_callback
        self._errors: List[BaseException] = []
        self._errors_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- caller side -------------------------------------------------------
    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue a save closure; blocks when max_pending are in flight
        (bounded memory: at most max_pending host snapshots alive)."""
        if self._closed:
            raise RuntimeError('writer is closed')
        self._ensure_thread()
        self._queue.put(job)
        self._report_depth()

    def wait_until_finished(self) -> None:
        """Drain the queue; re-raise the first error since the last wait."""
        self._queue.join()
        self._report_depth()
        with self._errors_lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    @property
    def in_flight(self) -> int:
        return self._queue.unfinished_tasks

    def close(self) -> None:
        """Drain, then stop the thread.  Errors from queued jobs are
        logged (already done at failure time) but not re-raised."""
        self._closed = True
        thread = self._thread
        if thread is None:
            return
        self._queue.put(None)
        thread.join(timeout=60)
        if thread.is_alive():
            # A wedged write (dead NFS/bucket mount) can outlive the join
            # timeout; the daemon thread dies with the process, but make
            # the leak visible instead of silently dropping the handle.
            logger.warning(
                'ckpt-writer thread still alive after 60s close() join; '
                f'{self._queue.unfinished_tasks} job(s) still in flight')
        self._thread = None

    # -- writer side -------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name='ckpt-writer')
            self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                job()
            except BaseException as e:  # noqa: B036 — must survive any job failure
                logger.warning(f'Async checkpoint save failed: {e!r}')
                with self._errors_lock:
                    self._errors.append(e)
            finally:
                self._queue.task_done()
                self._report_depth()

    def _report_depth(self) -> None:
        if self._depth_callback is not None:
            try:
                self._depth_callback(self._queue.unfinished_tasks)
            except Exception as e:  # pylint: disable=broad-except
                logger.debug(f'ckpt queue-depth callback failed: {e}')
