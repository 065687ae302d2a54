"""Opt-in torch.profiler windows around the data-plane hot loops.

Counterpart of skypilot_tpu/telemetry/profiler.py under the same
variable: setting SKYTPU_PROFILE_DIR makes Trainer.fit wrap its steady
section in a ``torch.profiler`` trace (host and, on a card, device
activity), so a production run can be profiled by flipping one env var;
the env check is the only cost when it is unset.

Each window writes ``<SKYTPU_PROFILE_DIR>/<name>-pid<pid>/trace.json``, a
Chrome trace that Perfetto and chrome://tracing load.  Windows never
nest (one trace at a time per process) and never raise: a profiler
failure must not take down the loop it observes.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Iterator

import torch

ENV_VAR = 'SKYTPU_PROFILE_DIR'

logger = logging.getLogger(__name__)

_ACTIVE = threading.Lock()


@contextlib.contextmanager
def profile_window(name: str) -> Iterator[None]:
    base = os.environ.get(ENV_VAR)
    if not base or not _ACTIVE.acquire(blocking=False):
        yield
        return
    prof = None
    path = os.path.join(os.path.expanduser(base), f'{name}-pid{os.getpid()}')
    try:
        try:
            os.makedirs(path, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as e:  # pylint: disable=broad-except
            logger.warning(f'profile window {name} not started: {e!r}')
            prof = None
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(path, 'trace.json'))
            except Exception as e:  # pylint: disable=broad-except
                logger.warning(f'profile window {name} not written: {e!r}')
        _ACTIVE.release()
