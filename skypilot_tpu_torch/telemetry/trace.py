"""Trace-context propagation: one request/trace id through every
process a request touches.

A copy of skypilot_tpu/telemetry/trace.py (the port imports nothing of
the JAX package), with the same header, variable and payload key, so a
trace id minted by the JAX package's load balancer or API server keys
the port's batcher spans and the other way round.  The id travels:
- in-process: a contextvar (the replica binds it around ``submit``
  from the request's X-Skytpu-Trace-Id header);
- cross-request: the X-Skytpu-Trace-Id HTTP header and the
  `_trace_id` payload key;
- cross-process: the SKYTPU_TRACE_ID env var (``propagation_envs``).

get_trace_id() resolves contextvar first, env second.  Standard library
only.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import uuid
from typing import Iterator, Optional

ENV_VAR = 'SKYTPU_TRACE_ID'
TRACE_HEADER = 'X-Skytpu-Trace-Id'
# Payload key the server middleware stamps so the (other-thread)
# executor can recover the request's trace context.
PAYLOAD_KEY = '_trace_id'

_TRACE_ID: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    'skytpu_trace_id', default=None)


def new_trace_id() -> str:
    """Same shape as requests_lib request ids (uuid4 hex, 16 chars)."""
    return uuid.uuid4().hex[:16]


def get_trace_id() -> Optional[str]:
    return _TRACE_ID.get() or os.environ.get(ENV_VAR) or None


@contextlib.contextmanager
def trace_scope(trace_id: Optional[str]) -> Iterator[None]:
    """Bind trace_id to the current context for the with-block
    (no-op when trace_id is falsy)."""
    if not trace_id:
        yield
        return
    token = _TRACE_ID.set(trace_id)
    try:
        yield
    finally:
        _TRACE_ID.reset(token)


def propagation_envs() -> dict:
    """Env vars that carry the current telemetry context into a child
    process tree (the backend merges these into the job spec's envs):
    the trace id, plus the timeline file path so every process of one
    launch appends spans to the SAME trace file (timeline.save merges
    under a file lock)."""
    envs = {}
    trace_id = get_trace_id()
    if trace_id:
        envs[ENV_VAR] = trace_id
    timeline_file = os.environ.get('SKYTPU_TIMELINE_FILE')
    if timeline_file:
        envs['SKYTPU_TIMELINE_FILE'] = os.path.abspath(
            os.path.expanduser(timeline_file))
    profile_dir = os.environ.get('SKYTPU_PROFILE_DIR')
    if profile_dir:
        envs['SKYTPU_PROFILE_DIR'] = os.path.abspath(
            os.path.expanduser(profile_dir))
    return envs
