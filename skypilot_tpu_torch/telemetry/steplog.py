"""JSONL step telemetry: an append-only line-per-record stream that
survives where a Prometheus registry cannot (a rank process's registry
dies with the process; its JSONL file stays in the job log dir).

A copy of skypilot_tpu/telemetry/steplog.py (the port imports nothing of
the JAX package): the same SKYTPU_STEP_TELEMETRY_FILE variable and the
same record shape, so the JAX package's agent and dashboard read the
port's records as their own.  Writers: Trainer.fit appends a `train_fit`
record when SKYTPU_STEP_TELEMETRY_FILE is set (the job agent defaults
it to <job log dir>/rank-<r>.telemetry.jsonl for every rank).  Readers:
the agent's /telemetry endpoint tails these files.

Record shape: one JSON object per line; `ts` (unix seconds) and `kind`
are always present, the rest is writer-specific (documented in
docs/observability.md).  Appends are O_APPEND single-write, so
concurrent writers interleave whole lines; a malformed line (torn
write, truncation) is skipped by read(), never fatal.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

ENV_VAR = 'SKYTPU_STEP_TELEMETRY_FILE'

# Keep files bounded: a long-lived agent appending one sample per tick
# forever would otherwise grow without limit.  On exceeding the cap the
# file is rewritten with its newest half (coarse, but readers only tail).
MAX_BYTES = 4 * 1024 * 1024


def enabled() -> bool:
    return bool(os.environ.get(ENV_VAR))


def default_path() -> Optional[str]:
    path = os.environ.get(ENV_VAR)
    return os.path.expanduser(path) if path else None


def write(record: Dict[str, Any], path: Optional[str] = None) -> None:
    """Append one record (adds `ts` if absent).  Never raises: step
    telemetry must not take down the loop it observes."""
    path = os.path.expanduser(path) if path else default_path()
    if not path:
        return
    record = dict(record)
    record.setdefault('ts', time.time())  # log ts; skytpu-allow: SKY402
    try:
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        line = json.dumps(record) + '\n'
        with open(path, 'a', encoding='utf-8') as f:
            f.write(line)
        if os.path.getsize(path) > MAX_BYTES:
            _truncate(path)
    except (OSError, ValueError, TypeError):
        pass


def _truncate(path: str) -> None:
    with open(path, 'rb') as f:
        f.seek(-MAX_BYTES // 2, os.SEEK_END)
        tail = f.read()
    # Drop the (probably torn) first line of the kept window.
    tail = tail.split(b'\n', 1)[-1]
    with open(path, 'wb') as f:
        f.write(tail)


def read(path: str, limit: int = 100) -> List[Dict[str, Any]]:
    """Last `limit` records of a JSONL telemetry file (empty list when
    the file is missing); malformed lines are skipped."""
    try:
        with open(os.path.expanduser(path), encoding='utf-8') as f:
            lines = f.readlines()
    except OSError:
        return []
    records = []
    for line in lines[-limit:]:
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            continue
    return records
