"""Checked-in violation baseline: pre-existing findings don't fail CI,
NEW ones do.

Fingerprints are content-based — ``sha1(path : rule : stripped source
line : occurrence-index)`` — so unrelated edits that shift line numbers
do not invalidate entries, while editing the flagged line itself (the
only way to fix OR worsen it) does.  ``--update-baseline`` rewrites the
file from the current findings; review the diff like any other code
change.  The tier-1 test (tests/test_torch_lint.py) additionally pins
the baseline's SIZE, so the suppression set can shrink but never
silently grow.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from skypilot_tpu_torch.analysis.linter import Violation

BASELINE_PATH = os.path.join(os.path.dirname(__file__), 'baseline.json')


def _fingerprint(path: str, code: str, text: str, occurrence: int) -> str:
    key = f'{path}:{code}:{" ".join(text.split())}:{occurrence}'
    return hashlib.sha1(key.encode()).hexdigest()[:16]


def fingerprint_violations(
        violations: Iterable[Violation]) -> List[Tuple[str, Violation]]:
    """(fingerprint, violation) pairs; identical (path, rule, line-text)
    triples are disambiguated by source order."""
    counts: Dict[Tuple[str, str, str], int] = collections.Counter()
    out = []
    for v in violations:
        key = (v.path, v.code, ' '.join(v.text.split()))
        out.append((_fingerprint(v.path, v.code, v.text, counts[key]), v))
        counts[key] += 1
    return out


def load_baseline(path: Optional[str] = None) -> Dict[str, dict]:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path, 'r', encoding='utf-8') as f:
        data = json.load(f)
    return {e['fingerprint']: e for e in data.get('entries', [])}


def diff_baseline(violations: List[Violation],
                  baseline: Dict[str, dict]):
    """Split current findings into (new, suppressed) and report stale
    baseline entries (fixed violations whose suppression can go)."""
    pairs = fingerprint_violations(violations)
    new: List[Violation] = []
    suppressed: List[Violation] = []
    seen = set()
    for fp, v in pairs:
        seen.add(fp)
        (suppressed if fp in baseline else new).append(v)
    stale = [e for fp, e in sorted(baseline.items()) if fp not in seen]
    return new, suppressed, stale


def update_baseline(violations: List[Violation],
                    path: Optional[str] = None) -> int:
    path = path or BASELINE_PATH
    entries = [{
        'fingerprint': fp,
        'rule': v.code,
        'path': v.path,
        'line': v.line,
        'text': v.text,
    } for fp, v in fingerprint_violations(violations)]
    entries.sort(key=lambda e: (e['path'], e['line'], e['rule']))
    with open(path, 'w', encoding='utf-8') as f:
        json.dump({'version': 1, 'entries': entries}, f, indent=1,
                  sort_keys=True)
        f.write('\n')
    return len(entries)
