"""Fleet health doctor: a rules engine over the serving plane's
existing health signals, plus an incident flight recorder.

The doctor does NOT invent new instrumentation — it evaluates, on a
fixed cadence, signals the plane already exports (SLO burn rates from
serve/slo.py, the host-tier ledger from infer/kv_tier.py, circuit-
breaker transitions from serve/failover.py, the block-pool ledger,
admission backpressure retries) and emits typed ``Incident`` records
with the evidence that fired the rule.  Rules carry hysteresis: an
open rule must observe its condition CLEAR before it can fire again,
so a sustained pathology is one incident, not one per cadence tick.

Signals arrive as a flat dict (see ``SIGNALS`` for the catalogue);
rate-style rules are evaluated on the DELTA since the previous
``observe()`` call, so cumulative counters plug in directly.  All
times come from the caller's clock — the FleetSimulator drives the
doctor on its virtual clock, which (with the deterministic flight-
recorder inputs) makes postmortem bundles byte-identical per seed.

The flight recorder dumps one JSON file per incident into
``SKYTPU_POSTMORTEM_DIR`` (or an explicit ``out_dir``): the incident
record, the last-N spans from the SpanBuffer ring, a metrics
snapshot, pool/tier ledger dumps, and the top-K tenant cost table —
sorted keys throughout, so a bundle produced from deterministic
sources is byte-deterministic.

CLI self-check::

    python -m skypilot_tpu_torch.telemetry.doctor --list-rules --validate

Counterpart of skypilot_tpu/telemetry/doctor.py: the same signals,
thresholds, rules, incidents and bundles.  The live-path defaults read
the port's span buffer and its registry (telemetry/metrics.REGISTRY).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

# Signal catalogue: every key a rule may read.  Counters are
# cumulative; the doctor differentiates them per observe() interval.
SIGNALS = {
    'slo_burn_fast': 'fast-window SLO burn rate (serve/slo.py)',
    'slo_burn_slow': 'slow-window SLO burn rate (serve/slo.py)',
    'tier_prefetches': 'cumulative host-tier prefetches (kv_tier stats)',
    'tier_prefetch_late': 'cumulative prefetch-late parks (kv_tier)',
    'tier_spills': 'cumulative host-tier spills (kv_tier stats)',
    'breaker_opens': 'cumulative circuit-breaker opens (failover)',
    'pool_blocks_total': 'arena blocks total (block_pool stats)',
    'pool_hwm': 'arena live-block high-water mark (block_pool stats)',
    'pool_free': 'arena free blocks (block_pool stats)',
    'backpressure_retries': 'cumulative admission backpressure retries',
    'disagg_handoffs': 'cumulative prefill->decode KV handoffs '
                       '(serve/disagg.py)',
    'disagg_handoff_late': 'cumulative handoffs whose decode slot '
                           'waited past the handoff-late threshold',
}


@dataclasses.dataclass(frozen=True)
class DoctorRule:
    """One health rule: fires when `predicate(ctx)` is truthy."""
    code: str                 # stable id, DOC1xx = SLO, 2xx = tier,
                              # 3xx = serve fabric, 4xx = memory
    name: str
    summary: str
    severity: str             # 'page' or 'ticket'
    predicate: Callable[[Dict[str, float]], Optional[Dict[str, Any]]]
    # predicate returns an evidence dict when firing, else None.


@dataclasses.dataclass
class Incident:
    """One typed incident with the evidence that opened it."""
    incident_id: str
    rule: str                 # rule code
    name: str
    severity: str
    opened_at: float          # caller-clock seconds
    evidence: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {
            'incident_id': self.incident_id,
            'rule': self.rule,
            'name': self.name,
            'severity': self.severity,
            'opened_at': round(self.opened_at, 6),
            'evidence': self.evidence,
        }


# Default thresholds, overridable per-Doctor.  The SLO pair is the
# classic multiwindow page rule (fast > 14.4, slow > 6 for a 1h/30d
# budget); the rest are serve-plane judgment calls (the incident
# taxonomy of the JAX package's docs/observability.md).
DEFAULT_THRESHOLDS = {
    'slo_fast_burn': 14.4,
    'slo_slow_burn': 6.0,
    'prefetch_late_ratio': 0.5,
    'prefetch_late_min_events': 4,
    'spill_thrash_min_events': 8,
    'spill_thrash_ratio': 0.5,
    'breaker_flaps': 2,
    'pool_hwm_ratio': 0.95,
    'backpressure_retries': 8,
    'handoff_late_ratio': 0.5,
    'handoff_late_min_events': 4,
}


def _rule_slo_fast(th):
    def pred(ctx):
        burn = ctx.get('slo_burn_fast', 0.0)
        if burn > th['slo_fast_burn']:
            return {'slo_burn_fast': round(burn, 4),
                    'threshold': th['slo_fast_burn']}
        return None
    return pred


def _rule_slo_slow(th):
    def pred(ctx):
        burn = ctx.get('slo_burn_slow', 0.0)
        if burn > th['slo_slow_burn']:
            return {'slo_burn_slow': round(burn, 4),
                    'threshold': th['slo_slow_burn']}
        return None
    return pred


def _rule_prefetch_late(th):
    def pred(ctx):
        late = ctx.get('d_tier_prefetch_late', 0.0)
        total = ctx.get('d_tier_prefetches', 0.0) + late
        if late >= th['prefetch_late_min_events'] and total > 0 \
                and late / total > th['prefetch_late_ratio']:
            return {'prefetch_late': late, 'prefetches': total,
                    'late_ratio': round(late / total, 4),
                    'threshold': th['prefetch_late_ratio']}
        return None
    return pred


def _rule_handoff_late(th):
    def pred(ctx):
        late = ctx.get('d_disagg_handoff_late', 0.0)
        total = ctx.get('d_disagg_handoffs', 0.0)
        if late >= th['handoff_late_min_events'] and total > 0 \
                and late / total > th['handoff_late_ratio']:
            return {'handoff_late': late, 'handoffs': total,
                    'late_ratio': round(late / total, 4),
                    'threshold': th['handoff_late_ratio']}
        return None
    return pred


def _rule_spill_thrash(th):
    def pred(ctx):
        spills = ctx.get('d_tier_spills', 0.0)
        prefetches = ctx.get('d_tier_prefetches', 0.0)
        floor = th['spill_thrash_min_events']
        if spills >= floor and prefetches >= floor:
            ratio = min(spills, prefetches) / max(spills, prefetches)
            if ratio > th['spill_thrash_ratio']:
                return {'spills': spills, 'prefetches': prefetches,
                        'thrash_ratio': round(ratio, 4),
                        'threshold': th['spill_thrash_ratio']}
        return None
    return pred


def _rule_breaker_flap(th):
    def pred(ctx):
        flaps = ctx.get('d_breaker_opens', 0.0)
        if flaps >= th['breaker_flaps']:
            return {'breaker_opens': flaps,
                    'threshold': th['breaker_flaps']}
        return None
    return pred


def _rule_pool_high_water(th):
    def pred(ctx):
        total = ctx.get('pool_blocks_total', 0.0)
        hwm = ctx.get('pool_hwm', 0.0)
        if total > 0 and hwm / total >= th['pool_hwm_ratio']:
            return {'pool_hwm': hwm, 'pool_blocks_total': total,
                    'hwm_ratio': round(hwm / total, 4),
                    'pool_free': ctx.get('pool_free'),
                    'threshold': th['pool_hwm_ratio']}
        return None
    return pred


def _rule_backpressure(th):
    def pred(ctx):
        retries = ctx.get('d_backpressure_retries', 0.0)
        if retries >= th['backpressure_retries']:
            return {'backpressure_retries': retries,
                    'threshold': th['backpressure_retries']}
        return None
    return pred


_RULE_SPECS = (
    ('DOC101', 'slo_fast_burn', 'page',
     'fast-window SLO burn rate over the multiwindow page threshold',
     _rule_slo_fast),
    ('DOC102', 'slo_slow_burn', 'page',
     'slow-window SLO burn rate over the multiwindow page threshold',
     _rule_slo_slow),
    ('DOC201', 'tier_prefetch_late', 'ticket',
     'host-tier prefetches landing after admission needs them '
     '(routing hints fire too late)', _rule_prefetch_late),
    ('DOC202', 'tier_spill_thrash', 'ticket',
     'host tier spilling and prefetching the same working set '
     '(device arena too small for the route mix)', _rule_spill_thrash),
    ('DOC203', 'handoff_late', 'ticket',
     'disaggregated decode slots waiting past the threshold for their '
     'prefill KV image (transfer bandwidth or prefill pool '
     'undersized)', _rule_handoff_late),
    ('DOC301', 'breaker_flap', 'page',
     'circuit breaker opening repeatedly within one cadence interval '
     '(replica flapping, not cleanly dead)', _rule_breaker_flap),
    ('DOC302', 'admission_backpressure', 'ticket',
     'sustained admission backpressure-retry rate (queue sized below '
     'the arrival burst)', _rule_backpressure),
    ('DOC401', 'pool_high_water', 'ticket',
     'pooled-KV arena high-water mark near capacity (admission stalls '
     'and prefix evictions imminent)', _rule_pool_high_water),
)

# Cumulative-counter signals differentiated into d_<name> per tick.
_COUNTER_SIGNALS = ('tier_prefetches', 'tier_prefetch_late',
                    'tier_spills', 'breaker_opens',
                    'backpressure_retries', 'disagg_handoffs',
                    'disagg_handoff_late')


def build_rules(thresholds: Optional[Dict[str, float]] = None
                ) -> List[DoctorRule]:
    th = dict(DEFAULT_THRESHOLDS)
    if thresholds:
        th.update(thresholds)
    return [DoctorRule(code=code, name=name, severity=severity,
                       summary=summary, predicate=factory(th))
            for code, name, severity, summary, factory in _RULE_SPECS]


class Doctor:
    """Evaluates the rule set against signal snapshots on a cadence.

    ``observe(signals, now)`` returns the incidents OPENED by that
    snapshot (hysteresis: a firing rule stays open — and silent —
    until a snapshot where its condition is clear).  When a flight
    recorder is attached, every opened incident is dumped."""

    def __init__(self, *,
                 thresholds: Optional[Dict[str, float]] = None,
                 recorder: Optional['FlightRecorder'] = None,
                 export_metrics: bool = False) -> None:
        self.rules = build_rules(thresholds)
        self.recorder = recorder
        self._export = export_metrics
        self._prev: Dict[str, float] = {}
        self._open: Dict[str, bool] = {}
        self._seq = 0
        self.incidents: List[Incident] = []

    def observe(self, signals: Dict[str, float],
                now: float) -> List[Incident]:
        ctx = dict(signals)
        for name in _COUNTER_SIGNALS:
            cur = float(signals.get(name, 0.0))
            ctx[f'd_{name}'] = cur - self._prev.get(name, 0.0)
            self._prev[name] = cur
        opened: List[Incident] = []
        for rule in self.rules:
            evidence = rule.predicate(ctx)
            if evidence is None:
                self._open[rule.code] = False
                continue
            if self._open.get(rule.code):
                continue                      # still open: no re-fire
            self._open[rule.code] = True
            self._seq += 1
            incident = Incident(
                incident_id=f'inc-{self._seq:03d}-{rule.name}',
                rule=rule.code, name=rule.name,
                severity=rule.severity, opened_at=now,
                evidence=evidence)
            opened.append(incident)
            self.incidents.append(incident)
            if self._export:
                from skypilot_tpu_torch.telemetry import metrics
                metrics.DOCTOR_INCIDENTS.labels(rule=rule.name).inc()
            if self.recorder is not None:
                self.recorder.dump(incident)
        return opened


class FlightRecorder:
    """Dumps one deterministic postmortem bundle per incident.

    Inputs are pluggable callables so the simulator can feed virtual-
    clock sources (byte-deterministic per seed) while the live path
    defaults to the process-global SpanBuffer and REGISTRY."""

    def __init__(self, out_dir: Optional[str] = None, *,
                 last_n_spans: int = 256,
                 spans_fn: Optional[Callable[[], List[dict]]] = None,
                 metrics_fn: Optional[Callable[[], Dict[str, Any]]]
                 = None,
                 pool_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 tier_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 ledger: Optional[Any] = None,
                 top_k: int = 5) -> None:
        self.out_dir = out_dir or os.environ.get('SKYTPU_POSTMORTEM_DIR')
        self.last_n_spans = last_n_spans
        self._spans_fn = spans_fn
        self._metrics_fn = metrics_fn
        self._pool_fn = pool_fn
        self._tier_fn = tier_fn
        self._ledger = ledger
        self._top_k = top_k
        self.dumped: List[str] = []

    def bundle(self, incident: Incident) -> Dict[str, Any]:
        spans = (self._spans_fn or _default_spans)()
        bundle: Dict[str, Any] = {
            'incident': incident.to_dict(),
            'spans': spans[-self.last_n_spans:],
            'metrics': ((self._metrics_fn or _registry_snapshot)()),
            'pool': self._pool_fn() if self._pool_fn else None,
            'tier': self._tier_fn() if self._tier_fn else None,
            'tenants_top': (self._ledger.top_tenants(self._top_k)
                            if self._ledger is not None else None),
        }
        return bundle

    def dump(self, incident: Incident) -> Optional[str]:
        """Write `incident-<id>.json` (sorted keys); no-op without an
        output dir (env unset and none passed)."""
        if not self.out_dir:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f'incident-{incident.incident_id}.json')
        with open(path, 'w', encoding='utf-8') as f:
            json.dump(self.bundle(incident), f, sort_keys=True,
                      indent=1)
            f.write('\n')
        self.dumped.append(path)
        return path


def _default_spans() -> List[dict]:
    from skypilot_tpu_torch.telemetry import spans as spans_lib
    return spans_lib.default_buffer().snapshot()


def _registry_snapshot() -> Dict[str, float]:
    """Flat {family{labels}: value} snapshot of the shared registry
    (samples sorted by name for stable output)."""
    from skypilot_tpu_torch.telemetry.metrics import REGISTRY
    snap: Dict[str, float] = {}
    for family in REGISTRY.collect():
        for sample in family.samples:
            labels = ','.join(f'{k}={v}' for k, v in
                              sorted(sample.labels.items()))
            key = f'{sample.name}{{{labels}}}' if labels \
                else sample.name
            snap[key] = sample.value
    return dict(sorted(snap.items()))


# ---- CLI self-check ----------------------------------------------------


def validate_rules() -> List[str]:
    """Static consistency check of the rule registry; returns a list
    of problems (empty = healthy)."""
    problems = []
    rules = build_rules()
    codes = [r.code for r in rules]
    names = [r.name for r in rules]
    if len(set(codes)) != len(codes):
        problems.append(f'duplicate rule codes: {sorted(codes)}')
    if len(set(names)) != len(names):
        problems.append(f'duplicate rule names: {sorted(names)}')
    for rule in rules:
        if not rule.code.startswith('DOC'):
            problems.append(f'{rule.name}: code {rule.code!r} must '
                            f'start with DOC')
        if rule.severity not in ('page', 'ticket'):
            problems.append(f'{rule.code}: unknown severity '
                            f'{rule.severity!r}')
        try:
            result = rule.predicate({})
        except Exception as exc:  # pylint: disable=broad-except
            problems.append(f'{rule.code}: predicate raised on empty '
                            f'signals: {exc!r}')
            continue
        if result is not None:
            problems.append(f'{rule.code}: fires on empty signals')
    for key in DEFAULT_THRESHOLDS.values():
        if not isinstance(key, (int, float)) or key <= 0:
            problems.append(f'non-positive default threshold: {key!r}')
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.telemetry.doctor',
        description='Fleet-doctor rule registry tools')
    parser.add_argument('--list-rules', action='store_true',
                        help='print the rule catalogue')
    parser.add_argument('--validate', action='store_true',
                        help='self-check the rule registry; exit 1 on '
                             'problems')
    args = parser.parse_args(argv)
    if not args.list_rules and not args.validate:
        parser.print_help()
        return 0
    if args.list_rules:
        for rule in build_rules():
            print(f'{rule.code}  {rule.name:24s} [{rule.severity}] '
                  f'{rule.summary}')
    if args.validate:
        problems = validate_rules()
        for problem in problems:
            print(f'doctor: {problem}', file=sys.stderr)
        if problems:
            return 1
        print(f'doctor: {len(build_rules())} rules OK')
    return 0


if __name__ == '__main__':
    sys.exit(main())
