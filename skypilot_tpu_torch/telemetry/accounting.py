"""Per-tenant cost attribution for the serving data plane.

A copy of skypilot_tpu/telemetry/accounting.py (the port imports nothing
of the JAX package): the same apportionment, rollups and ACCT_SUMMARY
shape, exporting the `skytpu_acct_*` families of the port's registry.

The ledger answers "who is spending the fleet": every request carries
a `tenant` tag (parsed by the LB from the request body, defaulting to
"default"), and the ContinuousBatcher apportions each StepProfiler
phase's EXCLUSIVE wall time across the slots active in that phase —

- **batch phases** (`decode`, `fused`, `spec_draft`, `spec_verify`):
  one dispatch serves every occupied slot, so the phase seconds split
  across the slots active in that phase, weighted by how many chunks
  of the step each slot took part in;
- **request phases** (`admit`, `prefill`): dedicated work owned by one
  request, charged to it alone (several owners in one step split by
  charge count);
- **overhead** (`host_fetch`, `upload`, `tier_wait`, `collective`,
  and the profiler's unattributed bookkeeping remainder): charged to
  the reserved `_fleet` tenant, NOT smeared over requests — so
  per-tenant sums stay honest and the conservation invariant
  `sum over tenants == profiler wall` holds exactly.

Alongside device-seconds the ledger accumulates per-request prefill /
decode tokens, pooled-arena block-seconds (blocks held x step wall),
host-tier spill/prefetch bytes (charged to the step's admitting
tenants — admission pressure causes spills, parked admissions consume
prefetches), and speculative waste (proposed - accepted draft tokens).
Rollups go request -> session (trace id) -> tenant and export as the
`skytpu_acct_*` Prometheus families plus bench.py's tail-safe
`ACCT_SUMMARY` line.  No wall-clock reads: the ledger only ever sees
times measured by its caller's (possibly virtual) clock, so simulator
rollups are deterministic per seed.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Phases one dispatch performs for the whole batch: split across the
# slots active in the phase.
BATCH_PHASES = ('decode', 'fused', 'spec_draft', 'spec_verify')
# Phases owned by a single request: charged to the owner.
REQUEST_PHASES = ('admit', 'prefill')
# Reserved tenant for scheduler overhead and unattributed remainder.
FLEET_TENANT = '_fleet'
DEFAULT_TENANT = 'default'


@dataclasses.dataclass
class RequestAccount:
    """Accumulated bill of one request."""
    rid: int
    tenant: str = DEFAULT_TENANT
    session: Optional[str] = None       # trace id, when propagated
    device_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)           # {phase: seconds}
    prefill_tokens: int = 0
    decode_tokens: int = 0
    block_seconds: float = 0.0
    spill_bytes: float = 0.0
    prefetch_bytes: float = 0.0
    spec_proposed: int = 0
    spec_accepted: int = 0
    finished: bool = False

    @property
    def total_device_seconds(self) -> float:
        return sum(self.device_seconds.values())

    @property
    def spec_waste(self) -> int:
        return max(self.spec_proposed - self.spec_accepted, 0)

    def rollup(self) -> Dict[str, Any]:
        return {
            'device_seconds': self.total_device_seconds,
            'prefill_tokens': self.prefill_tokens,
            'decode_tokens': self.decode_tokens,
            'block_seconds': self.block_seconds,
            'spill_bytes': self.spill_bytes,
            'prefetch_bytes': self.prefetch_bytes,
            'spec_waste_tokens': self.spec_waste,
        }


def _merge_rollup(acc: Dict[str, Any], roll: Dict[str, Any]) -> None:
    for key, val in roll.items():
        acc[key] = acc.get(key, 0) + val


class CostLedger:
    """Apportions StepProfiler phase seconds across the requests active
    in each phase and rolls the bill up request -> session -> tenant.

    Protocol (driven by the batcher, all times on ITS clock):

        ledger.begin_step()
        ledger.charge_request('admit', rid, tenant)      # owner phases
        ledger.charge_batch('decode', [(rid, tenant)..]) # shared phases
        ledger.add_tokens(rid, tenant, decode=3)
        ledger.note_blocks([(rid, tenant, n_blocks), ..])
        ledger.add_spec(parties, proposed=8, accepted=5)
        ledger.add_tier_bytes(spill=..., prefetch=...)
        ledger.end_step(profiler.last_phases, profiler.last_wall)
        ...
        ledger.finish_request(rid, tenant, session=trace_id)

    `export_metrics=True` mirrors every end_step/finish into the
    `skytpu_acct_*` Prometheus families (off in the simulator: the
    registry is process-global and would mix arms).
    """

    def __init__(self, *, export_metrics: bool = False) -> None:
        self._export = export_metrics
        self._lock = threading.Lock()
        self._requests: Dict[int, RequestAccount] = {}
        self._fleet_seconds: Dict[str, float] = {}
        self._wall_total = 0.0
        self._steps = 0
        # Per-step scratch, reset by begin_step().
        self._batch_w: Dict[str, Dict[Tuple[int, str], float]] = {}
        self._req_w: Dict[str, Dict[Tuple[int, str], float]] = {}
        self._step_admits: List[Tuple[int, str]] = []
        self._step_blocks: Optional[List[Tuple[int, str, int]]] = None
        self._step_spill_bytes = 0.0
        self._step_prefetch_bytes = 0.0

    # ---- per-step recording (batcher hot path) ----------------------

    def begin_step(self) -> None:
        self._batch_w = {}
        self._req_w = {}
        self._step_admits = []
        self._step_blocks = None
        self._step_spill_bytes = 0.0
        self._step_prefetch_bytes = 0.0

    def _account(self, rid: int, tenant: str) -> RequestAccount:
        acct = self._requests.get(rid)
        if acct is None:
            acct = RequestAccount(rid=rid, tenant=tenant)
            self._requests[rid] = acct
        elif tenant and acct.tenant == DEFAULT_TENANT \
                and tenant != DEFAULT_TENANT:
            acct.tenant = tenant
        return acct

    def charge_request(self, phase: str, rid: int,
                       tenant: str = DEFAULT_TENANT) -> None:
        """Mark `rid` as an owner of a request phase this step (admit /
        prefill).  Several owners split the phase by charge count."""
        with self._lock:
            self._account(rid, tenant)
            key = (rid, tenant)
            weights = self._req_w.setdefault(phase, {})
            weights[key] = weights.get(key, 0.0) + 1.0
            if phase == 'admit':
                self._step_admits.append(key)

    def charge_batch(self, phase: str,
                     parties: Iterable[Tuple[int, str]]) -> None:
        """Mark the slots active in a batch phase this step.  Called
        once per chunk, so a slot present for 3 of 4 decode chunks
        carries 3/4 of a full share."""
        with self._lock:
            weights = self._batch_w.setdefault(phase, {})
            for rid, tenant in parties:
                self._account(rid, tenant)
                key = (rid, tenant)
                weights[key] = weights.get(key, 0.0) + 1.0

    def add_tokens(self, rid: int, tenant: str = DEFAULT_TENANT, *,
                   prefill: int = 0, decode: int = 0) -> None:
        with self._lock:
            acct = self._account(rid, tenant)
            acct.prefill_tokens += int(prefill)
            acct.decode_tokens += int(decode)

    def note_blocks(self, holdings: Iterable[Tuple[int, str, int]]
                    ) -> None:
        """Record arena blocks held per request this step; block-
        seconds land at end_step (blocks x step wall)."""
        with self._lock:
            self._step_blocks = [(rid, tenant, int(n))
                                 for rid, tenant, n in holdings]

    def add_spec(self, parties: Iterable[Tuple[int, str]],
                 proposed: int, accepted: int) -> None:
        """Charge one verify chunk's proposed/accepted draft tokens to
        the slots that took part, split evenly."""
        parties = list(parties)
        if not parties:
            return
        with self._lock:
            share_p = proposed / len(parties)
            share_a = accepted / len(parties)
            for rid, tenant in parties:
                acct = self._account(rid, tenant)
                acct.spec_proposed += share_p
                acct.spec_accepted += share_a

    def add_tier_bytes(self, *, spill: float = 0.0,
                       prefetch: float = 0.0) -> None:
        """Host-tier traffic observed this step; attributed at
        end_step to the step's admitting tenants (admission pressure
        causes spills; parked admissions consume prefetches), or to
        `_fleet` when nothing admitted."""
        with self._lock:
            self._step_spill_bytes += float(spill)
            self._step_prefetch_bytes += float(prefetch)

    def end_step(self, phases: Dict[str, float], wall: float) -> None:
        """Apportion one finished step's exclusive phase seconds."""
        with self._lock:
            self._steps += 1
            self._wall_total += wall
            attributed = 0.0
            for phase, seconds in phases.items():
                if seconds <= 0.0:
                    continue
                weights = None
                if phase in REQUEST_PHASES:
                    weights = self._req_w.get(phase)
                elif phase in BATCH_PHASES:
                    weights = self._batch_w.get(phase)
                if weights:
                    total_w = sum(weights.values())
                    for (rid, tenant), w in weights.items():
                        share = seconds * (w / total_w)
                        acct = self._account(rid, tenant)
                        acct.device_seconds[phase] = \
                            acct.device_seconds.get(phase, 0.0) + share
                        attributed += share
                else:
                    self._fleet_seconds[phase] = \
                        self._fleet_seconds.get(phase, 0.0) + seconds
                    attributed += seconds
            # Unattributed scheduler bookkeeping: the wall remainder
            # outside every phase block.  Charged to _fleet so the
            # tenant sum conserves the wall exactly.
            remainder = wall - attributed
            if remainder > 0.0:
                self._fleet_seconds['other'] = \
                    self._fleet_seconds.get('other', 0.0) + remainder
            blocks = self._step_blocks
            if blocks:
                for rid, tenant, n in blocks:
                    self._account(rid, tenant).block_seconds += n * wall
                self._step_blocks = None
            if self._step_spill_bytes or self._step_prefetch_bytes:
                admits = self._step_admits
                if admits:
                    spill = self._step_spill_bytes / len(admits)
                    pref = self._step_prefetch_bytes / len(admits)
                    for rid, tenant in admits:
                        acct = self._account(rid, tenant)
                        acct.spill_bytes += spill
                        acct.prefetch_bytes += pref
                # With no admission this step the tier traffic is
                # background churn; it stays visible in tier metrics
                # but bills nobody.
            if self._export:
                self._export_step(phases, wall)

    def finish_request(self, rid: int, tenant: str = DEFAULT_TENANT,
                       session: Optional[str] = None) -> None:
        """Finalize a request's account (delivery or cancel)."""
        with self._lock:
            acct = self._account(rid, tenant)
            acct.session = session or acct.session
            if not acct.finished:
                acct.finished = True
                if self._export:
                    met = _metrics()
                    met.ACCT_REQUESTS.labels(tenant=acct.tenant).inc()
                    if acct.prefill_tokens:
                        met.ACCT_TOKENS.labels(
                            tenant=acct.tenant, kind='prefill').inc(
                                acct.prefill_tokens)
                    if acct.decode_tokens:
                        met.ACCT_TOKENS.labels(
                            tenant=acct.tenant, kind='decode').inc(
                                acct.decode_tokens)
                    if acct.block_seconds:
                        met.ACCT_BLOCK_SECONDS.labels(
                            tenant=acct.tenant).inc(acct.block_seconds)
                    if acct.spill_bytes:
                        met.ACCT_TIER_BYTES.labels(
                            tenant=acct.tenant,
                            direction='spill').inc(acct.spill_bytes)
                    if acct.prefetch_bytes:
                        met.ACCT_TIER_BYTES.labels(
                            tenant=acct.tenant,
                            direction='prefetch').inc(
                                acct.prefetch_bytes)
                    if acct.spec_waste:
                        met.ACCT_SPEC_WASTE_TOKENS.labels(
                            tenant=acct.tenant).inc(acct.spec_waste)

    # ---- metrics export --------------------------------------------

    def _export_step(self, phases: Dict[str, float],
                     wall: float) -> None:
        met = _metrics()
        for phase in REQUEST_PHASES:
            for (rid, tenant), w in (self._req_w.get(phase)
                                     or {}).items():
                total_w = sum(self._req_w[phase].values())
                met.ACCT_DEVICE_SECONDS.labels(
                    tenant=tenant, phase=phase).inc(
                        phases.get(phase, 0.0) * w / total_w)
        for phase in BATCH_PHASES:
            weights = self._batch_w.get(phase) or {}
            total_w = sum(weights.values())
            for (rid, tenant), w in weights.items():
                met.ACCT_DEVICE_SECONDS.labels(
                    tenant=tenant, phase=phase).inc(
                        phases.get(phase, 0.0) * w / total_w)
        overhead = wall - sum(
            phases.get(p, 0.0)
            for p in REQUEST_PHASES if self._req_w.get(p)) - sum(
            phases.get(p, 0.0)
            for p in BATCH_PHASES if self._batch_w.get(p))
        if overhead > 0.0:
            met.ACCT_DEVICE_SECONDS.labels(
                tenant=FLEET_TENANT, phase='other').inc(overhead)

    # ---- rollups ----------------------------------------------------

    def request_accounts(self) -> List[RequestAccount]:
        with self._lock:
            return list(self._requests.values())

    def session_rollup(self) -> Dict[str, Dict[str, Any]]:
        """{session: accumulated bill} — requests without a session id
        roll up under '-'."""
        out: Dict[str, Dict[str, Any]] = {}
        for acct in self.request_accounts():
            key = acct.session or '-'
            bucket = out.setdefault(key, {'tenant': acct.tenant,
                                          'requests': 0})
            bucket['requests'] += 1
            _merge_rollup(bucket, acct.rollup())
        return out

    def tenant_rollup(self) -> Dict[str, Dict[str, Any]]:
        """{tenant: accumulated bill}, including the `_fleet` overhead
        bucket — values sum to the profiler wall exactly."""
        out: Dict[str, Dict[str, Any]] = {}
        for acct in self.request_accounts():
            bucket = out.setdefault(acct.tenant, {'requests': 0})
            bucket['requests'] += 1
            _merge_rollup(bucket, acct.rollup())
        with self._lock:
            fleet_s = sum(self._fleet_seconds.values())
        if fleet_s > 0.0:
            fleet = out.setdefault(FLEET_TENANT, {'requests': 0})
            fleet['device_seconds'] = \
                fleet.get('device_seconds', 0.0) + fleet_s
        return out

    @property
    def steps(self) -> int:
        with self._lock:
            return self._steps

    @property
    def wall_seconds(self) -> float:
        with self._lock:
            return self._wall_total

    def top_tenants(self, k: int = 5) -> List[Dict[str, Any]]:
        """Top-K tenant cost table (by device-seconds, `_fleet` last),
        the flight-recorder / ACCT_SUMMARY shape."""
        return rank_tenants(self.tenant_rollup(), k)

    def summary(self, top_k: int = 5) -> Dict[str, Any]:
        """The ACCT_SUMMARY payload: per-tenant rollup, the
        conservation check against the profiler wall, and the top-K
        table."""
        return summarize_rollup(self.tenant_rollup(),
                                wall=self.wall_seconds,
                                steps=self.steps, top_k=top_k)


class FleetLedgerView:
    """Read-only merged rollup over many replicas' ledgers.

    The simulator keeps one `CostLedger` per replica (each on its own
    virtual clock); the fleet bill is the plain sum of the per-replica
    bills.  The ledger set is re-read per call because replicas churn
    under autoscaling/chaos — pass a callable returning the live set.
    Duck-types the rollup surface of `CostLedger` (`tenant_rollup` /
    `top_tenants` / `summary`), so the flight recorder and bench take
    either interchangeably."""

    def __init__(self, ledgers_fn: Any) -> None:
        self._ledgers_fn = ledgers_fn

    def _ledgers(self) -> List[CostLedger]:
        return [led for led in self._ledgers_fn() if led is not None]

    @property
    def steps(self) -> int:
        return sum(led.steps for led in self._ledgers())

    @property
    def wall_seconds(self) -> float:
        return sum(led.wall_seconds for led in self._ledgers())

    def tenant_rollup(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for led in self._ledgers():
            for tenant, bill in led.tenant_rollup().items():
                _merge_rollup(out.setdefault(tenant, {}), bill)
        return out

    def top_tenants(self, k: int = 5) -> List[Dict[str, Any]]:
        return rank_tenants(self.tenant_rollup(), k)

    def summary(self, top_k: int = 5) -> Dict[str, Any]:
        return summarize_rollup(self.tenant_rollup(),
                                wall=self.wall_seconds,
                                steps=self.steps, top_k=top_k)


def rank_tenants(rollup: Dict[str, Dict[str, Any]],
                 k: int = 5) -> List[Dict[str, Any]]:
    """Top-K tenant cost table from a tenant rollup (by device-
    seconds, `_fleet` sorts last regardless of size)."""
    ranked = sorted(
        rollup.items(),
        key=lambda kv: (kv[0] == FLEET_TENANT,
                        -kv[1].get('device_seconds', 0.0), kv[0]))
    table = []
    for tenant, bill in ranked[:k]:
        row = {'tenant': tenant}
        row.update({key: _round6(val)
                    for key, val in sorted(bill.items())})
        table.append(row)
    return table


def summarize_rollup(rollup: Dict[str, Dict[str, Any]], *,
                     wall: float, steps: int,
                     top_k: int = 5) -> Dict[str, Any]:
    """The ACCT_SUMMARY payload for one tenant rollup: per-tenant
    device-seconds, attributed shares (excluding `_fleet`), the
    conservation check against the profiler wall, and the top-K
    table."""
    tenant_seconds = {t: bill.get('device_seconds', 0.0)
                      for t, bill in rollup.items()}
    attributed = sum(s for t, s in tenant_seconds.items()
                     if t != FLEET_TENANT)
    total = sum(tenant_seconds.values())
    shares = {}
    if attributed > 0.0:
        shares = {t: round(s / attributed, 4)
                  for t, s in sorted(tenant_seconds.items())
                  if t != FLEET_TENANT}
    return {
        'steps': steps,
        'profiler_wall_s': _round6(wall),
        'tenant_device_seconds': {
            t: _round6(s)
            for t, s in sorted(tenant_seconds.items())},
        'attributed_share': shares,
        'conservation_ratio': (_round6(total / wall)
                               if wall > 0.0 else None),
        'tenants': {t: {key: _round6(val)
                        for key, val in sorted(bill.items())}
                    for t, bill in sorted(rollup.items())},
        'top': rank_tenants(rollup, top_k),
    }


def _round6(val):
    if isinstance(val, float):
        return round(val, 6)
    return val


def _metrics():
    # Deferred: keeps the ledger importable without dragging
    # prometheus_client into simulator-only users until export is on.
    from skypilot_tpu_torch.telemetry import metrics as _m
    return _m
