"""Autoscalers of the serving fleet.

`Autoscaler` -> `_AutoscalerWithHysteresis` -> `RequestRateAutoscaler`
-> `FallbackRequestRateAutoscaler` (spot replicas + on-demand
base/dynamic fallback).  `SLOAutoscaler` scales on the telemetry the
serve layer actually promises users — p99 TTFT vs an SLO target, queue
depth, prefix-cache hit ratio — instead of raw QPS.

Counterpart of skypilot_tpu/serve/autoscalers.py.  A spec is any object
with a ServiceSpec's attribute names (``min_replicas``,
``max_replicas``, ``num_overprovision``, ``target_qps_per_replica``,
``target_p99_ttft_ms``, ``target_queue_depth_per_replica``,
``upscale_delay_seconds``, ``downscale_delay_seconds``,
``autoscaling_enabled``, ``base_ondemand_fallback_replicas``,
``dynamic_ondemand_fallback``, ``spot_placer``): the service spec
itself is orchestration and is not part of the port.  The fallback
autoscaler's fixed-size mode and disagg.RoleAwareSLOAutoscaler derive
specs with ``dataclasses.replace``, so those take a dataclass.

The controller calls `collect_request_information` with load-balancer
reports (request timestamps, plus `ttft_ms` / `queue_depth` /
`prefix_hit_ratio` when the reporter has them) and
`generate_scaling_decisions` every `get_decision_interval()` seconds;
decisions are SCALE_UP/SCALE_DOWN lists applied by the replica manager.
"""
from __future__ import annotations

import dataclasses
import enum
import logging
import math
import time
from typing import Any, Dict, List, Optional, Union

from skypilot_tpu_torch.serve.serve_state import ReplicaStatus
from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics

# The spec's type: any object with a ServiceSpec's attribute names.
ServiceSpec = Any

logger = logging.getLogger(__name__)

# Window over which reported request timestamps count toward QPS.
QPS_WINDOW_SIZE_SECONDS = 60
# Decision cadence: fast when scaling up (catch bursts), slow when idle.
DECISION_INTERVAL_SECONDS = 20
BURST_DECISION_INTERVAL_SECONDS = 5


class AutoscalerDecisionOperator(enum.Enum):
    SCALE_UP = 'scale_up'
    SCALE_DOWN = 'scale_down'


@dataclasses.dataclass
class AutoscalerDecision:
    """One scaling action.

    SCALE_UP target: launch override dict (e.g. {'use_spot': True,
    'location': Location}); SCALE_DOWN target: replica id to kill.
    """
    operator: AutoscalerDecisionOperator
    target: Union[Optional[Dict[str, Any]], int]


def _scale_up(n: int, override: Optional[Dict[str, Any]] = None
              ) -> List[AutoscalerDecision]:
    return [AutoscalerDecision(AutoscalerDecisionOperator.SCALE_UP,
                               dict(override or {})) for _ in range(n)]


def _scale_down_ids(ids: List[int]) -> List[AutoscalerDecision]:
    return [AutoscalerDecision(AutoscalerDecisionOperator.SCALE_DOWN, rid)
            for rid in ids]


def select_replicas_to_scale_down(
        replicas: List[Dict[str, Any]], n: int) -> List[int]:
    """Least-useful-first victim selection."""
    order = {status: i for i, status in
             enumerate(ReplicaStatus.scale_down_decision_order())}
    nonterminal = [r for r in replicas if not r['status'].is_terminal()]
    nonterminal.sort(
        key=lambda r: (order.get(r['status'], len(order)),
                       -(r['launched_at'] or 0)))  # newest first within tier
    return [r['replica_id'] for r in nonterminal[:n]]


def alive_capacity(replicas: List[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """Replicas that count as serving capacity: not in a terminal
    state and not draining.  A replica the chaos layer (or a spot
    preemption) killed reports terminal — FAILED/PREEMPTED — and so
    becomes capacity to REPLACE (alive < target triggers scale-up),
    never load to absorb; a replica draining toward retirement is
    still finishing in-flight sessions but must not mask a capacity
    deficit either."""
    return [r for r in replicas
            if not r['status'].is_terminal() and not r.get('draining')]


class Autoscaler:
    """Abstract autoscaler over a service's replica set."""

    def __init__(self, service_name: str, spec: ServiceSpec) -> None:
        self.service_name = service_name
        self.min_replicas = spec.min_replicas
        self.max_replicas = spec.max_replicas or spec.min_replicas
        self.num_overprovision = spec.num_overprovision
        self.target_num_replicas = spec.min_replicas
        self.latest_version = 1

    @classmethod
    def from_spec(cls, service_name: str,
                  spec: ServiceSpec) -> 'Autoscaler':
        if spec.base_ondemand_fallback_replicas is not None or \
                spec.dynamic_ondemand_fallback or spec.spot_placer:
            return FallbackRequestRateAutoscaler(service_name, spec)
        if spec.target_p99_ttft_ms is not None:
            return SLOAutoscaler(service_name, spec)
        if spec.autoscaling_enabled:
            return RequestRateAutoscaler(service_name, spec)
        return FixedSizeAutoscaler(service_name, spec)

    def get_final_target_num_replicas(self) -> int:
        return self.target_num_replicas + (self.num_overprovision or 0)

    def _clip(self, target: int) -> int:
        return max(self.min_replicas, min(self.max_replicas, target))

    def update_version(self, version: int, spec: ServiceSpec) -> None:
        self.latest_version = version
        self.min_replicas = spec.min_replicas
        self.max_replicas = spec.max_replicas or spec.min_replicas
        self.num_overprovision = spec.num_overprovision
        self.target_num_replicas = self._clip(self.target_num_replicas)

    def collect_request_information(
            self, request_data: Dict[str, Any]) -> None:
        pass

    def get_decision_interval(self) -> int:
        """Scale-up pressure -> shorter interval."""
        if self.target_num_replicas == 0:
            return BURST_DECISION_INTERVAL_SECONDS
        return DECISION_INTERVAL_SECONDS

    def generate_scaling_decisions(
            self, replicas: List[Dict[str, Any]]
    ) -> List[AutoscalerDecision]:
        raise NotImplementedError

    def _record(self, decisions: List[AutoscalerDecision]
                ) -> List[AutoscalerDecision]:
        """Count emitted decisions (skytpu_serve_autoscaler_decisions_total
        per service/operator) and pass them through — every
        generate_scaling_decisions implementation returns via this."""
        telemetry_metrics.record_autoscaler_decisions(
            self.service_name, decisions)
        return decisions

    def info(self) -> Dict[str, Any]:
        return {
            'target_num_replicas': self.target_num_replicas,
            'min_replicas': self.min_replicas,
            'max_replicas': self.max_replicas,
        }

    # Dynamic state survives controller restarts.
    def dump_dynamic_states(self) -> Dict[str, Any]:
        return {'target_num_replicas': self.target_num_replicas}

    def load_dynamic_states(self, states: Dict[str, Any]) -> None:
        self.target_num_replicas = states.get('target_num_replicas',
                                              self.target_num_replicas)


class FixedSizeAutoscaler(Autoscaler):
    """No autoscaling: hold the replica count at min_replicas."""

    def generate_scaling_decisions(
            self, replicas: List[Dict[str, Any]]
    ) -> List[AutoscalerDecision]:
        target = self.get_final_target_num_replicas()
        alive = alive_capacity(replicas)
        if len(alive) < target:
            return self._record(_scale_up(target - len(alive)))
        if len(alive) > target:
            return self._record(_scale_down_ids(
                select_replicas_to_scale_down(
                    alive, len(alive) - target)))
        return self._record([])


class _AutoscalerWithHysteresis(Autoscaler):
    """Requires N consecutive over/under-threshold decisions before acting
    (*_delay_seconds / decision interval = threshold)."""

    def __init__(self, service_name: str, spec: ServiceSpec) -> None:
        super().__init__(service_name, spec)
        self._setup_thresholds(spec)
        self.upscale_counter = 0
        self.downscale_counter = 0

    def _setup_thresholds(self, spec: ServiceSpec) -> None:
        self.scale_up_threshold = max(
            1, spec.upscale_delay_seconds // DECISION_INTERVAL_SECONDS)
        self.scale_down_threshold = max(
            1, spec.downscale_delay_seconds // DECISION_INTERVAL_SECONDS)

    def update_version(self, version: int, spec: ServiceSpec) -> None:
        super().update_version(version, spec)
        self._setup_thresholds(spec)
        self.upscale_counter = 0
        self.downscale_counter = 0

    def _calculate_target_num_replicas(self) -> int:
        raise NotImplementedError

    def _apply_hysteresis(self) -> None:
        raw_target = self._clip(self._calculate_target_num_replicas())
        if raw_target > self.target_num_replicas:
            self.downscale_counter = 0
            self.upscale_counter += 1
            if self.upscale_counter >= self.scale_up_threshold:
                self.upscale_counter = 0
                logger.info(
                    f'{self.service_name}: scaling up '
                    f'{self.target_num_replicas} -> {raw_target}')
                self.target_num_replicas = raw_target
        elif raw_target < self.target_num_replicas:
            self.upscale_counter = 0
            self.downscale_counter += 1
            if self.downscale_counter >= self.scale_down_threshold:
                self.downscale_counter = 0
                logger.info(
                    f'{self.service_name}: scaling down '
                    f'{self.target_num_replicas} -> {raw_target}')
                self.target_num_replicas = raw_target
        else:
            self.upscale_counter = 0
            self.downscale_counter = 0

    def dump_dynamic_states(self) -> Dict[str, Any]:
        states = super().dump_dynamic_states()
        states.update({'upscale_counter': self.upscale_counter,
                       'downscale_counter': self.downscale_counter})
        return states

    def load_dynamic_states(self, states: Dict[str, Any]) -> None:
        super().load_dynamic_states(states)
        self.upscale_counter = states.get('upscale_counter', 0)
        self.downscale_counter = states.get('downscale_counter', 0)


class RequestRateAutoscaler(_AutoscalerWithHysteresis):
    """target = ceil(QPS / target_qps_per_replica)."""

    def __init__(self, service_name: str, spec: ServiceSpec) -> None:
        super().__init__(service_name, spec)
        assert spec.target_qps_per_replica is not None
        self.target_qps_per_replica = spec.target_qps_per_replica
        self.qps_window_size = QPS_WINDOW_SIZE_SECONDS
        self.request_timestamps: List[float] = []
        # Earliest request ever seen: cold-start QPS must divide by the
        # time traffic has actually been flowing, not the full window.
        self._first_request_ts: Optional[float] = None

    def update_version(self, version: int, spec: ServiceSpec) -> None:
        super().update_version(version, spec)
        if spec.target_qps_per_replica is not None:
            self.target_qps_per_replica = spec.target_qps_per_replica

    def collect_request_information(
            self, request_data: Dict[str, Any]) -> None:
        """Consume a LB report: {'timestamps': [unix seconds, ...]}."""
        incoming = request_data.get('timestamps', [])
        if incoming:
            earliest = min(incoming)
            if self._first_request_ts is None or \
                    earliest < self._first_request_ts:
                self._first_request_ts = earliest
        self.request_timestamps.extend(incoming)
        cutoff = time.time() - self.qps_window_size  # skytpu-allow: SKY402
        index = 0
        for index, ts in enumerate(self.request_timestamps):
            if ts >= cutoff:
                break
        else:
            index = len(self.request_timestamps)
        self.request_timestamps = self.request_timestamps[index:]

    def current_qps(self) -> float:
        now = time.time()    # control plane; skytpu-allow: SKY402
        cutoff = now - self.qps_window_size
        recent = [t for t in self.request_timestamps if t >= cutoff]
        # Cold-start clamp: a service up for seconds has only seconds
        # of traffic — dividing by the full window underestimates QPS
        # by window/elapsed and suppresses the initial scale-up.  Floor
        # at 1s so a single instantaneous burst doesn't read as
        # infinite QPS.
        window = float(self.qps_window_size)
        if self._first_request_ts is not None:
            window = min(window, max(now - self._first_request_ts, 1.0))
        return len(recent) / window

    def _calculate_target_num_replicas(self) -> int:
        return math.ceil(self.current_qps() / self.target_qps_per_replica)

    def generate_scaling_decisions(
            self, replicas: List[Dict[str, Any]]
    ) -> List[AutoscalerDecision]:
        self._apply_hysteresis()
        target = self.get_final_target_num_replicas()
        alive = alive_capacity(replicas)
        if len(alive) < target:
            return self._record(_scale_up(target - len(alive)))
        if len(alive) > target:
            return self._record(_scale_down_ids(
                select_replicas_to_scale_down(
                    alive, len(alive) - target)))
        return self._record([])

    def info(self) -> Dict[str, Any]:
        out = super().info()
        out['qps'] = round(self.current_qps(), 3)
        return out


def _percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (exact, no interpolation — determinism
    matters more than smoothness for SLO decisions)."""
    if not samples:
        return None
    ordered = sorted(samples)
    rank = max(1, math.ceil(q * len(ordered)))
    return ordered[rank - 1]


# SLOAutoscaler defaults: queue depth a replica can hold before it
# counts as pressure, and the pressure band that triggers scaling.
DEFAULT_TARGET_QUEUE_DEPTH_PER_REPLICA = 4.0
SLO_PRESSURE_CAP = 2.0          # max growth factor per decision
SLO_DOWNSCALE_PRESSURE = 0.5    # scale down only below half capacity
WARM_CACHE_HIT_RATIO = 0.5      # hit ratio above which down-steps slow


class SLOAutoscaler(_AutoscalerWithHysteresis):
    """Scale on the latency SLO, not on raw QPS.

    Consumes the serve telemetry stream via LB/simulator reports:

    - ``ttft_ms``: per-request time-to-first-token samples since the
      last report (the LB observes these at the first proxied body
      chunk; the traffic simulator computes them in virtual time).
    - ``queue_depth``: requests queued fleet-wide (admission backlog).
    - ``prefix_hit_ratio``: fleet prefix-cache hit ratio (0..1).

    Each decision pass computes a *pressure*::

        pressure = max(p99_ttft / target_p99_ttft,
                       queue_depth / (target * queue_per_replica))

    and proposes ``ceil(target * clamp(pressure, 0, 2))`` replicas —
    multiplicative like Kubernetes' HPA, so a 2x breach asks for 2x
    capacity in one step instead of creeping one replica per interval.
    `_AutoscalerWithHysteresis` still gates the move: a breach must
    persist `upscale_delay_seconds` worth of consecutive decisions (and
    a clear `downscale_delay_seconds`) before the fleet changes.

    Cache-warmth conservatism: when ``prefix_hit_ratio`` is above
    ``WARM_CACHE_HIT_RATIO`` the fleet's radix caches are doing real
    work, and killing a replica cold-starts every session hashed onto
    it — so scale-DOWN is limited to one replica per decision instead
    of jumping to the computed target.

    The TTFT sample window is one decision interval: samples are
    consumed by the pass that reads them, so "sustained breach" means
    N consecutive breached windows, not one stale spike replayed N
    times.
    """

    # Bound on buffered samples between decisions (heavy open-loop
    # bursts can report thousands per interval; p99 over 4096 is ample).
    MAX_TTFT_SAMPLES = 4096

    def __init__(self, service_name: str, spec: ServiceSpec) -> None:
        super().__init__(service_name, spec)
        assert spec.target_p99_ttft_ms is not None
        self.target_p99_ttft_ms = float(spec.target_p99_ttft_ms)
        self.target_queue_depth_per_replica = float(
            spec.target_queue_depth_per_replica
            or DEFAULT_TARGET_QUEUE_DEPTH_PER_REPLICA)
        self._ttft_ms: List[float] = []
        self._queue_depth = 0.0
        self._prefix_hit_ratio: Optional[float] = None
        self._last_p99_ttft_ms: Optional[float] = None

    def update_version(self, version: int, spec: ServiceSpec) -> None:
        super().update_version(version, spec)
        if spec.target_p99_ttft_ms is not None:
            self.target_p99_ttft_ms = float(spec.target_p99_ttft_ms)
        if spec.target_queue_depth_per_replica is not None:
            self.target_queue_depth_per_replica = float(
                spec.target_queue_depth_per_replica)

    def collect_request_information(
            self, request_data: Dict[str, Any]) -> None:
        self._ttft_ms.extend(
            float(v) for v in request_data.get('ttft_ms', []))
        if len(self._ttft_ms) > self.MAX_TTFT_SAMPLES:
            self._ttft_ms = self._ttft_ms[-self.MAX_TTFT_SAMPLES:]
        # Reporters send None for "no signal yet" (e.g. a fleet whose
        # prefix caches saw no traffic): treat it as absent, not 0.0.
        if request_data.get('queue_depth') is not None:
            self._queue_depth = float(request_data['queue_depth'])
        if request_data.get('prefix_hit_ratio') is not None:
            self._prefix_hit_ratio = float(
                request_data['prefix_hit_ratio'])

    def _pressure(self) -> float:
        p99 = _percentile(self._ttft_ms, 0.99)
        self._last_p99_ttft_ms = p99
        ttft_ratio = 0.0 if p99 is None else p99 / self.target_p99_ttft_ms
        capacity = max(self.target_num_replicas, 1) * \
            self.target_queue_depth_per_replica
        queue_ratio = self._queue_depth / capacity
        return min(max(ttft_ratio, queue_ratio), SLO_PRESSURE_CAP)

    def _calculate_target_num_replicas(self) -> int:
        pressure = self._pressure()
        # Window = one decision interval: consume the samples.
        self._ttft_ms = []
        current = self.target_num_replicas
        if pressure > 1.0:
            return math.ceil(current * pressure)
        if pressure >= SLO_DOWNSCALE_PRESSURE:
            return current    # inside the SLO band: hold
        desired = math.ceil(current * pressure / SLO_DOWNSCALE_PRESSURE)
        if (self._prefix_hit_ratio or 0.0) >= WARM_CACHE_HIT_RATIO:
            # Warm fleet: shed at most one replica per decision.
            desired = max(desired, current - 1)
        return desired

    def info(self) -> Dict[str, Any]:
        out = super().info()
        out.update({
            'target_p99_ttft_ms': self.target_p99_ttft_ms,
            'last_p99_ttft_ms': self._last_p99_ttft_ms,
            'queue_depth': self._queue_depth,
            'prefix_hit_ratio': self._prefix_hit_ratio,
        })
        return out

    def generate_scaling_decisions(
            self, replicas: List[Dict[str, Any]]
    ) -> List[AutoscalerDecision]:
        self._apply_hysteresis()
        target = self.get_final_target_num_replicas()
        alive = alive_capacity(replicas)
        if len(alive) < target:
            return self._record(_scale_up(target - len(alive)))
        if len(alive) > target:
            return self._record(_scale_down_ids(
                select_replicas_to_scale_down(
                    alive, len(alive) - target)))
        return self._record([])


class FallbackRequestRateAutoscaler(RequestRateAutoscaler):
    """Spot replicas with on-demand fallback .

    Invariants:
    - `base_ondemand_fallback_replicas` on-demand replicas always run.
    - remaining target is filled with spot.
    - with `dynamic_ondemand_fallback`, every spot replica that is not yet
      READY is temporarily backed by an extra on-demand replica; the
      on-demand cover is scaled down once spot becomes READY.
    """

    def __init__(self, service_name: str, spec: ServiceSpec) -> None:
        self._fixed_size = spec.target_qps_per_replica is None
        if self._fixed_size:
            # Fixed-size spot service: hold at min_replicas (placeholder
            # qps satisfies the RequestRateAutoscaler invariant only).
            spec = dataclasses.replace(
                spec, target_qps_per_replica=1.0,
                max_replicas=spec.max_replicas or spec.min_replicas)
        super().__init__(service_name, spec)
        self.base_ondemand_fallback_replicas = \
            spec.base_ondemand_fallback_replicas or 0
        self.dynamic_ondemand_fallback = bool(
            spec.dynamic_ondemand_fallback)

    def _calculate_target_num_replicas(self) -> int:
        if self._fixed_size:
            return self.min_replicas
        return super()._calculate_target_num_replicas()

    def generate_scaling_decisions(
            self, replicas: List[Dict[str, Any]]
    ) -> List[AutoscalerDecision]:
        self._apply_hysteresis()
        target = self.get_final_target_num_replicas()
        alive = alive_capacity(replicas)
        spot = [r for r in alive if r['is_spot']]
        ondemand = [r for r in alive if not r['is_spot']]
        num_ready_spot = sum(
            1 for r in spot if r['status'] == ReplicaStatus.READY)

        decisions: List[AutoscalerDecision] = []
        # 1. Spot fills target minus the permanent on-demand base.
        num_spot_target = target - self.base_ondemand_fallback_replicas
        if len(spot) < num_spot_target:
            decisions.extend(_scale_up(num_spot_target - len(spot),
                                       {'use_spot': True}))
        elif len(spot) > num_spot_target:
            decisions.extend(_scale_down_ids(select_replicas_to_scale_down(
                spot, len(spot) - num_spot_target)))
        # 2. On-demand = base + dynamic cover for not-ready spot.
        num_ondemand_target = self.base_ondemand_fallback_replicas
        if self.dynamic_ondemand_fallback:
            num_ondemand_target += max(0, num_spot_target - num_ready_spot)
            num_ondemand_target = min(num_ondemand_target, target)
        if len(ondemand) < num_ondemand_target:
            decisions.extend(_scale_up(
                num_ondemand_target - len(ondemand), {'use_spot': False}))
        elif len(ondemand) > num_ondemand_target:
            decisions.extend(_scale_down_ids(select_replicas_to_scale_down(
                ondemand, len(ondemand) - num_ondemand_target)))
        return self._record(decisions)
