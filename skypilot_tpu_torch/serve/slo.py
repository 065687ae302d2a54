"""SLO burn-rate monitoring for the serve plane.

SRE-style multi-window burn rates over the latency SLOs the serve
plane already tracks: TTFT (observed by the load balancer per proxied
request) and TPOT (per-request decode cadence from the batcher).  A
sample is GOOD when it lands at or under its target; the burn rate of
a window is

    burn = violating_fraction / error_budget,   error_budget = 1 - objective

so burn == 1.0 means the service is consuming its error budget
exactly as fast as the SLO allows, and burn >= budget_exhaustion
thresholds (14.4x fast / 6x slow in classic SRE practice) is page
material.  Two rolling windows — a short "fast" window that reacts to
sudden cliffs (replica kill, pool exhaustion) and a long "slow" window
that catches slow leaks — are exported as
`skytpu_serve_slo_burn_rate{window}`.

All observe/read methods take an explicit `now`, so the monitor works
on wall clock (load balancer) and on the fleet simulator's virtual
clock unchanged — which keeps the simulator's burn numbers
deterministic per seed.

Counterpart of skypilot_tpu/serve/slo.py; the gauge lives on the port's
registry (telemetry/metrics.py).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Optional, Tuple

from skypilot_tpu_torch.telemetry import metrics

# Classic SRE multiwindow pairing: the fast window decides "is it
# burning right now", the slow window decides "has it been burning".
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 600.0


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Latency objectives for one service.

    objective: fraction of requests that must meet the latency
    targets (0.99 => 1% error budget).  A None target disables that
    signal (e.g. TPOT when the workload is prefill-only).
    """
    ttft_target_s: Optional[float] = 2.0
    tpot_target_s: Optional[float] = None
    objective: float = 0.99
    fast_window_s: float = FAST_WINDOW_S
    slow_window_s: float = SLOW_WINDOW_S

    def __post_init__(self) -> None:
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f'objective must be in (0, 1), got {self.objective}')
        if self.fast_window_s > self.slow_window_s:
            raise ValueError('fast window must not exceed slow window')


class _Window:
    """Rolling (timestamp, violated) samples over a fixed horizon."""

    def __init__(self, horizon_s: float) -> None:
        self.horizon_s = horizon_s
        self._samples: Deque[Tuple[float, bool]] = collections.deque()
        self._bad = 0

    def add(self, now: float, violated: bool) -> None:
        self._samples.append((now, violated))
        self._bad += violated
        self._evict(now)

    def _evict(self, now: float) -> None:
        cutoff = now - self.horizon_s
        while self._samples and self._samples[0][0] < cutoff:
            _, violated = self._samples.popleft()
            self._bad -= violated

    def violating_fraction(self, now: float) -> float:
        self._evict(now)
        if not self._samples:
            return 0.0
        return self._bad / len(self._samples)

    def __len__(self) -> int:
        return len(self._samples)


class SLOMonitor:
    """Consumes TTFT/TPOT samples, answers burn rates per window.

    One monitor per service; the LB feeds wall-clock TTFTs as
    responses stream back, the FleetSimulator feeds virtual-time
    TTFT/TPOT as sessions progress.
    """

    def __init__(self, config: Optional[SLOConfig] = None) -> None:
        self.config = config or SLOConfig()
        self._windows: Dict[str, _Window] = {
            'fast': _Window(self.config.fast_window_s),
            'slow': _Window(self.config.slow_window_s),
        }
        self.samples_total = 0
        self.violations_total = 0

    def _observe(self, now: float, violated: bool) -> None:
        self.samples_total += 1
        self.violations_total += violated
        for window in self._windows.values():
            window.add(now, violated)

    def observe_ttft(self, ttft_s: float, now: float) -> None:
        target = self.config.ttft_target_s
        if target is None:
            return
        self._observe(now, ttft_s > target)

    def observe_tpot(self, tpot_s: float, now: float) -> None:
        target = self.config.tpot_target_s
        if target is None:
            return
        self._observe(now, tpot_s > target)

    def burn_rates(self, now: float) -> Dict[str, float]:
        """{window: burn rate}; 0.0 for empty windows (no traffic
        burns no budget)."""
        budget = 1.0 - self.config.objective
        return {
            name: window.violating_fraction(now) / budget
            for name, window in self._windows.items()
        }

    def export(self, now: float) -> Dict[str, float]:
        """Push burn rates to `skytpu_serve_slo_burn_rate{window}` and
        return them."""
        rates = self.burn_rates(now)
        for window, rate in rates.items():
            metrics.SERVE_SLO_BURN_RATE.labels(window=window).set(rate)
        return rates
