"""Serve-plane failure tolerance primitives: per-replica circuit
breaking and the exactly-once session journal.

Counterpart of skypilot_tpu/serve/failover.py.  Its consumer here is
`serve/traffic/simulator.py` (virtual clock): the FleetSimulator is its
own load balancer; it drives the breaker with virtual probe outcomes
(a replica that fails consecutively leaves routing and is probed back
in on a `utils/backoff.py` schedule; one advertising admission
backpressure is cooled down, not failed) and journals every delivered
token in a `SessionJournal`, so a killed replica's sessions are
re-admitted on a survivor by deterministic replay (prompt + committed
tokens), resuming at the first un-delivered token.

Neither class reads a clock: every method takes `now` explicitly, so
the same code is exact under virtual time and honest under a wall
clock.  Half-open probing is modeled
implicitly: `probe_due(url, now)` says when an OPEN replica may take
one trial request; the trial's outcome (`note_success` /
`note_failure`) closes the circuit or re-opens it with a grown
backoff delay.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics
from skypilot_tpu_torch.utils.backoff import Backoff

logger = logging.getLogger(__name__)

CLOSED = 'closed'
OPEN = 'open'


@dataclasses.dataclass
class _Circuit:
    """Per-replica breaker state."""
    state: str = CLOSED
    consecutive_failures: int = 0
    backoff: Optional[Backoff] = None
    next_probe_at: float = 0.0
    # Backpressure cooldown (503 + Retry-After): the replica is
    # healthy but full — excluded from routing until the advised time,
    # without counting toward the failure threshold.
    cooldown_until: float = 0.0


class CircuitBreaker:
    """Consecutive-failure circuit breaker over a replica set.

    CLOSED -> (failure_threshold consecutive failures) -> OPEN ->
    (half-open probe succeeds) -> CLOSED.  While OPEN, `routable`
    excludes the replica; `probe_due` gates the half-open trial on a
    bounded-exponential `Backoff` schedule so a dead replica is probed
    ever more rarely instead of hammered.
    """

    def __init__(self, failure_threshold: int = 3,
                 backoff_factory: Optional[Callable[[], Backoff]] = None
                 ) -> None:
        if failure_threshold < 1:
            raise ValueError(f'failure_threshold must be >= 1, '
                             f'got {failure_threshold}')
        self.failure_threshold = failure_threshold
        # jitter=0 keeps the probe schedule a pure function of the
        # failure sequence — the simulator's determinism contract (the
        # LB may pass a jittered factory if it wants decorrelation).
        self._backoff_factory = backoff_factory or (
            lambda: Backoff(initial=0.5, cap=8.0, jitter=0.0))
        self._circuits: Dict[str, _Circuit] = {}
        self.opens_total = 0

    # -- membership --------------------------------------------------------
    def _circuit(self, url: str) -> _Circuit:
        if url not in self._circuits:
            self._circuits[url] = _Circuit()
        return self._circuits[url]

    def forget(self, url: str) -> None:
        """Drop all health state for a replica that left the fleet —
        the mandatory counterpart of removing it from the ring."""
        self._circuits.pop(url, None)

    def observe_members(self, urls: Sequence[str]) -> None:
        """Prune state for replicas no longer in the fleet."""
        keep = set(urls)
        for url in list(self._circuits):
            if url not in keep:
                del self._circuits[url]

    # -- outcomes ----------------------------------------------------------
    def note_success(self, url: str) -> bool:
        """A request/probe succeeded.  Returns True when this closes an
        OPEN circuit (the half-open probe that heals the replica)."""
        c = self._circuit(url)
        healed = c.state == OPEN
        if healed:
            telemetry_metrics.SERVE_FAILOVER_CIRCUIT_TRANSITIONS.labels(
                replica=url, state=CLOSED).inc()
            logger.info(f'Circuit for {url} closed (probe succeeded)')
        c.state = CLOSED
        c.consecutive_failures = 0
        c.backoff = None
        c.next_probe_at = 0.0
        return healed

    def note_failure(self, url: str, now: float) -> bool:
        """A request/probe failed.  Returns True when this OPENS the
        circuit (threshold reached) — the caller's cue to remove the
        replica from the ring and fail its sessions over."""
        c = self._circuit(url)
        if c.state == OPEN:
            # Half-open probe failed: stay open, grow the probe delay.
            assert c.backoff is not None
            c.next_probe_at = now + c.backoff.next_delay()
            return False
        c.consecutive_failures += 1
        if c.consecutive_failures < self.failure_threshold:
            return False
        c.state = OPEN
        c.backoff = self._backoff_factory()
        c.next_probe_at = now + c.backoff.next_delay()
        self.opens_total += 1
        telemetry_metrics.SERVE_FAILOVER_CIRCUIT_TRANSITIONS.labels(
            replica=url, state=OPEN).inc()
        logger.warning(
            f'Circuit for {url} opened after '
            f'{c.consecutive_failures} consecutive failures')
        return True

    def note_backpressure(self, url: str, now: float,
                          retry_after_s: float) -> None:
        """The replica answered 503 + Retry-After: it is alive but
        full.  Cool it down (divert traffic elsewhere) WITHOUT counting
        a failure — backpressure is the replica protecting itself, not
        dying."""
        c = self._circuit(url)
        c.cooldown_until = max(c.cooldown_until,
                               now + max(0.0, retry_after_s))

    # -- routing -----------------------------------------------------------
    def state(self, url: str) -> str:
        c = self._circuits.get(url)
        return c.state if c is not None else CLOSED

    def is_open(self, url: str) -> bool:
        return self.state(url) == OPEN

    def probe_due(self, url: str, now: float) -> bool:
        c = self._circuits.get(url)
        return (c is not None and c.state == OPEN
                and now >= c.next_probe_at)

    def routable(self, urls: Sequence[str], now: float,
                 include_probes: bool = False) -> List[str]:
        """The subset of `urls` that may take traffic at `now`: CLOSED
        circuits past any backpressure cooldown, plus (when
        `include_probes`) OPEN circuits whose half-open probe is due —
        the LB lets one live request be the probe; the simulator
        probes synthetically and keeps them excluded."""
        out = []
        for url in urls:
            c = self._circuits.get(url)
            if c is None:
                out.append(url)
                continue
            if c.state == CLOSED:
                if now >= c.cooldown_until:
                    out.append(url)
            elif include_probes and now >= c.next_probe_at:
                out.append(url)
        return out

    def snapshot(self) -> Dict[str, str]:
        return {url: c.state for url, c in self._circuits.items()}


@dataclasses.dataclass
class SessionRecord:
    """Everything needed to replay a session on another replica."""
    key: Any
    prompt: List[int]
    max_new_tokens: int
    replica: str
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    committed: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    failovers: int = 0


class SessionJournal:
    """Committed-token journal — the LB-side source of truth for what
    each client has actually been delivered.

    Exactly-once contract: `commit()` records tokens at the moment
    they are delivered downstream (never merely computed — a
    partitioned replica's undelivered tokens are NOT committed), so
    `replay_spec()` describes precisely the resubmission that resumes
    the stream at the first un-delivered token: prompt + committed
    tokens as the new prompt, the un-delivered remainder as the new
    budget.  Greedy decode replayed this way is bit-exact with the
    uninterrupted run — no duplicated, no dropped tokens.
    """

    def __init__(self) -> None:
        self._sessions: Dict[Any, SessionRecord] = {}

    def open(self, key: Any, prompt: Sequence[int], max_new_tokens: int,
             replica: str, temperature: Optional[float] = None,
             top_p: Optional[float] = None) -> SessionRecord:
        if key in self._sessions:
            raise ValueError(f'Session {key!r} already journaled')
        rec = SessionRecord(key=key, prompt=list(prompt),
                            max_new_tokens=int(max_new_tokens),
                            replica=replica, temperature=temperature,
                            top_p=top_p)
        self._sessions[key] = rec
        return rec

    def record(self, key: Any) -> SessionRecord:
        return self._sessions[key]

    def commit(self, key: Any, tokens: Sequence[int]) -> None:
        rec = self._sessions[key]
        if rec.done:
            raise ValueError(f'Session {key!r} already closed')
        rec.committed.extend(int(t) for t in tokens)

    def close(self, key: Any) -> SessionRecord:
        rec = self._sessions[key]
        rec.done = True
        return rec

    def sessions_on(self, replica: str) -> List[Any]:
        """Open sessions currently owned by `replica` — the set to
        fail over when its circuit opens."""
        return [k for k, rec in self._sessions.items()
                if rec.replica == replica and not rec.done]

    def reassign(self, key: Any, replica: str) -> None:
        rec = self._sessions[key]
        rec.replica = replica
        rec.failovers += 1

    def replay_spec(self, key: Any) -> Optional[Dict[str, Any]]:
        """The resubmission that resumes this session exactly-once, or
        None when every budgeted token was already delivered (the
        session finished; only its completion event was lost)."""
        rec = self._sessions[key]
        remaining = rec.max_new_tokens - len(rec.committed)
        if remaining <= 0:
            return None
        return {
            'prompt': rec.prompt + rec.committed,
            'max_new_tokens': remaining,
            'temperature': rec.temperature,
            'top_p': rec.top_p,
        }
