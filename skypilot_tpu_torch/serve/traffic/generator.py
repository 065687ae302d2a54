"""Seeded open-loop traffic generator for the serve fleet simulator.

Open-loop means arrivals do NOT wait for responses — the arrival
process is fixed in advance (the load a million independent users
exert), so a slow fleet builds queues instead of silently throttling
the benchmark (the standard serving-benchmark pitfall closed-loop
clients hide).

Model, every piece driven by one `numpy.random.RandomState(seed)`:

- **Arrival process**: Poisson base rate `base_rps`, modulated by burst
  episodes whose start gaps are exponential (`burst_every_s` mean) and
  whose durations are Gamma(`burst_shape`, `burst_scale_s`) — inside a
  burst the rate is `base_rps * burst_rate_mult`.  Implemented as a
  piecewise-constant-rate Poisson process (exponential inter-arrivals
  per segment), which is exact, not a thinning approximation.
- **Session model**: `session_share` of arrivals belong to one of
  `num_sessions` sessions; each session is pinned to one of
  `num_heads` shared prompt heads (system prompts / few-shot headers)
  of `head_tokens` tokens.  A session arrival's prompt = its shared
  head + a per-request distinct tail.  The rest of the traffic is
  singleton prompts with no reusable head.
- **Heavy tails**: tail/singleton prompt lengths and output budgets are
  lognormal (median `*_median`, shape `*_sigma`), clipped to the
  simulator's debug-shape limits — the p99-dominating long requests
  real traffic mixes in.

No wall-clock reads anywhere: the same seed always yields the same
trace, which is what makes SERVE_SUMMARY reproducible end-to-end.

Counterpart of skypilot_tpu/serve/traffic/generator.py: the same draws
from the same RandomState in the same order, so a seed gives the same
trace, arrival for arrival, in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class TrafficConfig:
    """Knobs for one generated trace (defaults: CPU debug scale)."""
    seed: int = 0
    duration_s: float = 30.0
    # Arrival process.
    base_rps: float = 2.0
    burst_rate_mult: float = 4.0
    burst_every_s: float = 10.0
    burst_shape: float = 2.0
    burst_scale_s: float = 1.0
    # Session / shared-head model.
    num_sessions: int = 8
    num_heads: int = 4
    session_share: float = 0.75
    # Session share INSIDE burst episodes (None = same as
    # session_share).  A low value makes bursts singleton-heavy — the
    # "burst of long cold prompts over steady decode sessions" regime
    # the disaggregation bench needs.  Only the comparison threshold
    # changes, never the draw sequence, so every existing seed keeps
    # its exact trace when this is unset.
    burst_session_share: Optional[float] = None
    head_tokens: int = 64
    # Heavy-tailed lengths (lognormal, clipped).
    tail_median: int = 12
    tail_sigma: float = 0.8
    singleton_median: int = 48
    singleton_sigma: float = 0.9
    out_median: int = 8
    out_sigma: float = 0.6
    max_prompt_tokens: int = 120
    max_out_tokens: int = 24
    min_out_tokens: int = 1
    vocab_size: int = 512
    # Tenant model (cost attribution): sessions are assigned to
    # `tenants` round-robin by session id — DERIVED, not drawn, so
    # turning multi-tenancy on never perturbs the RNG sequence and
    # every pre-existing seed keeps its exact trace.  Singletons carry
    # the first tenant.  The default single-tenant tuple reproduces
    # the pre-tenant traces byte-for-byte.
    tenants: tuple = ('default',)

    def __post_init__(self) -> None:
        if self.duration_s <= 0 or self.base_rps <= 0:
            raise ValueError('duration_s and base_rps must be positive')
        if not 0.0 <= self.session_share <= 1.0:
            raise ValueError(f'session_share must be in [0, 1], got '
                             f'{self.session_share}')
        if self.burst_session_share is not None and \
                not 0.0 <= self.burst_session_share <= 1.0:
            raise ValueError(f'burst_session_share must be in [0, 1], '
                             f'got {self.burst_session_share}')
        if self.head_tokens >= self.max_prompt_tokens:
            raise ValueError('head_tokens must leave room for a tail '
                             'under max_prompt_tokens')
        if not self.tenants:
            raise ValueError('tenants must name at least one tenant')

    def tenant_of(self, session: Optional[int]) -> str:
        """Deterministic session -> tenant mapping (round-robin by
        session id; singletons bill the first tenant)."""
        if session is None:
            return self.tenants[0]
        return self.tenants[session % len(self.tenants)]


@dataclasses.dataclass
class Arrival:
    """One request of the trace (times are virtual seconds)."""
    t: float
    session: Optional[int]          # None = singleton traffic
    head: Optional[int]             # shared-head id (None = singleton)
    prompt: List[int]
    max_new_tokens: int
    # Cost-attribution tag (TrafficConfig.tenant_of — derived from the
    # session id, never drawn from the RNG).
    tenant: str = 'default'


def _burst_segments(cfg: TrafficConfig,
                    rng: np.random.RandomState) -> List[tuple]:
    """[(start, end, rate), ...] covering [0, duration_s)."""
    episodes = []
    t = float(rng.exponential(cfg.burst_every_s))
    while t < cfg.duration_s:
        dur = float(rng.gamma(cfg.burst_shape, cfg.burst_scale_s))
        episodes.append((t, min(t + dur, cfg.duration_s)))
        t = t + dur + float(rng.exponential(cfg.burst_every_s))
    segments = []
    cursor = 0.0
    for start, end in episodes:
        if start > cursor:
            segments.append((cursor, start, cfg.base_rps))
        segments.append((start, end, cfg.base_rps * cfg.burst_rate_mult))
        cursor = end
    if cursor < cfg.duration_s:
        segments.append((cursor, cfg.duration_s, cfg.base_rps))
    return segments


def _lognormal_int(rng: np.random.RandomState, median: int, sigma: float,
                   lo: int, hi: int) -> int:
    return int(np.clip(round(float(
        rng.lognormal(np.log(max(median, 1)), sigma))), lo, hi))


def generate_trace(cfg: TrafficConfig) -> List[Arrival]:
    """The full arrival trace, sorted by arrival time."""
    rng = np.random.RandomState(cfg.seed)
    # Shared prompt heads: disjoint token ranges per head so no head is
    # an accidental prefix of another.
    heads = [[int(x) for x in rng.randint(1, cfg.vocab_size,
                                          size=cfg.head_tokens)]
             for _ in range(cfg.num_heads)]
    session_head = [int(rng.randint(cfg.num_heads))
                    for _ in range(cfg.num_sessions)]

    arrivals: List[Arrival] = []
    for start, end, rate in _burst_segments(cfg, rng):
        share = cfg.session_share
        if cfg.burst_session_share is not None and rate > cfg.base_rps:
            share = cfg.burst_session_share
        t = start
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= end:
                break
            out = _lognormal_int(rng, cfg.out_median, cfg.out_sigma,
                                 cfg.min_out_tokens, cfg.max_out_tokens)
            if rng.random_sample() < share:
                session = int(rng.randint(cfg.num_sessions))
                head = session_head[session]
                tail_len = _lognormal_int(
                    rng, cfg.tail_median, cfg.tail_sigma, 1,
                    cfg.max_prompt_tokens - cfg.head_tokens)
                tail = [int(x) for x in rng.randint(
                    1, cfg.vocab_size, size=tail_len)]
                arrivals.append(Arrival(t=round(t, 6), session=session,
                                        head=head,
                                        prompt=heads[head] + tail,
                                        max_new_tokens=out,
                                        tenant=cfg.tenant_of(session)))
            else:
                plen = _lognormal_int(rng, cfg.singleton_median,
                                      cfg.singleton_sigma, 1,
                                      cfg.max_prompt_tokens)
                prompt = [int(x) for x in rng.randint(
                    1, cfg.vocab_size, size=plen)]
                arrivals.append(Arrival(t=round(t, 6), session=None,
                                        head=None, prompt=prompt,
                                        max_new_tokens=out,
                                        tenant=cfg.tenant_of(None)))
    arrivals.sort(key=lambda a: a.t)
    return arrivals
