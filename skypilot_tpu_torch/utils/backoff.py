"""Bounded exponential backoff for retry and probe schedules.

Exponential growth with a decorrelation jitter and a hard cap,
resettable once the operation succeeds.  The serving fleet's circuit
breaker (serve/failover.py) draws its half-open probe delays from it
with jitter 0, so the schedule is a pure function of the failure
sequence.

Counterpart of skypilot_tpu/utils/backoff.py: the same schedule, and
the same draws from the module ``random`` when jitter is on.
"""
from __future__ import annotations

import random
import time


class Backoff:
    """Exponential backoff with jitter: 'sleep, then try again'.

    >>> backoff = Backoff(initial=0.2, cap=5.0)
    >>> while time.monotonic() < deadline:
    ...     try:
    ...         return connect()
    ...     except OSError:
    ...         backoff.sleep()

    Each ``sleep()`` waits ``min(cap, initial * multiplier**attempt)``
    scaled by a jitter factor drawn from ``[1 - jitter, 1]``, so
    concurrent retriers decorrelate instead of thundering in lockstep.
    """

    def __init__(self, initial: float = 0.2, cap: float = 5.0,
                 multiplier: float = 2.0, jitter: float = 0.25):
        if initial <= 0:
            raise ValueError(f'initial must be > 0, got {initial}')
        if cap < initial:
            raise ValueError(f'cap {cap} < initial {initial}')
        if not 1.0 < multiplier:
            raise ValueError(f'multiplier must be > 1, got {multiplier}')
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f'jitter must be in [0, 1), got {jitter}')
        self.initial = initial
        self.cap = cap
        self.multiplier = multiplier
        self.jitter = jitter
        self._attempt = 0

    @property
    def attempt(self) -> int:
        """Number of sleeps taken since construction/reset."""
        return self._attempt

    def next_delay(self) -> float:
        """Advance the schedule and return the next delay (seconds)."""
        base = min(self.cap, self.initial * self.multiplier**self._attempt)
        self._attempt += 1
        return base * (1.0 - self.jitter * random.random())

    def sleep(self) -> float:
        """Sleep for the next delay; returns the delay slept."""
        delay = self.next_delay()
        time.sleep(delay)
        return delay

    def reset(self) -> None:
        """Back to the initial delay (call after a success)."""
        self._attempt = 0
