"""Chunk-size policy for the fused prefill+decode step.

Counterpart of skypilot_tpu/infer/fuse.py (this package keeps its own
copy).  Sarathi-style hybrid batching sizes each piggybacked prefill
chunk to the decode step's LEFTOVER budget: a fused step's first forward
carries one token column per active decode slot plus the chunk, so with
`fuse_budget` total columns the chunk gets `fuse_budget - active` of
them (floored at 1, so a full step still drips the prompt forward).  The
batcher pads every chunk to the fixed `fuse_budget` width; the policy
decides how many of those columns are real tokens, and keeps the host
counters of the fused schedule.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FuseStats:
    """Host counters for the fused scheduler (monotonic per batcher)."""
    steps: int = 0              # fused steps dispatched
    prefill_tokens: int = 0     # real prompt tokens piggybacked
    dedicated_windows: int = 0  # ticks that fell back to a dedicated
    #                             prefill window (no decode batch, or a
    #                             spec tick)


class FusePolicy:
    """Leftover-budget chunk sizing + fuse accounting.

    fuse_budget: total token columns of the fused step's first forward
    (decode slots + chunk).  The returned chunk is clamped to the
    prompt's remaining tokens and to the padded lane width (the lane is
    `fuse_budget` wide, so a chunk can never exceed it even when no
    slot is decoding).
    """

    def __init__(self, fuse_budget: int) -> None:
        if fuse_budget < 1:
            raise ValueError(
                f'fuse_budget must be >= 1, got {fuse_budget}')
        self.fuse_budget = fuse_budget
        self.stats = FuseStats()

    def chunk(self, remaining: int, active_slots: int) -> int:
        """Real tokens to piggyback this step: fill the leftover budget
        (never 0 while prompt remains — the fused step must make
        prefill progress, or a saturated decode batch would starve the
        prompt forever)."""
        if remaining <= 0:
            return 0
        leftover = max(1, self.fuse_budget - active_slots)
        return min(remaining, leftover, self.fuse_budget)

    def utilization(self, chunk: int) -> float:
        """Fraction of the padded prefill lane carrying real tokens."""
        return chunk / float(self.fuse_budget)

    def record_fused(self, chunk: int) -> None:
        self.stats.steps += 1
        self.stats.prefill_tokens += chunk

    def record_dedicated(self) -> None:
        self.stats.dedicated_windows += 1
