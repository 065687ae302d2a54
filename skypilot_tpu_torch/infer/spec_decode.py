"""Speculative decoding on the pooled decode plane (draft-verify).

Counterpart of skypilot_tpu/infer/spec_decode.py (this package keeps its
own copy of the host-side drafter and policy).  A model-free n-gram
drafter proposes k tokens per slot on the host, the target model scores
all k + 1 window positions in ONE batched forward
(``llama_infer.decode_verify_pooled``), and :func:`accept_window` commits
the matching prefix plus the target's own token at the first mismatch.
A chunk still costs one counted ``engine.host_fetch``.

Rollback contract: rejected window rows are never cleaned up.  The
accept step does not advance ``positions`` past the last committed
token; the pooled plane's `key <= position` masks hide the stale rows
and the next chunk overwrites them in place.  Block tables, refcounts and
the free list are untouched.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class NgramDrafter:
    """Per-slot n-gram drafter: order-(max_order..1) backoff tables
    mapping a recent-context tuple to the token that followed it last
    time (most recent occurrence wins — cheap, adaptive, and exact on
    repetitive spans, which is where speculation pays).

    Host-side and pure python ints end to end: `observe` consumes the
    token block the engine ALREADY fetched for its output buffers, so
    drafting adds zero device work and zero host syncs.
    """

    def __init__(self, batch: int, k: int, *, max_order: int = 3):
        if k < 1:
            raise ValueError(f'drafter needs k >= 1, got {k}')
        self.k = int(k)
        self.max_order = int(max_order)
        self._history: List[List[int]] = [[] for _ in range(batch)]
        self._tables: List[Dict[Tuple[int, ...], int]] = [
            {} for _ in range(batch)]
        # Radix-trie continuation ("golden future"): tokens another
        # request already generated after this slot's prompt.  While
        # the slot's own stream keeps matching it, propose() reads the
        # future VERBATIM (n-grams can't disambiguate repetitive spans;
        # the literal replay can) — first divergence drops it for good
        # and the slot falls back to its n-gram table.
        self._future: List[List[int]] = [[] for _ in range(batch)]
        self._future_pos: List[int] = [0] * batch

    def _learn(self, slot: int, seq: Sequence[int]) -> None:
        table = self._tables[slot]
        for order in range(1, self.max_order + 1):
            for i in range(order, len(seq)):
                table[tuple(seq[i - order:i])] = int(seq[i])

    def reset(self, slot: int, tokens: Sequence[int],
              continuation: Sequence[int] = ()) -> None:
        """(Re)seed a slot: `tokens` is the prompt (becomes the slot's
        history); `continuation` is an OPTIONAL radix-trie continuation
        of that prompt (tokens another request already generated after
        the shared prefix) — its n-grams go into the table so the very
        first chunks draft from the cached future, but it is NOT
        history: the model may diverge from it."""
        toks = [int(t) for t in tokens]
        self._history[slot] = toks
        self._tables[slot] = {}
        self._learn(slot, toks)
        self._future[slot] = [int(t) for t in continuation]
        self._future_pos[slot] = 0
        if continuation:
            tail = toks[-self.max_order:] if toks else []
            self._learn(slot, tail + [int(t) for t in continuation])

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        """Fold freshly COMMITTED tokens into the slot's history and
        n-gram table (incremental: only the new transitions), and
        advance/drop the golden future against the real stream."""
        hist = self._history[slot]
        table = self._tables[slot]
        future = self._future[slot]
        for t in tokens:
            t = int(t)
            if future:
                pos = self._future_pos[slot]
                if pos < len(future) and future[pos] == t:
                    self._future_pos[slot] = pos + 1
                else:
                    # Diverged (or exhausted): the cached continuation
                    # no longer predicts this stream.
                    self._future[slot] = future = []
            for order in range(1, self.max_order + 1):
                if len(hist) >= order:
                    table[tuple(hist[-order:])] = t
            hist.append(t)

    def propose(self, slot: int) -> List[int]:
        """Draft k tokens: the still-matching golden future first
        (verbatim — exact where n-grams are ambiguous), then the
        backoff table from the history tail, extending the context
        with each guess (so a matched 3-gram chain drafts a whole
        span).  Backoff miss repeats the last token — a throwaway
        guess the verify step rejects for free."""
        out: List[int] = []
        future = self._future[slot]
        if future:
            pos = self._future_pos[slot]
            out = [int(t) for t in future[pos:pos + self.k]]
            if len(out) >= self.k:
                return out
        ctx = list((self._history[slot] + out)[-self.max_order:])
        table = self._tables[slot]
        for _ in range(self.k - len(out)):
            nxt: Optional[int] = None
            for order in range(min(self.max_order, len(ctx)), 0, -1):
                nxt = table.get(tuple(ctx[-order:]))
                if nxt is not None:
                    break
            if nxt is None:
                nxt = ctx[-1] if ctx else 0
            out.append(int(nxt))
            ctx.append(int(nxt))
        return out

    def propose_batch(self, live: Sequence[int],
                      batch: int) -> np.ndarray:
        """(batch, k) int32 proposals; rows not in `live` draft zeros
        (their lanes are masked dead in the accept step anyway)."""
        draft = np.zeros((batch, self.k), dtype=np.int32)
        for slot in live:
            draft[slot] = self.propose(slot)
        return draft


class SpecPolicy:
    """Adaptive speculation gate: an EMA of the per-chunk draft
    acceptance rate decides between the verify window and the plain
    fused sequential chunk.

    Speculation only pays when the drafter is right: a W-wide verify
    forward that commits one token costs more than a 1-wide step AND
    syncs every chunk, while the sequential chunk amortizes one sync
    over `decode_chunk` steps.  So an adversarial (low-acceptance)
    stream must not pay the window price forever — when the EMA drops
    below the threshold the engine falls back to sequential chunks and
    re-probes one verify chunk every `probe_period` chunks, so a
    stream that turns repetitive again is re-detected.  Starts
    optimistic (EMA 1.0): the first chunks speculate, and a genuinely
    high-acceptance stream never leaves the fast path.  The defaults
    (decay 0.7, threshold 0.35) drop a cold stream to sequential after
    ONE near-zero chunk while a single mediocre chunk in a good stream
    (rate 0.5 -> EMA 0.65) stays on the fast path."""

    def __init__(self, *, decay: float = 0.7, threshold: float = 0.35,
                 probe_period: int = 16):
        self.ema = 1.0
        self.decay = decay
        self.threshold = threshold
        self.probe_period = probe_period
        self._cool = 0

    def should_speculate(self) -> bool:
        if self.ema >= self.threshold:
            return True
        if self._cool <= 0:
            self._cool = self.probe_period
            return True
        self._cool -= 1
        return False

    def record(self, accepted: int, proposed: int) -> None:
        if proposed <= 0:
            return
        rate = accepted / proposed
        self.ema = (1.0 - self.decay) * self.ema + self.decay * rate


def accept_window(targets: torch.Tensor, accepts: torch.Tensor,
                  done: torch.Tensor, limit: torch.Tensor,
                  positions: torch.Tensor, token: torch.Tensor,
                  *, eos: Optional[int], fill: int):
    """Accept/rollback: replay the decode chunk's commit semantics over
    the W = k + 1 verified candidates.

    targets (B, W) int32, the target's token at every window position;
    accepts (B,) int32, the length of the draft prefix the target agreed
    with (candidates 0..accepts are committable); done/limit/positions/
    token, the decode chunk's carry.  Each window column runs the
    sequential chunk's per-token update (live mask, fill for dead lanes,
    eos/limit stopping, position advance), gated by `col <= accepts`: the
    first rejected column freezes the lane for the rest of the window,
    which IS the rollback.

    Returns (emitted (B, W), token, positions, done, limit, committed
    (B,) int32, the tokens really committed this chunk)."""
    win = targets.shape[1]
    committed = torch.zeros_like(positions)
    toks = []
    for i in range(win):
        nxt = targets[:, i]
        live = torch.logical_not(done) & (i <= accepts)
        live_i = live.to(torch.int32)
        toks.append(torch.where(live, nxt, fill))
        limit = limit - live_i
        hit = (limit <= 0) if eos is None else (nxt == eos) | (limit <= 0)
        done = done | (live & hit)
        positions = positions + live_i
        token = torch.where(live, nxt, token)
        committed = committed + live_i
    return (torch.stack(toks, dim=1), token, positions, done, limit,
            committed)
