"""Pooled KV arena and its host-side block accounting.

Counterpart of skypilot_tpu/infer/block_pool.py (this package keeps its
own copy of the host logic and imports nothing of the JAX package):

- arena: k/v tensors (L, NB, BS, KV, hd), one allocation for the
  process lifetime.  Block 0 is the reserved GARBAGE block: never
  allocated, never read (the decode length mask hides every logical row
  a table does not back), and the write target of unmapped table
  entries, so pad rows and frozen slots write there instead of needing
  a branch.  The arena is updated in place (the JAX package donated it
  to each jitted step instead).
- free list and refcounts live on the host: allocation is list math,
  not device work; a sequence that outgrows its blocks appends ids from
  the free list to its host block table and re-uploads the table.

An int8 arena (kv_dtype='int8') holds int8 k/v and (L, NB, BS, KV) f32
absmax scales k_scale/v_scale.  The host tier's in-flight tracking comes
with a later slice (ROADMAP.md Queue A item 9).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from skypilot_tpu_torch.infer import llama_infer
from skypilot_tpu_torch.models import llama

Cache = Dict[str, torch.Tensor]

GARBAGE_BLOCK = 0


class PoolExhaustedError(RuntimeError):
    """An allocation needs more blocks than the free list holds.  The
    batcher treats this as admission backpressure (requests stay
    queued).  `retry_after_s`, when set, is retry advice the HTTP layer
    turns into a retryable 503 with Retry-After."""

    def __init__(self, *args,
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(*args)
        self.retry_after_s = retry_after_s


def init_arena(config: llama.LlamaConfig, n_blocks: int,
               block_size: int, kv_dtype: Optional[str] = None,
               device=None) -> Cache:
    """Allocate the pooled arena on `device` (default: the CUDA card):
    k/v zeros (L, NB, BS, KV, hd) in the model dtype, or int8 with
    (L, NB, BS, KV) f32 scales for kv_dtype='int8' -- the layout of
    llama_infer.init_cache with NB blocks in place of B slots."""
    return llama_infer.init_cache(config, n_blocks, block_size,
                                  kv_dtype=kv_dtype, device=device)


def block_nbytes(config: llama.LlamaConfig, block_size: int,
                 kv_dtype: Optional[str] = None) -> int:
    """Device bytes of ONE physical block across all layers (K + V, plus
    scales for int8)."""
    elem = (1 if kv_dtype == 'int8'
            else torch.empty((), dtype=config.dtype).element_size())
    n = (2 * config.n_layers * block_size * config.n_kv_heads
         * config.head_dim * elem)
    if kv_dtype == 'int8':
        n += 2 * config.n_layers * block_size * config.n_kv_heads * 4
    return n


class BlockPool:
    """Host-side accounting for the pooled arena: free list, refcounts,
    admission reservations.  The free list is LIFO (the most recently
    freed block is reused first), which keeps block ids deterministic
    for a given sequence of admissions."""

    def __init__(self, config: llama.LlamaConfig, n_blocks: int,
                 block_size: int, kv_dtype: Optional[str] = None,
                 device=None):
        if n_blocks < 2:
            raise ValueError(f'pool needs >= 2 blocks (1 garbage + 1 '
                             f'allocatable), got {n_blocks}')
        if block_size < 1:
            raise ValueError(f'block_size must be >= 1, '
                             f'got {block_size}')
        self.config = config
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.arena = init_arena(config, n_blocks, block_size,
                                kv_dtype=kv_dtype, device=device)
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._refs = np.zeros(n_blocks, np.int32)
        self._refs[GARBAGE_BLOCK] = 1  # pinned forever
        self._reserved = 0
        self.hwm = 0
        self.table_appends = 0
        self.prefix_shares = 0

    # -- introspection ---------------------------------------------------

    def free_blocks(self) -> int:
        return len(self._free)

    def live_blocks(self) -> int:
        """Blocks with refcount > 0, excluding the garbage block."""
        return self.n_blocks - 1 - len(self._free)

    def available(self) -> int:
        """Free blocks not spoken for by an admission reservation."""
        return len(self._free) - self._reserved

    def refcount(self, block_id: int) -> int:
        return int(self._refs[block_id])

    def check_invariant(self) -> None:
        """Assert the pool's conservation law: every non-garbage block is
        either free or referenced (free + live == n_blocks - 1),
        refcounts are non-negative, the free list holds no duplicates and
        no referenced ids, and reservations never exceed the free list."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError('free list contains duplicate ids')
        if GARBAGE_BLOCK in free:
            raise AssertionError('garbage block on the free list')
        referenced = int(np.sum(self._refs[1:] > 0))
        if referenced + len(self._free) != self.n_blocks - 1:
            raise AssertionError(
                f'block conservation violated: referenced={referenced} '
                f'free={len(self._free)} total={self.n_blocks}')
        if np.any(self._refs < 0):
            raise AssertionError('negative refcount')
        for b in free:
            if self._refs[b] != 0:
                raise AssertionError(
                    f'free block {b} has refcount {self._refs[b]}')
        if self._reserved > len(self._free):
            raise AssertionError(
                f'reservation {self._reserved} exceeds free list '
                f'{len(self._free)}')

    # -- reservations (admission backpressure) ---------------------------

    def reserve(self, k: int) -> bool:
        """Claim k free blocks for an admission without assigning ids.
        Returns False (no side effects) when the pool cannot cover it."""
        if k > self.available():
            return False
        self._reserved += k
        return True

    def unreserve(self, k: int) -> None:
        if k > self._reserved:
            raise AssertionError(
                f'unreserve({k}) exceeds outstanding reservation '
                f'{self._reserved}')
        self._reserved -= k

    # -- allocation ------------------------------------------------------

    def alloc(self, k: int, *, from_reservation: bool = False
              ) -> List[int]:
        """Pop k blocks off the free list (refcount 1 each).
        from_reservation: the caller holds a prior reserve() covering
        these blocks, which is drawn down."""
        if k > len(self._free):
            raise PoolExhaustedError(
                f'KV block pool exhausted: need {k} blocks, '
                f'{len(self._free)} free of {self.n_blocks} total '
                f'(block_size={self.block_size}). Raise '
                f'GeneratorConfig.pool_blocks or lower concurrency.')
        if from_reservation:
            if k > self._reserved:
                raise AssertionError(
                    f'alloc(from_reservation) of {k} exceeds '
                    f'reservation {self._reserved}')
            self._reserved -= k
        ids = [self._free.pop() for _ in range(k)]
        self._refs[ids] = 1
        self.hwm = max(self.hwm, self.live_blocks())
        self.table_appends += k
        return ids

    def share(self, ids: Sequence[int], *, prefix: bool = False) -> None:
        """Bump refcounts: a second owner now references the same
        physical blocks (the prefix cache's copy-free warm hit)."""
        for b in ids:
            if self._refs[b] <= 0:
                raise AssertionError(
                    f'share of unreferenced block {b}')
            self._refs[b] += 1
        if prefix:
            self.prefix_shares += len(ids)

    def release(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; blocks reaching refcount 0 return
        to the free list."""
        for b in ids:
            if b == GARBAGE_BLOCK:
                raise AssertionError('release of the garbage block')
            if self._refs[b] <= 0:
                raise AssertionError(
                    f'release of already-free block {b}')
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    def stats(self) -> Dict[str, int]:
        return {
            'blocks_total': self.n_blocks,
            'blocks_live': self.live_blocks(),
            'blocks_free': len(self._free),
            'reserved': self._reserved,
            'hwm': self.hwm,
            'block_size': self.block_size,
            'table_appends': self.table_appends,
            'prefix_shares': self.prefix_shares,
        }
