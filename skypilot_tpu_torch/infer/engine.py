"""Generation config and the helpers the batcher shares with it.

Counterpart of the pooled-serving subset of skypilot_tpu/infer/engine.py:
``GeneratorConfig`` with the same validation errors, ``derive_buckets``,
``validate_context`` and ``host_fetch``.  Options this slice does not
carry raise ``NotImplementedError`` naming their ROADMAP.md item.  The
lockstep ``Generator`` entry point comes with ROADMAP.md Queue A item 13.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _deferred(option: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f'{option} is not ported yet: ROADMAP.md Queue A item {item}')


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    max_seq_len: int = 2048
    batch_size: int = 1
    # Prompt buckets (right-padded): ascending; the largest must not
    # exceed max_seq_len.  None -> powers of two from 64.
    prompt_buckets: Optional[Sequence[int]] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    # None = model dtype.  'int8' comes with Queue A item 7.
    kv_cache_dtype: Optional[str] = None
    weights_dtype: Optional[str] = None
    # Only the pooled block-arena data plane is ported.
    decode_impl: str = 'pooled'
    # Chunked prefill: prompts LONGER than this many tokens prefill in
    # prefill_chunk-sized windows interleaved with decode ticks.
    # None = whole-prompt prefill.
    prefill_chunk: Optional[int] = None
    # Steps per decode chunk of the lockstep Generator (the batcher takes
    # its own decode_chunk argument).
    decode_chunk: int = 32
    # Radix prefix KV cache budget (Queue A item 9).
    prefix_cache_mb: Optional[float] = None
    prefix_block: int = 64
    # Pooled arena block size in cache rows.  None -> 64 capped at
    # max_seq_len.
    kv_block_size: Optional[int] = None
    # Physical blocks in the arena including the garbage block 0.
    # None -> enough for every slot to reach max_seq_len.
    pool_blocks: Optional[int] = None
    # Speculative decoding (Queue A item 8).
    spec_k: int = 0
    # Collective overlap for sharded decode (Queue A item 10).
    overlap_collectives: Optional[bool] = None
    overlap_chunks: Optional[int] = None
    # Host-DRAM KV tier (Queue A item 9).
    host_tier_mb: Optional[float] = None
    # Chunked-prefill piggyback on the decode step (Queue A item 8).
    fuse_budget: Optional[int] = None

    def __post_init__(self):
        if self.decode_impl != 'pooled':
            raise _deferred(f'decode_impl={self.decode_impl!r}', 14)
        if self.fuse_budget is not None:
            if self.fuse_budget < 1:
                raise ValueError(f'fuse_budget must be >= 1, got '
                                 f'{self.fuse_budget}')
            if self.prefill_chunk is None:
                raise ValueError(
                    f'fuse_budget={self.fuse_budget} piggybacks the '
                    f'chunked-prefill lane; set prefill_chunk (the '
                    f'threshold above which prompts prefill '
                    f'incrementally) to enable it')
        if self.host_tier_mb is not None and self.host_tier_mb < 0:
            raise ValueError(f'host_tier_mb must be >= 0, got '
                             f'{self.host_tier_mb}')
        if self.host_tier_mb and not self.prefix_cache_mb:
            raise ValueError(
                f'host_tier_mb={self.host_tier_mb} spills evicted '
                f'prefix-cache blocks; set prefix_cache_mb (the '
                f'device-tier budget the host tier sits behind) '
                f'to enable it')
        if self.overlap_chunks is not None and self.overlap_chunks < 1:
            raise ValueError(f'overlap_chunks must be >= 1, got '
                             f'{self.overlap_chunks}')
        if self.spec_k < 0:
            raise ValueError(f'spec_k must be >= 0, got {self.spec_k}')
        if self.spec_k and self.spec_k + 1 >= self.max_seq_len:
            raise ValueError(
                f'spec_k={self.spec_k} leaves no room for a verify '
                f'window inside max_seq_len={self.max_seq_len}')
        if self.kv_block_size is not None and self.kv_block_size < 1:
            raise ValueError(f'kv_block_size must be >= 1, got '
                             f'{self.kv_block_size}')
        if self.pool_blocks is not None and self.pool_blocks < 2:
            raise ValueError(f'pool_blocks must be >= 2 (garbage block '
                             f'+ 1), got {self.pool_blocks}')
        bs = self.derive_block_size()
        if self.prefix_cache_mb and self.prefix_block % bs:
            raise ValueError(
                f'prefix_block={self.prefix_block} must be a '
                f'multiple of kv_block_size={bs} under the pooled '
                f'data plane (a trie node must map to whole arena '
                f'blocks); pick kv_block_size from the divisors of '
                f'prefix_block')
        for name in ('kv_cache_dtype', 'weights_dtype'):
            value = getattr(self, name)
            if value == 'int8':
                raise _deferred(f"{name}='int8'", 7)
            if value is not None:
                raise ValueError(f"{name} must be None or 'int8', "
                                 f'got {value!r}')
        if self.spec_k:
            raise _deferred(f'spec_k={self.spec_k}', 8)
        if self.fuse_budget is not None:
            raise _deferred(f'fuse_budget={self.fuse_budget}', 8)
        if self.prefix_cache_mb:
            raise _deferred(f'prefix_cache_mb={self.prefix_cache_mb}', 9)
        if self.host_tier_mb:
            raise _deferred(f'host_tier_mb={self.host_tier_mb}', 9)
        if self.overlap_collectives:
            raise _deferred('overlap_collectives=True', 10)

    def derive_block_size(self) -> int:
        """Resolved pooled-arena block size (kv_block_size default)."""
        if self.kv_block_size is not None:
            return self.kv_block_size
        bs = min(64, self.max_seq_len)
        if self.prefix_cache_mb and self.prefix_block:
            bs = math.gcd(bs, self.prefix_block)
        return bs


def validate_context(gen_config: GeneratorConfig, model_config) -> None:
    """The engine's context window must fit the model's positional
    ceiling."""
    if gen_config.max_seq_len > model_config.max_seq_len:
        raise ValueError(
            f'GeneratorConfig.max_seq_len={gen_config.max_seq_len} '
            f'exceeds the model\'s context ceiling '
            f'{model_config.max_seq_len} (for Mistral this is the '
            f'sliding window — serving beyond it would silently change '
            f'attention semantics)')


def derive_buckets(gen_config: GeneratorConfig):
    """Prompt buckets for a GeneratorConfig; validates that the largest
    bucket fits max_seq_len."""
    if gen_config.prompt_buckets:
        buckets = sorted(gen_config.prompt_buckets)
    else:
        buckets, b = [], 64
        while b < gen_config.max_seq_len:
            buckets.append(b)
            b *= 2
        buckets.append(gen_config.max_seq_len)
    if buckets[-1] > gen_config.max_seq_len:
        raise ValueError(
            f'Largest prompt bucket {buckets[-1]} exceeds '
            f'max_seq_len {gen_config.max_seq_len}')
    return buckets


def host_fetch(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """THE device -> host transfer point of the decode data path: every
    fetch of decode results (token blocks, positions, done flags) goes
    through this one call, so the contract of O(1) transfers per decode
    CHUNK, never per token, is countable (``host_fetch.calls``) and
    testable.  Several tensors fetched together count as ONE sync."""
    host_fetch.calls += 1
    return tuple(t.to('cpu').numpy() for t in tensors)


host_fetch.calls = 0
