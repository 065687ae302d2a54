"""Blockwise (chunked) cross-entropy over a large vocabulary.

Counterpart of skypilot_tpu/ops/losses.py.  The full-logits loss holds a
(B, S, V) float32 tensor from the forward to the backward; here the
sequence goes through the head in chunks of ``chunk_size`` tokens, each
under ``torch.utils.checkpoint`` (the JAX ``lax.scan`` over
``jax.checkpoint``-ed chunks becomes a Python loop), so only one
(B, C, V) logits block exists at a time, in the forward and, recomputed,
in the backward.  The math is the full softmax CE's (f32 logsumexp), so
chunked and unchunked agree.  The head product is a plain matmul.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def token_logprobs(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """log p(targets) from logits, (..., S) f32, in the logsumexp form:
    the one implementation of the CE numerics that every loss calls."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return picked - lse


def token_logprobs_from_hidden(h: torch.Tensor, lm_head: torch.Tensor,
                               targets: torch.Tensor) -> torch.Tensor:
    """log p(targets) (B, S) f32 from pre-head hidden states: one block."""
    return token_logprobs((h @ lm_head).float(), targets)


def chunked_token_logprobs(h: torch.Tensor, lm_head: torch.Tensor,
                           targets: torch.Tensor, *,
                           chunk_size: int) -> torch.Tensor:
    """log p(targets) (B, S) f32, never holding more than one
    (B, chunk_size, V) logits block.

    h: (B, S, D) hidden states (post final-norm), any dtype.
    lm_head: (D, V).  targets: (B, S) int.
    A ragged tail (S % chunk_size) is computed as one direct block.
    """
    if chunk_size <= 0:
        raise ValueError(f'chunk_size must be positive, got {chunk_size}')
    seq = h.shape[1]
    n_chunks, tail = divmod(seq, chunk_size)
    if n_chunks == 0:
        return token_logprobs_from_hidden(h, lm_head, targets)
    body_len = n_chunks * chunk_size
    out = [checkpoint(token_logprobs_from_hidden, h[:, c:c + chunk_size],
                      lm_head, targets[:, c:c + chunk_size],
                      use_reentrant=False)
           for c in range(0, body_len, chunk_size)]
    if tail:
        out.append(token_logprobs_from_hidden(
            h[:, body_len:], lm_head, targets[:, body_len:]))
    return torch.cat(out, dim=1)


def chunked_softmax_xent(h: torch.Tensor, lm_head: torch.Tensor,
                         targets: torch.Tensor, *,
                         chunk_size: int) -> torch.Tensor:
    """Mean next-token cross entropy via chunked_token_logprobs."""
    return -torch.mean(chunked_token_logprobs(h, lm_head, targets,
                                              chunk_size=chunk_size))
