"""Blockwise (chunked) cross-entropy over a large vocabulary.

Counterpart of skypilot_tpu/ops/losses.py.  The full-logits loss holds a
(B, S, V) float32 tensor from the forward to the backward; here the
sequence goes through the head in chunks of ``chunk_size`` tokens, each
under ``torch.utils.checkpoint`` (the JAX ``lax.scan`` over
``jax.checkpoint``-ed chunks becomes a Python loop), so only one
(B, C, V) logits block exists at a time, in the forward and, recomputed,
in the backward.  The math is the full softmax CE's (f32 logsumexp), so
chunked and unchunked agree.  The head product is a plain matmul.

Under a training mesh whose 'tp' axis splits the vocabulary (the head is
``P('fsdp', 'tp')``), each rank holds a vocabulary block of the logits:
:func:`vocab_parallel_logprobs` takes the row max and the sum of
exponentials over the blocks (a max and a rank-order sum over tp) and
the target's logit from the block that holds it, so the head is never
gathered and its product splits over tp.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.parallel import collectives


def token_logprobs(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """log p(targets) from logits, (..., S) f32, in the logsumexp form:
    the one implementation of the CE numerics that every loss calls."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return picked - lse


def vocab_parallel_logprobs(logits: torch.Tensor, targets: torch.Tensor,
                            mesh, axis: str = 'tp') -> torch.Tensor:
    """log p(targets) (..., S) f32 from this rank's vocabulary block of
    the logits (block i of n equal ones along the last dim, i = the
    rank's index over `axis`), the same on every rank of the axis.  The
    max over the blocks carries no gradient (the logsumexp's does not
    depend on it); the sums over blocks are rank-order all-reduces whose
    transpose is the identity (every rank holds the same loss)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return token_logprobs(logits, targets)
    logits = logits.float()
    v_local = logits.shape[-1]
    lo = mesh.axis_index(axis) * v_local
    m = collectives.all_reduce_max(logits.detach().amax(dim=-1), mesh,
                                   axis)
    sum_exp = collectives.sum_forward(
        torch.exp(logits - m[..., None]).sum(dim=-1), mesh, axis)
    local = targets.long() - lo
    valid = (local >= 0) & (local < v_local)
    picked = torch.gather(logits, -1,
                          local.clamp(0, v_local - 1)[..., None])[..., 0]
    picked = collectives.sum_forward(torch.where(valid, picked, 0.0), mesh,
                                     axis)
    return picked - (m + torch.log(sum_exp))


def token_logprobs_from_hidden(h: torch.Tensor, lm_head: torch.Tensor,
                               targets: torch.Tensor,
                               mesh=None) -> torch.Tensor:
    """log p(targets) (B, S) f32 from pre-head hidden states: one block
    (lm_head this rank's vocabulary block under a mesh)."""
    return vocab_parallel_logprobs((h @ lm_head).float(), targets, mesh)


def chunked_token_logprobs(h: torch.Tensor, lm_head: torch.Tensor,
                           targets: torch.Tensor, *,
                           chunk_size: int, mesh=None) -> torch.Tensor:
    """log p(targets) (B, S) f32, never holding more than one
    (B, chunk_size, V) logits block.

    h: (B, S, D) hidden states (post final-norm), any dtype.
    lm_head: (D, V).  targets: (B, S) int.
    A ragged tail (S % chunk_size) is computed as one direct block.
    Under a mesh lm_head is this rank's vocabulary block
    (vocab_parallel_logprobs).
    """
    if chunk_size <= 0:
        raise ValueError(f'chunk_size must be positive, got {chunk_size}')
    seq = h.shape[1]
    n_chunks, tail = divmod(seq, chunk_size)
    if n_chunks == 0:
        return token_logprobs_from_hidden(h, lm_head, targets, mesh)
    body_len = n_chunks * chunk_size
    out = [checkpoint(token_logprobs_from_hidden, h[:, c:c + chunk_size],
                      lm_head, targets[:, c:c + chunk_size], mesh,
                      use_reentrant=False)
           for c in range(0, body_len, chunk_size)]
    if tail:
        out.append(token_logprobs_from_hidden(
            h[:, body_len:], lm_head, targets[:, body_len:], mesh))
    return torch.cat(out, dim=1)


def chunked_softmax_xent(h: torch.Tensor, lm_head: torch.Tensor,
                         targets: torch.Tensor, *,
                         chunk_size: int) -> torch.Tensor:
    """Mean next-token cross entropy via chunked_token_logprobs."""
    return -torch.mean(chunked_token_logprobs(h, lm_head, targets,
                                              chunk_size=chunk_size))
