"""Supervised finetuning (SFT): prompt-masked cross entropy and the JSONL
data path.

Counterpart of skypilot_tpu/train/sft.py: train only on the COMPLETION
tokens of {prompt, completion} pairs.  The loss composes with the
blockwise CE (config.loss_chunk), since the mask applies to per-token
logprobs, and takes Mixtral-family configs (models/moe.py) with their
router aux loss.  The data path is the JAX package's numpy code, so the
same file and seed give the same arrays in both packages.

Under a training mesh (``mesh=``, ``rules=``) the batch holds this
rank's rows (the Trainer splits every key over dp x fsdp), each rank
scores its rows and, under sp, its sequence block of them
(:func:`rank_targets`), and every masked sum is the global batch's: the
rank's share added over the data axes, whose gradient is the rank's own
(Megatron's g), so the loss is the same on every rank.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch.models import llama, moe
from skypilot_tpu_torch.ops import losses as losses_ops
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train.trainer import DATA_AXES


def rank_targets(x: torch.Tensor, mesh) -> torch.Tensor:
    """x (B, S), one value a target token (a mask), cut to this rank's
    sequence block under sp, as llama.rank_tokens cuts the targets (x
    itself without a mesh)."""
    sp = 1 if mesh is None else mesh.axis_size('sp')
    if sp == 1:
        return x
    n = x.shape[1] // sp
    return x[:, mesh.axis_index('sp') * n:][:, :n]


def global_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x added over the data axes in rank order; the gradient of each
    rank's x is the sum's (Megatron's g).  x itself without a mesh."""
    return collectives.sum_forward(x, mesh, DATA_AXES)


def global_count(mask: torch.Tensor, mesh) -> torch.Tensor:
    """max(the mask's sum over the global batch, 1), no gradient."""
    total = mask.sum()
    if mesh is not None:
        total = collectives.all_reduce_sum(total, mesh, DATA_AXES)
    return torch.clamp(total, min=1.0)


def token_logprobs(params, tokens: torch.Tensor,
                   config: llama.LlamaConfig, mesh=None,
                   rules: sharding.PartitionRules = sharding.LLAMA_RULES
                   ) -> torch.Tensor:
    """(B, S) f32 log p(tokens[:, 1:]) under params: the blockwise CE
    when config.loss_chunk is set (never the full (B, S, V) logits),
    else the full logits.  The SFT, DPO and GRPO losses all call it.
    Under a mesh: this rank's rows and sequence block, (B, S / sp)."""
    if mesh is not None:
        return llama.rank_logprobs(params, tokens, config, mesh, rules)
    if config.loss_chunk:
        h = llama.hidden_states(params, tokens[:, :-1], config)
        return losses_ops.chunked_token_logprobs(
            h, params['lm_head'], tokens[:, 1:],
            chunk_size=config.loss_chunk)
    logits = llama.forward(params, tokens[:, :-1], config)
    return llama.token_logprobs(logits, tokens[:, 1:])


def _moe_logprobs(params, tokens: torch.Tensor, config, mesh, rules):
    """(log p of the targets, the router aux loss) of a MoE config, the
    blockwise CE over the head; under a mesh this rank's share."""
    if mesh is None:
        h, aux = moe.hidden_states(params, tokens[:, :-1], config)
        head, shards, targets = params['lm_head'], None, tokens[:, 1:]
    else:
        shards = llama.Shards(mesh, rules)
        inputs, targets = llama.rank_tokens(tokens, shards)
        h, aux = moe._trunk(params, inputs, config, shards)
        h, head = llama.head_block(h, params, shards)
    lp = losses_ops.chunked_token_logprobs(
        h, head, targets, chunk_size=config.loss_chunk or tokens.shape[1],
        mesh=mesh)
    return lp, aux


def sft_loss_fn(params, batch: Dict[str, torch.Tensor],
                config: llama.LlamaConfig, mesh=None,
                rules: Optional[sharding.PartitionRules] = None
                ) -> torch.Tensor:
    """Masked next-token CE.  batch: {'tokens': (B, S+1) int, 'loss_mask':
    (B, S)}: mask[b, j] gates the loss on TARGET tokens[b, j+1] (1.0 for
    completion tokens, 0.0 for prompt and pad).  A MoE config
    (models/moe.py) adds router_aux_weight x the router aux loss, so a
    finetune keeps the expert assignment balanced.  Under a mesh the
    batch is this rank's rows and the loss the global batch's (rules:
    LLAMA_RULES, or MOE_RULES for a MoE config, by default)."""
    tokens = batch['tokens']
    aux = None
    if hasattr(config, 'n_experts'):
        lp, aux = _moe_logprobs(params, tokens, config, mesh,
                                rules or sharding.MOE_RULES)
    else:
        lp = token_logprobs(params, tokens, config, mesh,
                            rules or sharding.LLAMA_RULES)
    mask = rank_targets(batch['loss_mask'].to(lp.dtype), mesh)
    loss = -global_sum((lp * mask).sum(), mesh) / global_count(mask, mesh)
    if aux is not None:
        loss = loss + config.router_aux_weight * aux
    return loss


def encode_example(prompt_ids: List[int], completion_ids: List[int],
                   seq_len: int, pad_id: int = 0):
    """One example -> (tokens (S+1,), mask (S,)).  Truncates from the
    right; the mask covers exactly the completion targets that
    survived."""
    ids = list(prompt_ids) + list(completion_ids)
    ids = ids[:seq_len + 1]
    tokens = np.full((seq_len + 1,), pad_id, np.int32)
    tokens[:len(ids)] = ids
    mask = np.zeros((seq_len,), np.float32)
    # Target position j predicts tokens[j+1]: completion targets start
    # at j = len(prompt) - 1 and end before the pad.
    start = max(len(prompt_ids) - 1, 0)
    stop = max(len(ids) - 1, 0)
    mask[start:stop] = 1.0
    return tokens, mask


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path, encoding='utf-8') as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            ex = json.loads(line)
            if 'prompt' not in ex or 'completion' not in ex:
                raise ValueError(
                    f'{path}:{i + 1}: each JSONL line needs "prompt" '
                    f'and "completion" fields')
            out.append(ex)
    if not out:
        raise ValueError(f'{path}: no examples')
    return out


def sft_batches(path: str, encode: Callable[[str], List[int]],
                batch_size: int, seq_len: int,
                eos_id: Optional[int] = None,
                seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Forever-iterator of SFT batches from a {prompt, completion} JSONL
    file.  `encode`: text -> token ids (the byte fallback here).  eos is
    appended to each completion when given, so the model learns to
    stop."""
    examples = load_jsonl(path)
    pairs = []
    for ex in examples:
        p = list(encode(ex['prompt']))
        c = list(encode(ex['completion']))
        if eos_id is not None:
            c = c + [eos_id]
        pairs.append((p, c))
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(pairs), size=batch_size)
        toks, masks = zip(*(encode_example(*pairs[i], seq_len)
                            for i in idx))
        yield {'tokens': np.stack(toks), 'loss_mask': np.stack(masks)}
