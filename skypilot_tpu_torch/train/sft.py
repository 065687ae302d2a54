"""Supervised finetuning (SFT): prompt-masked cross entropy and the JSONL
data path.

Counterpart of skypilot_tpu/train/sft.py: train only on the COMPLETION
tokens of {prompt, completion} pairs.  The loss composes with the
blockwise CE (config.loss_chunk), since the mask applies to per-token
logprobs, and takes Mixtral-family configs (models/moe.py) with their
router aux loss.  The data path is the JAX package's numpy code, so the
same file and seed give the same arrays in both packages.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch.models import llama, moe
from skypilot_tpu_torch.ops import losses as losses_ops


def token_logprobs(params, tokens: torch.Tensor,
                   config: llama.LlamaConfig) -> torch.Tensor:
    """(B, S) f32 log p(tokens[:, 1:]) under params: the blockwise CE
    when config.loss_chunk is set (never the full (B, S, V) logits),
    else the full logits.  The SFT, DPO and GRPO losses all call it."""
    if config.loss_chunk:
        h = llama.hidden_states(params, tokens[:, :-1], config)
        return losses_ops.chunked_token_logprobs(
            h, params['lm_head'], tokens[:, 1:],
            chunk_size=config.loss_chunk)
    logits = llama.forward(params, tokens[:, :-1], config)
    return llama.token_logprobs(logits, tokens[:, 1:])


def sft_loss_fn(params, batch: Dict[str, torch.Tensor],
                config: llama.LlamaConfig) -> torch.Tensor:
    """Masked next-token CE.  batch: {'tokens': (B, S+1) int, 'loss_mask':
    (B, S)}: mask[b, j] gates the loss on TARGET tokens[b, j+1] (1.0 for
    completion tokens, 0.0 for prompt and pad).  A MoE config
    (models/moe.py) adds router_aux_weight x the router aux loss, so a
    finetune keeps the expert assignment balanced."""
    tokens = batch['tokens']
    aux = None
    if hasattr(config, 'n_experts'):
        h, aux = moe.hidden_states(params, tokens[:, :-1], config)
        lp = losses_ops.chunked_token_logprobs(
            h, params['lm_head'], tokens[:, 1:],
            chunk_size=config.loss_chunk or tokens.shape[1])
    else:
        lp = token_logprobs(params, tokens, config)
    mask = batch['loss_mask'].to(lp.dtype)
    loss = -(lp * mask).sum() / torch.clamp(mask.sum(), min=1.0)
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
