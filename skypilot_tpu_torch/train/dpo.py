"""DPO: direct preference optimization over {prompt, chosen, rejected}
pairs.

Counterpart of skypilot_tpu/train/dpo.py (Rafailov et al. 2023, eq. 7):

    L = -log sigmoid(beta * ((pi_c - ref_c) - (pi_r - ref_r)))

where pi_x / ref_x are the policy / reference summed logprobs of the
chosen / rejected completion tokens (prompt-masked, as in SFT).

The reference passes run under ``torch.no_grad()``, the counterpart of
``stop_gradient``: no graph is kept for them, and the flash attention
takes K2 without its lse there.  Full-parameter DPO holds a frozen copy
of the initial params.  LoRA-DPO needs none: the reference policy is the
frozen base the adapters close over.

Under a training mesh (``mesh=``, ``rules=``) the policy and the
reference are this rank's blocks (the reference sharded as the policy),
the batch is this rank's pairs, a pair's summed logprob is added over
the sp blocks of its sequence, and the mean over pairs is the global
batch's, the same on every rank.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import sft as sft_lib


def _sequence_logprobs(params, tokens: torch.Tensor, mask: torch.Tensor,
                       config: llama.LlamaConfig, mesh=None,
                       rules=sharding.LLAMA_RULES) -> torch.Tensor:
    """(B,) summed logprob of masked TARGET tokens (tokens[:, 1:]); under
    a mesh this rank's pairs, each summed over its sp blocks."""
    lp = sft_lib.token_logprobs(params, tokens, config, mesh, rules)
    mask = sft_lib.rank_targets(mask.to(lp.dtype), mesh)
    return collectives.sum_forward((lp * mask).sum(dim=-1), mesh, 'sp')


def _four_logprobs(params, ref_params, batch, config, mesh=None,
                   rules=sharding.LLAMA_RULES):
    """(pi_c, pi_r, ref_c, ref_r); the reference's without a graph."""
    sides = (('tokens_chosen', 'mask_chosen'),
             ('tokens_rejected', 'mask_rejected'))
    pi = [_sequence_logprobs(params, batch[t], batch[m], config, mesh,
                             rules) for t, m in sides]
    with torch.no_grad():
        ref = [_sequence_logprobs(ref_params, batch[t], batch[m], config,
                                  mesh, rules) for t, m in sides]
    return pi[0], pi[1], ref[0], ref[1]


def _pair_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of a per-pair value over the global batch (its pairs
    split over dp x fsdp, each whole on every sp rank)."""
    if mesh is None:
        return torch.mean(x)
    return llama.mesh_mean(x.sum(), x.numel(), mesh, ('dp', 'fsdp'))


def dpo_loss_fn(params, ref_params, batch: Dict[str, torch.Tensor],
                config: llama.LlamaConfig,
                beta: float = 0.1, mesh=None,
                rules: sharding.PartitionRules = sharding.LLAMA_RULES
                ) -> torch.Tensor:
    """batch: tokens_chosen/tokens_rejected (B, S+1) int and
    mask_chosen/mask_rejected (B, S): the masks gate completion targets
    exactly as in SFT.  ref_params get no gradient, so the policy's own
    base tree (LoRA mode) stays frozen."""
    pi_c, pi_r, ref_c, ref_r = _four_logprobs(params, ref_params, batch,
                                              config, mesh, rules)
    margin = beta * ((pi_c - ref_c) - (pi_r - ref_r))
    return -_pair_mean(F.logsigmoid(margin), mesh)


@torch.no_grad()
def dpo_metrics(params, ref_params, batch, config,
                beta: float = 0.1, mesh=None,
                rules: sharding.PartitionRules = sharding.LLAMA_RULES
                ) -> Dict[str, torch.Tensor]:
    """Reward margin and accuracy (the share of pairs where the implicit
    reward prefers chosen), as device scalars."""
    pi_c, pi_r, ref_c, ref_r = _four_logprobs(params, ref_params, batch,
                                              config, mesh, rules)
    rw_c = beta * (pi_c - ref_c)
    rw_r = beta * (pi_r - ref_r)
    return {'reward_margin': _pair_mean(rw_c - rw_r, mesh),
            'reward_accuracy': _pair_mean((rw_c > rw_r).float(), mesh)}


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path, encoding='utf-8') as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            ex = json.loads(line)
            for field in ('prompt', 'chosen', 'rejected'):
                if field not in ex:
                    raise ValueError(
                        f'{path}:{i + 1}: each JSONL line needs '
                        f'"prompt", "chosen" and "rejected" fields')
            out.append(ex)
    if not out:
        raise ValueError(f'{path}: no examples')
    return out


def dpo_batches(path: str, encode: Callable[[str], List[int]],
                batch_size: int, seq_len: int,
                eos_id: Optional[int] = None, seed: int = 0,
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epochs over the pair file; each side encoded with the SFT
    example encoder (same truncation and mask)."""
    examples = load_jsonl(path)
    rng = np.random.default_rng(seed)
    encoded = []
    for ex in examples:
        prompt_ids = encode(ex['prompt'])
        sides = {}
        for side in ('chosen', 'rejected'):
            ids = encode(ex[side])
            if eos_id is not None:
                ids = ids + [eos_id]
            sides[side] = sft_lib.encode_example(prompt_ids, ids, seq_len)
        encoded.append(sides)
    while True:
        order = rng.permutation(len(encoded))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            rows = [encoded[i] for i in order[start:start + batch_size]]
            yield {
                'tokens_chosen': np.stack([r['chosen'][0] for r in rows]),
                'mask_chosen': np.stack([r['chosen'][1] for r in rows]),
                'tokens_rejected': np.stack(
                    [r['rejected'][0] for r in rows]),
                'mask_rejected': np.stack(
                    [r['rejected'][1] for r in rows]),
            }
