"""GRPO-style RL post-training for the bundled Llama, on one card or a
training mesh.

Counterpart of skypilot_tpu/train/rl.py.  Rollouts come from the
inference engine (``infer.engine.Generator``) on the same card as the
learner (the port's ``Trainer``): actor and learner are colocated, and
the Generator reads the Trainer's live parameter tensors, which the
optimizer updates in place, so every rollout (and every replayed CUDA
graph) samples the newest policy.

On a mesh (``mesh=``, ``rules=``) the Trainer holds this rank's blocks,
the frozen KL reference is sharded as the policy, and the update batch
is padded to a multiple of dp x fsdp with zero-mask rows, as the
reference's.  Rollouts gather the policy's blocks into one whole tree
a rank before each step's rollouts (the tree's tensors refreshed in
place, so the Generator and its graphs keep their addresses), and
every rank runs the one-card Generator on it with the same seeds: the
tokens are the one-card run's for the same parameters.  A rank pays
the whole model once more for it (``rollout_bytes``; about 16 GB at
LLAMA3_8B in bf16), for the trainer's lifetime: the Generator's CUDA
graphs read the tree's addresses, so the tree is refreshed in place
each step rather than freed between rollouts and gathered anew.

Algorithm: GRPO (group-relative policy optimization): sample G
completions per prompt, advantage = per-group standardized reward,
token-level policy gradient with an optional k3 KL penalty to a frozen
reference policy.  No value network: the group baseline replaces it.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import sft
from skypilot_tpu_torch.train.trainer import tree_leaves, tree_map


def group_advantages(rewards: np.ndarray, group_size: int,
                     eps: float = 1e-6) -> np.ndarray:
    """(B,) rewards, B = num_groups * group_size (completions of the same
    prompt contiguous) -> (B,) standardized within each group."""
    if rewards.size % group_size:
        raise ValueError(f'{rewards.size} rewards not divisible by '
                         f'group size {group_size}')
    groups = rewards.reshape(-1, group_size).astype(np.float32)
    mean = groups.mean(axis=1, keepdims=True)
    std = groups.std(axis=1, keepdims=True)
    return ((groups - mean) / (std + eps)).reshape(-1)


def grpo_loss(params: llama.Params, batch: Dict[str, torch.Tensor],
              config: llama.LlamaConfig, kl_coef: float = 0.0,
              ref_params: Optional[llama.Params] = None, mesh=None,
              rules: sharding.PartitionRules = sharding.LLAMA_RULES
              ) -> torch.Tensor:
    """batch:
      tokens          (B, T)   prompt+completion, right-padded
      completion_mask (B, T-1) 1.0 where position t predicts a
                               completion token (prompt + padding = 0)
      advantage       (B,)     group-standardized reward

    Token-level policy gradient: -E[adv * log p(token)] over completion
    tokens, plus kl_coef * k3-KL to ref_params when given (exp(d) - d -
    1, d = ref_lp - lp), the reference's pass without a graph.  Under a
    mesh the batch is this rank's rows and the sums the global batch's.
    """
    tokens = batch['tokens']
    mask = sft.rank_targets(batch['completion_mask'].float(), mesh)
    adv = batch['advantage'].float()[:, None]
    logprobs = sft.token_logprobs(params, tokens, config, mesh, rules)
    denom = sft.global_count(mask, mesh)
    pg = -sft.global_sum((adv * logprobs * mask).sum(), mesh) / denom
    if kl_coef and ref_params is not None:
        with torch.no_grad():
            ref_lp = sft.token_logprobs(ref_params, tokens, config, mesh,
                                        rules)
        d = ref_lp - logprobs
        kl = sft.global_sum(((torch.exp(d) - d - 1.0) * mask).sum(),
                            mesh) / denom
        return pg + kl_coef * kl
    return pg


def pad_rows(batch: Dict[str, np.ndarray], shards: int
             ) -> Dict[str, np.ndarray]:
    """The batch padded to a multiple of `shards` rows (dp x fsdp) with
    zero-mask rows: their completion_mask is all zero, so they add
    nothing to the masked loss."""
    extra = -batch['tokens'].shape[0] % shards
    if not extra:
        return batch
    return {k: np.concatenate([v, np.zeros((extra,) + v.shape[1:],
                                           v.dtype)])
            for k, v in batch.items()}


def build_batch(prompts, completions, advantages,
                pad_to: int) -> Dict[str, np.ndarray]:
    """Host-side batch assembly: rows = prompt_i + completion_i padded to
    `pad_to` (one static shape per bucket)."""
    batch = len(completions)
    tokens = np.zeros((batch, pad_to), np.int32)
    mask = np.zeros((batch, pad_to - 1), np.float32)
    for i, (prompt, completion) in enumerate(zip(prompts, completions)):
        seq = list(prompt) + list(completion)
        seq = seq[:pad_to]
        tokens[i, :len(seq)] = seq
        # Position t of the mask gates the prediction of tokens[t+1]:
        # completion tokens sit at indices [len(prompt), len(seq)).
        start = max(len(prompt) - 1, 0)
        mask[i, start:len(seq) - 1] = 1.0
    return {'tokens': tokens, 'completion_mask': mask,
            'advantage': np.asarray(advantages, np.float32)}


class GrpoTrainer:
    """Rollout -> reward -> group advantage -> update, one object.

    reward_fn(prompt_ids, completion_ids) -> float, on the host: the
    task-specific part (exact match, test pass, length ...).  The
    reference's ``GrpoTrainer(params, config, mesh, rules, reward_fn,
    ...)`` takes the mesh and rules as keywords here (default None: one
    device, the CUDA card unless `device` says otherwise); with them,
    params is the global tree and the Trainer holds this rank's blocks.
    """

    def __init__(self, params: llama.Params, config: llama.LlamaConfig,
                 reward_fn, *, group_size: int = 4,
                 max_new_tokens: int = 32,
                 max_prompt_len: int = 64,
                 temperature: float = 1.0,
                 learning_rate: float = 1e-5,
                 kl_coef: float = 0.0,
                 total_steps: int = 100,
                 seed: int = 0,
                 device=None, mesh=None,
                 rules: Optional[sharding.PartitionRules] = None):
        import functools

        from skypilot_tpu_torch.infer.engine import (Generator,
                                                     GeneratorConfig)
        from skypilot_tpu_torch.ckpt.format import tree_unflatten
        from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer
        device = resolve_device(device)
        self.config = config
        self.group_size = group_size
        self.max_new_tokens = max_new_tokens
        self.reward_fn = reward_fn
        self.kl_coef = kl_coef
        self.seed = seed
        self.mesh = mesh
        rules = rules or sharding.LLAMA_RULES
        # The frozen reference must be a COPY: the Trainer updates its
        # parameter tensors in place, and they may share storage with
        # `params`.  On a mesh it is sharded as the policy.
        if kl_coef:
            ref = (params if mesh is None
                   else sharding.shard_params(params, mesh, rules))
            self._ref_params = tree_map(
                lambda p: torch.as_tensor(p).detach().to(device).clone(),
                ref)
        else:
            self._ref_params = None
        loss = functools.partial(grpo_loss, config=config,
                                 kl_coef=kl_coef,
                                 ref_params=self._ref_params, mesh=mesh,
                                 rules=rules)
        self.trainer = Trainer(loss, params,
                               TrainConfig(learning_rate=learning_rate,
                                           warmup_steps=1,
                                           total_steps=total_steps),
                               device=device, mesh=mesh,
                               rules=None if mesh is None else rules)
        # Rollouts: the live tensors on one device; on a mesh a whole
        # tree gathered from them before each step's rollouts.
        self._rollout_params = self.trainer.params
        self.rollout_bytes = 0
        if mesh is not None:
            self._rollout_params = tree_unflatten(
                self.trainer.params,
                [x.clone() for x in self._whole_policy()])
            self.rollout_bytes = sum(
                x.numel() * x.element_size() for x in
                tree_leaves(self._rollout_params))
        # The KV arena is sized to the ROLLOUT length, not the model's
        # max_seq_len: RL sequences are prompt + completion.
        rollout_len = max_prompt_len + max_new_tokens + 1
        gen_len = min(config.max_seq_len,
                      1 << (rollout_len - 1).bit_length())
        self.max_prompt_len = max_prompt_len
        self._gen_config = GeneratorConfig(
            max_seq_len=gen_len, batch_size=group_size,
            temperature=temperature)
        # The Trainer's own tensors (or their gathered copy): rollouts
        # read the live policy.
        self._generator = Generator(self._rollout_params, config,
                                    self._gen_config, device=device)

    @torch.no_grad()
    def _whole_policy(self):
        """The Trainer's blocks put together, leaf by leaf (a leaf no
        axis splits is the Trainer's own tensor)."""
        return [sharding.gather_tensor(x.detach(), sh.spec, self.mesh)
                for x, sh in zip(self.trainer._leaves,
                                 self.trainer._shardings)]

    def step(self, prompts) -> Dict[str, float]:
        """One GRPO iteration over `prompts` (G completions each).
        Returns the JAX package's loss, reward mean and std and step, and
        the host seconds of the rollouts and of the update (which ends in
        the loss's fetch)."""
        too_long = [p for p in prompts if len(p) > self.max_prompt_len]
        if too_long:
            raise ValueError(
                f'{len(too_long)} prompt(s) exceed max_prompt_len='
                f'{self.max_prompt_len}; raise it at construction.')
        t0 = time.perf_counter()
        if self.mesh is not None:
            with torch.no_grad():
                for dst, src in zip(tree_leaves(self._rollout_params),
                                    self._whole_policy()):
                    dst.copy_(src)
        all_prompts, completions, rewards = [], [], []
        with torch.no_grad():
            for i, prompt in enumerate(prompts):
                outs = self._generator.generate(
                    [list(prompt)] * self.group_size,
                    max_new_tokens=self.max_new_tokens,
                    seed=self.seed * 100_003 + self.trainer.step * 1_009 + i)
                for completion in outs:
                    all_prompts.append(list(prompt))
                    completions.append(completion)
                    rewards.append(float(self.reward_fn(prompt, completion)))
        t1 = time.perf_counter()
        advantages = group_advantages(np.asarray(rewards), self.group_size)
        pad_to = max(len(p) + len(c)
                     for p, c in zip(all_prompts, completions))
        # Bucket to a multiple of 16: one update shape per bucket.
        pad_to = ((pad_to + 15) // 16) * 16
        batch = build_batch(all_prompts, completions, advantages, pad_to)
        if self.mesh is not None:
            batch = pad_rows(batch, self.mesh.axis_size(('dp', 'fsdp')))
        metrics = self.trainer.run_step(batch)
        loss = float(metrics['loss'])
        return {'loss': loss,
                'reward_mean': float(np.mean(rewards)),
                'reward_std': float(np.std(rewards)),
                'step': self.trainer.step,
                'rollout_s': t1 - t0,
                'update_s': time.perf_counter() - t1}

    def close(self) -> None:
        """Release checkpoint writers held by the wrapped Trainer."""
        self.trainer.close()
