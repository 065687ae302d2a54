"""GRPO-style RL post-training for the bundled Llama, on one card.

Counterpart of skypilot_tpu/train/rl.py.  Rollouts come from the
inference engine (``infer.engine.Generator``) on the same card as the
learner (the port's ``Trainer``): actor and learner are colocated, and
the Generator reads the Trainer's live parameter tensors, which the
optimizer updates in place, so every rollout (and every replayed CUDA
graph) samples the newest policy.

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
from skypilot_tpu_torch.train import sft


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
              ref_params: Optional[llama.Params] = None) -> torch.Tensor:
    """batch:
      tokens          (B, T)   prompt+completion, right-padded
      completion_mask (B, T-1) 1.0 where position t predicts a
                               completion token (prompt + padding = 0)
      advantage       (B,)     group-standardized reward

    Token-level policy gradient: -E[adv * log p(token)] over completion
    tokens, plus kl_coef * k3-KL to ref_params when given (exp(d) - d -
    1, d = ref_lp - lp), the reference's pass without a graph."""
    tokens = batch['tokens']
    mask = batch['completion_mask'].float()
    adv = batch['advantage'].float()[:, None]
    logprobs = sft.token_logprobs(params, tokens, config)
    denom = torch.clamp(mask.sum(), min=1.0)
    pg = -(adv * logprobs * mask).sum() / denom
    if kl_coef and ref_params is not None:
        with torch.no_grad():
            ref_lp = sft.token_logprobs(ref_params, tokens, config)
        d = ref_lp - logprobs
        kl = ((torch.exp(d) - d - 1.0) * mask).sum() / denom
        return pg + kl_coef * kl
    return pg


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
    task-specific part (exact match, test pass, length ...).  As the JAX
    package's, without its mesh and rules: one device (the CUDA card
    unless `device` says otherwise), so no batch padding to a shard
    multiple."""

    def __init__(self, params: llama.Params, config: llama.LlamaConfig,
                 reward_fn, *, group_size: int = 4,
                 max_new_tokens: int = 32,
                 max_prompt_len: int = 64,
                 temperature: float = 1.0,
                 learning_rate: float = 1e-5,
                 kl_coef: float = 0.0,
                 total_steps: int = 100,
                 seed: int = 0,
                 device=None):
        import functools

        from skypilot_tpu_torch.infer.engine import (Generator,
                                                     GeneratorConfig)
        from skypilot_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                      tree_map)
        device = resolve_device(device)
        self.config = config
        self.group_size = group_size
        self.max_new_tokens = max_new_tokens
        self.reward_fn = reward_fn
        self.kl_coef = kl_coef
        self.seed = seed
        # The frozen reference must be a COPY: the Trainer updates its
        # parameter tensors in place, and they may share storage with
        # `params`.
        if kl_coef:
            self._ref_params = tree_map(
                lambda p: p.detach().to(device).clone(), params)
        else:
            self._ref_params = None
        loss = functools.partial(grpo_loss, config=config,
                                 kl_coef=kl_coef,
                                 ref_params=self._ref_params)
        self.trainer = Trainer(loss, params,
                               TrainConfig(learning_rate=learning_rate,
                                           warmup_steps=1,
                                           total_steps=total_steps),
                               device=device)
        # The KV arena is sized to the ROLLOUT length, not the model's
        # max_seq_len: RL sequences are prompt + completion.
        rollout_len = max_prompt_len + max_new_tokens + 1
        gen_len = min(config.max_seq_len,
                      1 << (rollout_len - 1).bit_length())
        self.max_prompt_len = max_prompt_len
        self._gen_config = GeneratorConfig(
            max_seq_len=gen_len, batch_size=group_size,
            temperature=temperature)
        # The Trainer's own tensors: rollouts read the live policy.
        self._generator = Generator(self.trainer.params, config,
                                    self._gen_config, device=device)

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
