"""GRPO RL entry point on one card or a mesh of ranks (train/rl.py):
rollouts from the port's Generator and updates from its Trainer,
colocated on the card.

Counterpart of examples/scripts/train_rl.py, with its flags and printed
lines.  Run as::

    python -m skypilot_tpu_torch.train.train_rl --model-size debug \\
        --steps 3 [--device cpu]

Demo rewards are verifiable by construction (no reward model):
  token-band    the share of completion tokens with id <= --target-token
                (default vocab/8, so the starting policy already scores
                ~12% and GRPO has a gradient)
  length        1 - |len(completion) - target| / target
The contract is reward(prompt_ids, completion_ids) -> float.  The model
is ``--hf-model DIR`` (a local HF checkpoint directory,
models/convert.py), else the ``--model-size`` preset with random weights
from seed 0; the run is on the card unless ``--device cpu``.  ``--fsdp``
and ``--tp`` lay the ranks out on a training mesh as the reference does
(dp filling the cards left over; train/mesh_run.py, one process a
rank); every rank rolls out on the whole policy gathered from its
blocks, and rank 0 prints.
"""
from __future__ import annotations

import argparse
import sys

import torch

from skypilot_tpu_torch.train.mesh_run import lead_print
from skypilot_tpu_torch.train.train_sft import launch


def make_rewards(vocab_size: int, target_token: int = 0,
                 target_length: int = 8):
    """The entry point's reward functions by name."""
    target = target_token or max(vocab_size // 8, 1)
    return {
        'token-band': lambda p, c: (
            sum(1 for t in c if t <= target) / max(len(c), 1)),
        'length': lambda p, c: (
            1.0 - abs(len(c) - target_length) / max(target_length, 1)),
    }


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model-size', default='debug',
                        choices=['debug', '1b', '8b'])
    parser.add_argument('--hf-model', default='',
                        help='local HF checkpoint directory (default: '
                             'the --model-size preset, random weights)')
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--group-size', type=int, default=8)
    parser.add_argument('--prompts-per-step', type=int, default=2)
    parser.add_argument('--max-new-tokens', type=int, default=16)
    parser.add_argument('--learning-rate', type=float, default=1e-4)
    parser.add_argument('--temperature', type=float, default=1.0)
    parser.add_argument('--kl-coef', type=float, default=0.0)
    parser.add_argument('--reward', default='token-band',
                        choices=['token-band', 'length'])
    parser.add_argument('--target-token', type=int, default=0,
                        help='0 = vocab_size // 8')
    parser.add_argument('--target-length', type=int, default=8)
    parser.add_argument('--fsdp', type=int, default=0)
    parser.add_argument('--tp', type=int, default=1)
    parser.add_argument('--device', default=None,
                        help='default: the CUDA card')
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    launch(args, run)


def run(args, device, mesh=None) -> None:
    """The GRPO run of one process: on one device, or one rank of
    `mesh` (the policy's blocks under LLAMA_RULES)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import rl
    from skypilot_tpu_torch.train.train_sft import load_base

    if args.hf_model:
        params, config = load_base(args.hf_model, 'cpu' if mesh else device)
    else:
        config = {'debug': llama.LLAMA_DEBUG, '1b': llama.LLAMA_1B,
                  '8b': llama.LLAMA3_8B}[args.model_size]
        params = llama.init_params(
            config, torch.Generator(device=device).manual_seed(0),
            'cpu' if mesh else device)
    rewards = make_rewards(config.vocab_size, args.target_token,
                           args.target_length)
    trainer = rl.GrpoTrainer(
        params, config, rewards[args.reward], group_size=args.group_size,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        learning_rate=args.learning_rate, kl_coef=args.kl_coef,
        total_steps=args.steps, device=device, mesh=mesh,
        rules=None if mesh is None else sharding.LLAMA_RULES)
    del params
    say = lead_print(mesh)

    prompts = [[(11 * (i + 1)) % config.vocab_size,
                (13 * (i + 1)) % config.vocab_size]
               for i in range(args.prompts_per_step)]
    metrics = {}
    try:
        for _ in range(args.steps):
            metrics = trainer.step(prompts)
            say(f"rl step {metrics['step']}: "
                f"reward={metrics['reward_mean']:.3f}"
                f"±{metrics['reward_std']:.3f} "
                f"loss={metrics['loss']:.4f}")
    finally:
        trainer.close()
    say(f"rl OK: {args.steps} steps, final "
        f"reward={metrics.get('reward_mean', float('nan')):.3f}")


if __name__ == '__main__':
    main()
