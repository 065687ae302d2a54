"""Mixture-of-Experts training entry point on one card: full-parameter
training of the Mixtral-style decoder (models/moe.py) on synthetic
batches.

Counterpart of examples/scripts/train_moe.py, with its flags and its
printed line.  Run as::

    python -m skypilot_tpu_torch.train.train_moe --model-size small \\
        --seq-len 2048 --batch-size 8 --steps 10 [--device cpu]

'small' is the reference script's model (d 1024, 8 layers, 8/4 heads,
ff 2816, 8 experts, vocab 32768, bf16, remat), 'debug' is MOE_DEBUG; the
weights are random from seed 0.  The reference shards the experts over
a mesh's 'ep' axis; here one card holds them all, so --ep and --dp stay
1 and a value above 1 exits naming ROADMAP item 11(g) (meshes).  The run
is on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.train.train_sft import refuse_unported
from skypilot_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                              synthetic_batches)

PRESETS = {
    'debug': moe.MOE_DEBUG,
    'small': dataclasses.replace(
        moe.MOE_DEBUG, vocab_size=32768, d_model=1024, n_layers=8,
        n_heads=8, n_kv_heads=4, d_ff=2816, max_seq_len=4096, n_experts=8,
        dtype=torch.bfloat16, remat=True),
}


def make_trainer(config: moe.MoeConfig, steps: int, device=None,
                 seed: int = 0) -> Trainer:
    """A Trainer of moe.loss_fn over random weights from `seed`, with the
    reference script's schedule (2 warmup steps of `steps`)."""
    device = resolve_device(device)
    params = moe.init_params(
        config, torch.Generator(device=device).manual_seed(seed), device)
    return Trainer(lambda p, b: moe.loss_fn(p, b, config), params,
                   TrainConfig(warmup_steps=2, total_steps=steps),
                   device=device)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ep', type=int, default=1, help='1 (one card)')
    parser.add_argument('--dp', type=int, default=1, help='1 (one card)')
    parser.add_argument('--seq-len', type=int, default=2048)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--model-size', default='small',
                        choices=list(PRESETS))
    parser.add_argument('--device', default=None,
                        help='default: the CUDA card')
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    config = PRESETS[args.model_size]
    trainer = make_trainer(config, args.steps, args.device)
    batches = synthetic_batches(args.batch_size, args.seq_len,
                                config.vocab_size)
    try:
        summary = trainer.fit(
            batches, args.steps, log_every=1,
            tokens_per_batch=args.batch_size * args.seq_len)
    finally:
        trainer.close()
    print(f"moe OK: ep={args.ep} dp={args.dp} experts={config.n_experts} "
          f"loss={summary['loss']:.4f} "
          f"tokens/s={summary.get('tokens_per_sec', 0):.0f}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
