"""Long-context training with ring attention (sequence parallelism).

Counterpart of examples/scripts/train_long_context.py: the sequence is
split over the mesh's 'sp' axis, and each layer's attention runs over
the sp ring (parallel/ring_attention.py: the k/v blocks travel from rank
to rank while each rank merges its partial attention), so no rank holds
the (S, S) scores or the whole sequence's activations.  Run as::

    python -m skypilot_tpu_torch.train.train_long_context --sp 4 \\
        --seq-len 8192 --model-size 1b [--fsdp 2] [--device cpu]

``--sp 0`` takes this host's cards over ``--fsdp``.  The ranks are
processes of this host (train/mesh_run.py), on the cards unless
``--device cpu``; rank 0 prints the reference's ``long-context OK:``
line.  The weights are random from seed 0.
"""
from __future__ import annotations

import argparse
import sys

import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import mesh_run
from skypilot_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                              synthetic_batches)

PRESETS = {'debug': llama.LLAMA_DEBUG, '1b': llama.LLAMA_1B,
           '8b': llama.LLAMA3_8B}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--sp', type=int, default=0,
                        help='sequence-parallel degree (0 = all cards)')
    parser.add_argument('--fsdp', type=int, default=1)
    parser.add_argument('--seq-len', type=int, default=32768)
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--model-size', default='1b', choices=list(PRESETS))
    parser.add_argument('--device', default=None,
                        help='default: the CUDA cards')
    args = parser.parse_args(argv)
    args.sp = args.sp or max(1, mesh_run.cards(args.device) // args.fsdp)
    if args.seq_len % args.sp:
        parser.error('seq must divide the sp axis')
    if args.batch_size % args.fsdp:
        parser.error(f'--batch-size {args.batch_size} does not divide '
                     f'over fsdp={args.fsdp}')
    return args


def make_trainer(config, args, device, mesh) -> Trainer:
    """The reference script's Trainer on this rank's blocks (random from
    seed 0) with its schedule (2 warmup steps of --steps)."""
    params = llama.init_params(
        config, torch.Generator(device=device).manual_seed(0), device,
        shard=sharding.init_shard(mesh, sharding.LLAMA_RULES))
    return Trainer(lambda p, b: llama.loss_fn(p, b, config, mesh=mesh),
                   params, TrainConfig(warmup_steps=2,
                                       total_steps=args.steps),
                   device=device, mesh=mesh, rules=sharding.LLAMA_RULES,
                   params_sharded=True)


def run(args, device, mesh) -> dict:
    """The run on one rank; returns fit's summary."""
    config = PRESETS[args.model_size]
    trainer = make_trainer(config, args, device, mesh)
    try:
        return trainer.fit(synthetic_batches(args.batch_size, args.seq_len,
                                             config.vocab_size),
                           args.steps, log_every=1,
                           tokens_per_batch=args.batch_size * args.seq_len)
    finally:
        trainer.close()


def _rank(local_rank: int, procs_per_host: int, argd: dict) -> None:
    args = argparse.Namespace(**argd)
    sys.stdout.reconfigure(line_buffering=True)
    device, info = mesh_run.join(args.device, local_rank, procs_per_host)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(fsdp=args.fsdp,
                                                      sp=args.sp))
        summary = run(args, device, mesh)
        if info['rank'] == 0:
            print(f"long-context OK: seq={args.seq_len} sp={args.sp} "
                  f"loss={summary['loss']:.4f} "
                  f"tokens/s={summary.get('tokens_per_sec', 0):.0f}")
    finally:
        mesh_run.leave()


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    mesh_run.launch(args.sp * args.fsdp, _rank, vars(args))
    return 0


if __name__ == '__main__':
    sys.exit(main())
