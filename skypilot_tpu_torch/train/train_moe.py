"""Mixture-of-Experts training entry point with expert parallelism:
full-parameter training of the Mixtral-style decoder (models/moe.py) on
synthetic batches, on one card or a mesh of ranks.

Counterpart of examples/scripts/train_moe.py, with its flags and its
printed line.  Run as::

    python -m skypilot_tpu_torch.train.train_moe --model-size small \\
        --seq-len 2048 --batch-size 8 --steps 10 [--ep 4 --dp 2] \\
        [--device cpu]

'small' is the reference script's model (d 1024, 8 layers, 8/4 heads,
ff 2816, 8 experts, vocab 32768, bf16, remat), 'debug' is MOE_DEBUG; the
weights are random from seed 0.  ``--ep`` shards each expert bank over
the mesh's 'ep' axis (a rank holds E / ep experts) and ``--dp`` splits
the batch (0: this host's cards left over by ep), under ``MOE_RULES``;
the ranks are processes of this host (train/mesh_run.py) and rank 0
prints.  The run is on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import mesh_run
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
                 seed: int = 0, mesh=None) -> Trainer:
    """A Trainer of moe.loss_fn over random weights from `seed` (on a
    mesh drawn straight into this rank's blocks under MOE_RULES), with
    the reference script's schedule (2 warmup steps of `steps`)."""
    device = resolve_device(device)
    shard = None if mesh is None else sharding.init_shard(
        mesh, sharding.MOE_RULES)
    params = moe.init_params(
        config, torch.Generator(device=device).manual_seed(seed), device,
        shard=shard)
    tc = TrainConfig(warmup_steps=2, total_steps=steps)
    if mesh is None:
        return Trainer(lambda p, b: moe.loss_fn(p, b, config), params, tc,
                       device=device)
    return Trainer(lambda p, b: moe.loss_fn(p, b, config, mesh=mesh),
                   params, tc, device=device, mesh=mesh,
                   rules=sharding.MOE_RULES, params_sharded=True)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ep', type=int, default=1)
    parser.add_argument('--dp', type=int, default=0,
                        help='0 = fill the remaining cards')
    parser.add_argument('--seq-len', type=int, default=2048)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--model-size', default='small',
                        choices=list(PRESETS))
    parser.add_argument('--device', default=None,
                        help='default: the CUDA card')
    args = parser.parse_args(argv)
    args.dp = args.dp or max(1, mesh_run.cards(args.device) // args.ep)
    if PRESETS[args.model_size].n_experts % args.ep:
        parser.error(f'--ep {args.ep} does not divide the '
                     f'{PRESETS[args.model_size].n_experts} experts')
    if args.batch_size % args.dp:
        parser.error(f'--batch-size {args.batch_size} does not divide '
                     f'over dp={args.dp}')
    return args


def run(args, device, mesh=None) -> dict:
    """The run on one device or rank; returns fit's summary."""
    config = PRESETS[args.model_size]
    trainer = make_trainer(config, args.steps, device, mesh=mesh)
    batches = synthetic_batches(args.batch_size, args.seq_len,
                                config.vocab_size)
    try:
        return trainer.fit(
            batches, args.steps, log_every=1,
            tokens_per_batch=args.batch_size * args.seq_len)
    finally:
        trainer.close()


def _report(args, summary) -> None:
    config = PRESETS[args.model_size]
    print(f"moe OK: ep={args.ep} dp={args.dp} experts={config.n_experts} "
          f"loss={summary['loss']:.4f} "
          f"tokens/s={summary.get('tokens_per_sec', 0):.0f}")


def _rank(local_rank: int, procs_per_host: int, argd: dict) -> None:
    args = argparse.Namespace(**argd)
    sys.stdout.reconfigure(line_buffering=True)
    device, info = mesh_run.join(args.device, local_rank, procs_per_host)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(dp=args.dp,
                                                      ep=args.ep))
        summary = run(args, device, mesh)
        if info['rank'] == 0:
            _report(args, summary)
    finally:
        mesh_run.leave()


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    if args.ep * args.dp == 1:
        _report(args, run(args, resolve_device(args.device)))
    else:
        mesh_run.launch(args.ep * args.dp, _rank, vars(args))
    return 0


if __name__ == '__main__':
    sys.exit(main())
