"""Llama training entry point, on one card or a mesh of ranks,
resumable after preemption.

Counterpart of examples/scripts/train_llama.py.  Run as::

    python -m skypilot_tpu_torch.train.train_llama --model-size 1b \\
        --seq-len 1024 --batch-size 8 --steps 16 --checkpoint-every 4 \\
        --checkpoint-dir /ckpt [--resume auto] [--fsdp 2 --tp 2]

``--dp``, ``--fsdp``, ``--sp`` and ``--tp`` lay the ranks out on a
training mesh (``--dp 0``: the cards left over); without them
``auto_mesh_config`` picks one for this host's cards, as the reference
does for its devices (one card: no mesh).  The ranks are processes of
this host (train/mesh_run.py), one a rank, each holding its blocks of
the model and its optimizer state under ``LLAMA_RULES``; ``--sp`` above
1 runs attention over the sp ring.  The global batch (``--batch-size``,
default one sequence a data shard) is split over dp x fsdp; rank 0
prints.

It trains in chunks of ``--checkpoint-every`` steps through
``Trainer.fit`` and commits a checkpoint after each chunk (printing
``saved step N``).  A managed job relaunched after preemption passes
``--resume auto``: the run restores the newest COMMITTED step under
``--checkpoint-dir`` (``Trainer.restore_latest``, which walks down past a
torn or corrupt newest step), prints ``resumed from step N`` and trains
on to ``--steps``.  Batches restart from seed 0 after a resume, as in the
reference script.  The weights are random from seed 0, or those of
``--hf-model DIR``, a local HF checkpoint directory of a dense family
(models/convert.py), which then also gives the config.  The run is on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import mesh_run
from skypilot_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                              synthetic_batches)

PRESETS = {'debug': llama.LLAMA_DEBUG, '1b': llama.LLAMA_1B,
           '8b': llama.LLAMA3_8B, '70b': llama.LLAMA3_70B}


def text_batches(path: str, batch: int, seq: int, vocab: int):
    """Next-token batches from a plain-text corpus: its bytes mod the
    vocabulary (the reference's byte-level fallback), random contiguous
    windows forever from seed 0."""
    with open(path, encoding='utf-8') as f:
        text = f.read()
    if not text.strip():
        raise SystemExit(f'--data-file {path} is empty: nothing to '
                         f'finetune on.')
    ids = np.frombuffer(text.encode('utf-8'),
                        np.uint8).astype(np.int32) % vocab
    if len(ids) < seq + 2:
        reps = (seq + 2) // max(len(ids), 1) + 1
        ids = np.tile(ids, reps)
    rng = np.random.default_rng(0)
    while True:
        starts = rng.integers(0, len(ids) - seq - 1, size=batch)
        yield {'tokens': np.stack([ids[s:s + seq + 1] for s in starts])}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model-size', default='1b', choices=list(PRESETS))
    parser.add_argument('--seq-len', type=int, default=4096)
    parser.add_argument('--batch-size', type=int, default=0,
                        help='global batch; 0 = 1 sequence per dp shard')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--dp', type=int, default=0, help='0 = auto')
    parser.add_argument('--fsdp', type=int, default=0)
    parser.add_argument('--sp', type=int, default=1)
    parser.add_argument('--tp', type=int, default=1)
    parser.add_argument('--learning-rate', type=float, default=2e-5)
    parser.add_argument('--checkpoint-dir', default='')
    parser.add_argument('--checkpoint-every', type=int, default=50)
    parser.add_argument('--resume', default='no', choices=['no', 'auto'])
    parser.add_argument('--hf-model', default='',
                        help='local HF checkpoint directory to start from '
                             '(its config replaces --model-size)')
    parser.add_argument('--data-file', default='',
                        help='plain-text finetune corpus, as bytes mod '
                             'vocab. Default: synthetic batches.')
    parser.add_argument('--throttle-s', type=float, default=0.0,
                        help='sleep between checkpoint chunks (demo '
                             'pacing, e.g. to observe recovery)')
    parser.add_argument('--device', default=None,
                        help='default: the CUDA card')
    return parser.parse_args(argv)


def mesh_config(args, config) -> mesh_lib.MeshConfig:
    """The reference's choice: the axes given (dp filling the cards left
    over), else auto_mesh_config for this host's cards."""
    n = mesh_run.cards(args.device)
    if args.fsdp or args.dp or args.tp > 1 or args.sp > 1:
        fsdp = max(args.fsdp, 1)
        dp = args.dp or max(1, n // (fsdp * args.sp * args.tp))
        return mesh_lib.MeshConfig(dp=dp, fsdp=fsdp, sp=args.sp,
                                   tp=args.tp)
    return mesh_lib.auto_mesh_config(
        n, model_params_b=config.num_params() / 1e9, seq_len=args.seq_len)


def main(argv=None) -> None:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    mesh_run.run_on_mesh(args, train, mesh_config(args, _config(args)))


def _config(args):
    if args.hf_model:
        from skypilot_tpu_torch.models import convert
        return convert.read_hf_config(args.hf_model)
    return PRESETS[args.model_size]


def _params(args, config, device, mesh):
    """The weights: random from seed 0, or the --hf-model checkpoint's;
    on a mesh a rank draws, or reads out of the files' memory map, only
    its blocks."""
    if args.hf_model:
        from skypilot_tpu_torch.train import train_sft
        if mesh is not None:
            return train_sft.load_base_sharded(args.hf_model, mesh, device)
        return train_sft.load_base(args.hf_model, device)
    shard = (None if mesh is None
             else sharding.init_shard(mesh, sharding.LLAMA_RULES))
    return llama.init_params(
        config, torch.Generator(device=device).manual_seed(0), device,
        shard=shard), config


def train(args, device: torch.device, mesh=None) -> None:
    """The training loop of one process: the whole run on one device, or
    one rank of `mesh`."""
    trainer_config = TrainConfig(
        learning_rate=args.learning_rate,
        warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps)
    params, config = _params(args, _config(args), device, mesh)
    if mesh is None:
        trainer = Trainer(lambda p, b: llama.loss_fn(p, b, config), params,
                          trainer_config, device=device)
    else:
        trainer = Trainer(
            lambda p, b: llama.loss_fn(p, b, config, mesh=mesh), params,
            trainer_config, device=device, mesh=mesh,
            rules=sharding.LLAMA_RULES, params_sharded=True)
    del params
    say = mesh_run.lead_print(mesh)
    where = ('' if mesh is None
             else f' {mesh_run.describe(mesh)} ranks={mesh.size}')
    say(f'device={trainer.device}{where} '
        f'model={args.hf_model or args.model_size} '
        f'({config.num_params() / 1e9:.2f}B params) seq={args.seq_len}')
    if trainer.shared_card:
        say(f'note: {mesh.size} gloo ranks share one card: the rates '
            f'below are no multi-card rate')
    if args.resume == 'auto' and args.checkpoint_dir:
        if trainer.restore_latest(args.checkpoint_dir) is not None:
            say(f'resumed from step {trainer.step}')
    shards = 1 if mesh is None else mesh.axis_size(('dp', 'fsdp'))
    batch_size = args.batch_size or shards
    if batch_size % shards:
        raise SystemExit(f'--batch-size {batch_size} does not divide over '
                         f'dp x fsdp = {shards}')
    if args.data_file:
        batches = text_batches(args.data_file, batch_size, args.seq_len,
                               config.vocab_size)
    else:
        batches = synthetic_batches(batch_size, args.seq_len,
                                    config.vocab_size)
    tokens_per_batch = batch_size * args.seq_len
    summary = None
    try:
        while trainer.step < args.steps:
            chunk = min(args.checkpoint_every or args.steps,
                        args.steps - trainer.step)
            summary = trainer.fit(batches, chunk, log_every=10,
                                  tokens_per_batch=tokens_per_batch)
            if args.checkpoint_dir:
                trainer.save_checkpoint(args.checkpoint_dir)
                say(f'saved step {trainer.step}')
            if args.throttle_s:
                time.sleep(args.throttle_s)
    finally:
        trainer.close()
    if summary is None:
        say(f'final: step {trainer.step} of {args.steps}, nothing left '
            f'to train')
        return
    rate = summary.get('tokens_per_sec', 0)
    say(f"final: loss={summary['loss']:.4f} "
        f"tokens/sec={rate:.0f} ({rate / trainer.world:.0f}/card)")



if __name__ == '__main__':
    main()
