"""DPO entry point on one card or a mesh of ranks: preference tuning on
a {prompt, chosen, rejected} JSONL dataset (train/dpo.py).

Counterpart of examples/scripts/train_dpo.py, with its flags and printed
lines.  Run as::

    python -m skypilot_tpu_torch.train.train_dpo --data-file pairs.jsonl \\
        --seq-len 256 --steps 20 [--lora-rank 8] [--fsdp 2 --tp 2] \\
        [--device cpu]

With --lora-rank (recommended at 8B) the reference policy is the frozen
base itself, with no second copy of the model; full-parameter mode keeps
a frozen copy of the initial weights (on a mesh, sharded as the
policy).  The model (``--hf-model``), the byte encoding, the mesh flags
(``--dp``, ``--fsdp``, ``--tp``), ``--merge-save`` and ``--device`` are
as in train_sft; ``--resume auto`` restores the newest committed step
(``Trainer.restore_latest``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from skypilot_tpu_torch.train.mesh_run import lead_print
from skypilot_tpu_torch.train.train_sft import (byte_encoder, launch,
                                                load_model, merge_and_save,
                                                mesh_str)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--hf-model', default='',
                        help='local HF checkpoint directory (default: '
                             'LLAMA_DEBUG, random weights)')
    parser.add_argument('--data-file', required=True,
                        help='JSONL of {"prompt", "chosen", "rejected"}')
    parser.add_argument('--seq-len', type=int, default=1024)
    parser.add_argument('--batch-size', type=int, default=0,
                        help='pairs per step; 0 = 2')
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--beta', type=float, default=0.1,
                        help='DPO temperature (implicit reward scale)')
    parser.add_argument('--dp', type=int, default=0,
                        help='0 = the cards left over')
    parser.add_argument('--fsdp', type=int, default=0)
    parser.add_argument('--tp', type=int, default=1)
    parser.add_argument('--learning-rate', type=float, default=5e-7)
    parser.add_argument('--loss-chunk', type=int, default=0)
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='>0: LoRA-DPO: adapters train, the base IS '
                             'the reference policy (no second model '
                             'copy)')
    parser.add_argument('--lora-alpha', type=float, default=32.0)
    parser.add_argument('--lora-targets', default='attn')
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--checkpoint-dir', default='')
    parser.add_argument('--checkpoint-every', type=int, default=50)
    parser.add_argument('--resume', default='no', choices=['no', 'auto'])
    parser.add_argument('--merge-save', default='')
    parser.add_argument('--device', default=None,
                        help='default: the CUDA card')
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    launch(args, run)


def run(args, device, mesh=None) -> None:
    """The preference tuning of one process: the whole run on one
    device, or one rank of `mesh`."""
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import dpo
    from skypilot_tpu_torch.train import lora as lora_lib
    from skypilot_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  tree_map)

    say = lead_print(mesh)
    params, config = load_model(args, device, mesh)
    rules = sharding.LLAMA_RULES
    if args.loss_chunk:
        config = dataclasses.replace(config, loss_chunk=args.loss_chunk)
    encode = byte_encoder(config.vocab_size)
    shards = 1 if mesh is None else mesh.axis_size(('dp', 'fsdp'))
    batch_size = args.batch_size or max(2, shards)
    say(f'DPO: {mesh_str(mesh, device)} '
        f'model={args.hf_model or "debug"} '
        f'({config.num_params()/1e9:.2f}B) seq={args.seq_len} '
        f'pairs/step={batch_size} beta={args.beta}')
    mesh_kw = ({} if mesh is None else
               dict(mesh=mesh, rules=rules, params_sharded=True))

    train_config = TrainConfig(
        learning_rate=args.learning_rate,
        warmup_steps=min(50, args.steps // 10 + 1),
        total_steps=args.steps, weight_decay=0.0)
    lora_state = None
    if args.lora_rank > 0:
        lcfg = lora_lib.LoraConfig(rank=args.lora_rank,
                                   alpha=args.lora_alpha,
                                   targets=args.lora_targets)
        base_params = params
        adapters = lora_lib.init_lora(
            base_params, lcfg, torch.Generator(device=device).manual_seed(1),
            mesh, rules)
        n_a, n_p = lora_lib.split_shapes(adapters)
        say(f'LoRA-DPO: {n_a} adapted weights, {n_p/1e6:.2f}M '
            f'trainable; reference = frozen base (no copy)')

        def loss(adapters_tree, batch):
            policy = lora_lib.apply_lora(base_params, adapters_tree, lcfg,
                                         mesh, rules)
            # The base tree with adapters off IS the reference policy.
            return dpo.dpo_loss_fn(policy, base_params, batch, config,
                                   beta=args.beta, mesh=mesh, rules=rules)

        if mesh is not None:
            mesh_kw['rules'] = lora_lib.LORA_RULES
        trainer = Trainer(loss, adapters, train_config, device=device,
                          **mesh_kw)
        lora_state = (base_params, lcfg)
    else:
        # Full-parameter DPO: a frozen copy of the start point (the
        # Trainer updates `params` in place), on a mesh this rank's
        # blocks of it, sharded as the policy.
        ref_params = tree_map(lambda p: p.detach().clone(), params)

        def loss(p, batch):
            return dpo.dpo_loss_fn(p, ref_params, batch, config,
                                   beta=args.beta, mesh=mesh, rules=rules)

        trainer = Trainer(loss, params, train_config, device=device,
                          **mesh_kw)

    try:
        if args.resume == 'auto' and args.checkpoint_dir:
            if trainer.restore_latest(args.checkpoint_dir) is not None:
                say(f'resumed from step {trainer.step}')

        batches = dpo.dpo_batches(args.data_file, encode, batch_size,
                                  args.seq_len)
        while trainer.step < args.steps:
            metrics = trainer.run_step(next(batches))
            step = trainer.step
            if step % args.log_every == 0:
                say(f'step {step}: loss={float(metrics["loss"]):.4f}')
            if args.checkpoint_dir and step % args.checkpoint_every == 0:
                trainer.save_checkpoint(args.checkpoint_dir)
        if args.checkpoint_dir:
            trainer.save_checkpoint(args.checkpoint_dir)
    finally:
        trainer.close()
    if lora_state is not None and args.merge_save:
        merge_and_save(args.merge_save, *lora_state, trainer.params, mesh,
                       rules)
        say(f'merged model saved to {args.merge_save}/merged')
    say('DPO done.')


if __name__ == '__main__':
    main()
