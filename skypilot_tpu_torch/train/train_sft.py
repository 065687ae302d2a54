"""SFT entry point on one card: supervised finetuning on a {prompt,
completion} JSONL dataset with the prompt-masked loss (train/sft.py),
full-parameter or LoRA.

Counterpart of examples/scripts/train_sft.py, with its flags and printed
lines.  Run as::

    python -m skypilot_tpu_torch.train.train_sft --data-file pairs.jsonl \\
        --seq-len 256 --steps 20 [--lora-rank 8 --merge-save DIR] \\
        [--checkpoint-dir D --resume auto] [--device cpu]

The model is ``--hf-model DIR``, a local HF checkpoint directory
(models/convert.py: Llama, Mistral, Gemma, Qwen2, or Mixtral into the
MoE tree), else LLAMA_DEBUG with random weights from seed 0 (adapters
from seed 1); text is encoded as its UTF-8 bytes mod the vocabulary (the
reference's fallback without a tokenizer).  ``--merge-save DIR`` writes
``{'params': merged}`` to ``DIR/merged`` as step 0 in this package's
checkpoint format (``ckpt/format.py``): the port has no Orbax.  The run
is on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from skypilot_tpu_torch.utils import env_contract


def refuse_unported(parser: argparse.ArgumentParser,
                    args: argparse.Namespace) -> None:
    """Exit with a message naming the ROADMAP item of a flag whose path
    is not ported: a mesh axis above 1, expert parallelism included
    (11(g))."""
    mesh = {k: getattr(args, k) for k in ('dp', 'fsdp', 'tp', 'ep')
            if hasattr(args, k)}
    sharded = {k: v for k, v in mesh.items() if v > 1}
    if sharded:
        parser.error(f'{sharded}: this entry point trains on one card; '
                     f'meshes come with ROADMAP item 11(g) (parallel/ '
                     f'sharding)')


def load_base(hf_model: str, device, allow_moe: bool = False):
    """(params, config) of the entry point's model on `device`: the HF
    checkpoint directory `hf_model` converted (models/convert.py), else
    LLAMA_DEBUG with random weights from seed 0.  A Mixtral checkpoint
    loads into the MoE tree where `allow_moe`; elsewhere it exits, as
    the reference scripts only train it through SFT."""
    from skypilot_tpu_torch.models import convert, llama
    if not hf_model:
        config = llama.LLAMA_DEBUG
        return llama.init_params(
            config, torch.Generator(device=device).manual_seed(0),
            device), config
    params, config = convert.load_hf_model(hf_model, device=device)
    if hasattr(config, 'n_experts') and not allow_moe:
        raise SystemExit(f'{hf_model} is a Mixtral (MoE) checkpoint: this '
                         f'entry point trains dense models; finetune it '
                         f'with train_sft')
    return params, config


def byte_encoder(vocab_size: int):
    """text -> its UTF-8 bytes mod the vocabulary."""
    def encode(text: str):
        return [b % vocab_size for b in text.encode('utf-8')]
    return encode


def save_merged(directory: str, merged) -> str:
    """{'params': merged} as step 0 of a checkpoint root DIR/merged, in
    this package's format.  Returns the root."""
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    root = os.path.join(os.path.abspath(directory), 'merged')
    ckpt_format.save_pytree(root, 0, {'params': merged})
    return root


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--hf-model', default='',
                        help='local HF checkpoint directory (default: '
                             'LLAMA_DEBUG, random weights)')
    parser.add_argument('--data-file', required=True,
                        help='JSONL of {"prompt", "completion"} pairs')
    parser.add_argument('--seq-len', type=int, default=2048)
    parser.add_argument('--batch-size', type=int, default=0,
                        help='global batch; 0 = 2')
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--dp', type=int, default=0, help='1 (one card)')
    parser.add_argument('--fsdp', type=int, default=0, help='1 (one card)')
    parser.add_argument('--tp', type=int, default=1, help='1 (one card)')
    parser.add_argument('--ep', type=int, default=1, help='1 (one card)')
    parser.add_argument('--learning-rate', type=float, default=1e-5)
    parser.add_argument('--loss-chunk', type=int, default=0,
                        help='blockwise-CE chunk (0 = full logits); use '
                             'for 100k+ vocabularies')
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='>0: LoRA finetune: train rank-r adapters '
                             'only (train/lora.py); grads/optimizer/'
                             'checkpoints are adapter-sized')
    parser.add_argument('--lora-alpha', type=float, default=32.0)
    parser.add_argument('--lora-targets', default='attn',
                        help="preset (attn, attn-qv, all-linear) or a "
                             'regex over param paths')
    parser.add_argument('--merge-save', default='',
                        help='LoRA only: after training, save the MERGED '
                             'full model here (DIR/merged, this '
                             "package's checkpoint format) for serving")
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--checkpoint-dir',
                        default=os.environ.get(env_contract.CKPT_DIR, ''),
                        help='checkpoint root (default: $SKYTPU_CKPT_DIR '
                             'from the task envs)')
    parser.add_argument('--checkpoint-every', type=int, default=50)
    parser.add_argument('--resume', default='no', choices=['no', 'auto'])
    parser.add_argument('--device', default=None,
                        help='default: the CUDA card')
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    import dataclasses

    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.train import lora as lora_lib
    from skypilot_tpu_torch.train import sft
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)
    params, config = load_base(args.hf_model, device, allow_moe=True)
    if args.loss_chunk:
        config = dataclasses.replace(config, loss_chunk=args.loss_chunk)
    encode = byte_encoder(config.vocab_size)
    batch_size = args.batch_size or 2
    print(f'SFT: devices=1 device={device} '
          f'model={args.hf_model or "debug"} '
          f'({config.num_params()/1e9:.2f}B) seq={args.seq_len} '
          f'batch={batch_size}')

    base_loss = lambda p, b: sft.sft_loss_fn(p, b, config)  # noqa: E731
    train_config = TrainConfig(
        learning_rate=args.learning_rate,
        warmup_steps=min(50, args.steps // 10 + 1),
        total_steps=args.steps)
    lora_state = None
    if args.lora_rank > 0:
        lcfg = lora_lib.LoraConfig(rank=args.lora_rank,
                                   alpha=args.lora_alpha,
                                   targets=args.lora_targets)
        # The base stays frozen; only the adapters go through the
        # Trainer (its grads, AdamW moments and checkpoints).
        adapters = lora_lib.init_lora(
            params, lcfg, torch.Generator(device=device).manual_seed(1))
        n_a, n_p = lora_lib.split_shapes(adapters)
        print(f'LoRA: {n_a} adapted weights, {n_p/1e6:.2f}M trainable '
              f'params (rank {lcfg.rank}, targets {args.lora_targets})')
        trainer = Trainer(lora_lib.wrap_loss(base_loss, params, lcfg),
                          adapters, train_config, device=device)
        lora_state = (params, lcfg)
    else:
        trainer = Trainer(base_loss, params, train_config, device=device)

    try:
        if args.checkpoint_dir:
            # Periodic saves run on a background writer (the step loop
            # only pays for the device->host snapshot); SIGTERM triggers
            # one last blocking emergency save.
            trainer.enable_checkpointing(
                args.checkpoint_dir,
                save_interval_steps=args.checkpoint_every, keep_last=3)
            if args.resume == 'auto' or env_contract.resume_target():
                restored = trainer.restore_latest(args.checkpoint_dir)
                if restored is not None:
                    print(f'resumed from step {restored}')

        batches = sft.sft_batches(args.data_file, encode, batch_size,
                                  args.seq_len)
        while trainer.step < args.steps:
            metrics = trainer.run_step(next(batches))
            if trainer.step % args.log_every == 0:
                print(f'step {trainer.step}: '
                      f'loss={float(metrics["loss"]):.4f}')
        if args.checkpoint_dir:
            trainer.save_checkpoint(args.checkpoint_dir)
            trainer.wait_for_checkpoints(args.checkpoint_dir)
    finally:
        trainer.close()
    if lora_state is not None and args.merge_save:
        base_params, lcfg = lora_state
        save_merged(args.merge_save,
                    lora_lib.merge_lora(base_params, trainer.params, lcfg))
        print(f'merged model saved to {args.merge_save}/merged')
    print('SFT done.')


if __name__ == '__main__':
    main()
