"""SFT entry point on one card or a mesh of ranks: supervised finetuning
on a {prompt, completion} JSONL dataset with the prompt-masked loss
(train/sft.py), full-parameter or LoRA.

Counterpart of examples/scripts/train_sft.py, with its flags and printed
lines.  Run as::

    python -m skypilot_tpu_torch.train.train_sft --data-file pairs.jsonl \\
        --seq-len 256 --steps 20 [--lora-rank 8 --merge-save DIR] \\
        [--fsdp 2 --tp 2] [--checkpoint-dir D --resume auto] [--device cpu]

The model is ``--hf-model DIR``, a local HF checkpoint directory
(models/convert.py: Llama, Mistral, Gemma, Qwen2, or Mixtral into the
MoE tree), else LLAMA_DEBUG with random weights from seed 0 (adapters
from seed 1); text is encoded as its UTF-8 bytes mod the vocabulary (the
reference's fallback without a tokenizer).  ``--dp``, ``--fsdp``,
``--tp`` and ``--ep`` (a Mixtral tree under ``MOE_RULES``) lay the ranks
out on a training mesh as the reference does (``--dp 0``: the cards
left over), one process a rank (train/mesh_run.py): each holds its
blocks of the base, the LoRA adapters are replicated (``LORA_RULES``)
and the global batch (default max(2, dp x fsdp)) is split over dp x
fsdp; rank 0 prints.  ``--merge-save DIR`` writes ``{'params':
merged}`` (the whole tree, from rank 0 on a mesh) to ``DIR/merged`` as
step 0 in this package's checkpoint format (``ckpt/format.py``): the
port has no Orbax.  The run is on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from skypilot_tpu_torch.utils import env_contract


def mesh_config(args):
    """The reference scripts' mesh: the axes given, dp filling the
    cards left over (one on the CPU)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import mesh_run
    n = mesh_run.cards(args.device)
    fsdp, ep = max(args.fsdp, 1), getattr(args, 'ep', 1)
    dp = getattr(args, 'dp', 0) or max(1, n // (fsdp * args.tp * ep))
    return mesh_lib.MeshConfig(dp=dp, fsdp=fsdp, tp=args.tp, ep=ep)


def launch(args, run) -> None:
    """run(args, device, mesh) on one device in this process, or on each
    rank of the entry point's mesh, one process a rank (mesh_run)."""
    from skypilot_tpu_torch.train import mesh_run
    mesh_run.run_on_mesh(args, run, mesh_config(args))


def mesh_str(mesh, device) -> str:
    """The reference's 'devices=N <mesh config>' on a mesh, or the
    one-card 'devices=1 device=...'."""
    if mesh is None:
        return f'devices=1 device={device}'
    from skypilot_tpu_torch.train import mesh_run
    return f'devices={mesh.size} {mesh_run.describe(mesh)} device={device}'


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


def load_base_sharded(hf_model: str, mesh, device, allow_moe: bool = False):
    """load_base on one rank of a training mesh: this rank's blocks under
    LLAMA_RULES (a Mixtral tree under MOE_RULES, where `allow_moe`),
    copied out of the files' memory map, or LLAMA_DEBUG's random
    weights from seed 0 drawn straight into them (no rank holds the
    whole model).  A Mixtral checkpoint exits elsewhere, as in
    load_base."""
    from skypilot_tpu_torch.models import convert, llama
    from skypilot_tpu_torch.parallel import sharding
    if not hf_model:
        config = llama.LLAMA_DEBUG
        return llama.init_params(
            config, torch.Generator(device=device).manual_seed(0), device,
            shard=sharding.init_shard(mesh, sharding.LLAMA_RULES)), config
    moe = hasattr(convert.read_hf_config(hf_model), 'n_experts')
    if moe and not allow_moe:
        raise SystemExit(f'{hf_model} is a Mixtral (MoE) checkpoint: this '
                         f'entry point trains dense models; finetune it '
                         f'with train_sft')
    return convert.load_hf_model_sharded(hf_model, mesh, device=device,
                                         rules=model_rules(moe))


def model_rules(moe: bool):
    """The partition rules of a dense or a Mixtral (MoE) tree."""
    from skypilot_tpu_torch.parallel import sharding
    return sharding.MOE_RULES if moe else sharding.LLAMA_RULES


def load_model(args, device, mesh, allow_moe: bool = False):
    """(params, config) of an entry point: load_base on one device, this
    rank's blocks (load_base_sharded) on a mesh."""
    if mesh is None:
        return load_base(args.hf_model, device, allow_moe)
    return load_base_sharded(args.hf_model, mesh, device, allow_moe)


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
    parser.add_argument('--dp', type=int, default=0,
                        help='0 = the cards left over')
    parser.add_argument('--fsdp', type=int, default=0)
    parser.add_argument('--tp', type=int, default=1)
    parser.add_argument('--ep', type=int, default=1,
                        help='expert-parallel degree (Mixtral-family '
                             'checkpoints only): shards the expert bank '
                             'over the ep mesh axis')
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
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    launch(args, run)


def run(args, device, mesh=None) -> None:
    """The finetune of one process: the whole run on one device, or one
    rank of `mesh`."""
    from skypilot_tpu_torch.train import lora as lora_lib
    from skypilot_tpu_torch.train import sft
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    from skypilot_tpu_torch.train import mesh_run
    say = mesh_run.lead_print(mesh)
    params, config = load_model(args, device, mesh, allow_moe=True)
    is_moe = hasattr(config, 'n_experts')
    if args.ep > 1 and not is_moe:
        raise SystemExit('--ep needs a Mixtral-family checkpoint')
    rules = model_rules(is_moe)
    if args.loss_chunk:
        config = dataclasses.replace(config, loss_chunk=args.loss_chunk)
    encode = byte_encoder(config.vocab_size)
    shards = 1 if mesh is None else mesh.axis_size(('dp', 'fsdp'))
    batch_size = args.batch_size or max(2, shards)
    say(f'SFT: {mesh_str(mesh, device)} '
        f'model={args.hf_model or "debug"} '
        f'({config.num_params()/1e9:.2f}B) seq={args.seq_len} '
        f'batch={batch_size}')

    def base_loss(p, b):
        return sft.sft_loss_fn(p, b, config, mesh=mesh, rules=rules)
    mesh_kw = ({} if mesh is None else
               dict(mesh=mesh, rules=rules, params_sharded=True))
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
            params, lcfg, torch.Generator(device=device).manual_seed(1),
            mesh, rules)
        n_a, n_p = lora_lib.split_shapes(adapters)
        say(f'LoRA: {n_a} adapted weights, {n_p/1e6:.2f}M trainable '
            f'params (rank {lcfg.rank}, targets {args.lora_targets})')
        if mesh is not None:
            mesh_kw['rules'] = lora_lib.LORA_RULES
        trainer = Trainer(lora_lib.wrap_loss(base_loss, params, lcfg, mesh,
                                             rules),
                          adapters, train_config, device=device, **mesh_kw)
        lora_state = (params, lcfg)
    else:
        trainer = Trainer(base_loss, params, train_config, device=device,
                          **mesh_kw)

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
                    say(f'resumed from step {restored}')

        batches = sft.sft_batches(args.data_file, encode, batch_size,
                                  args.seq_len)
        while trainer.step < args.steps:
            metrics = trainer.run_step(next(batches))
            if trainer.step % args.log_every == 0:
                say(f'step {trainer.step}: '
                    f'loss={float(metrics["loss"]):.4f}')
        if args.checkpoint_dir:
            trainer.save_checkpoint(args.checkpoint_dir)
            trainer.wait_for_checkpoints(args.checkpoint_dir)
    finally:
        trainer.close()
    if lora_state is not None and args.merge_save:
        merge_and_save(args.merge_save, *lora_state, trainer.params, mesh,
                       rules)
        say(f'merged model saved to {args.merge_save}/merged')
    say('SFT done.')


def merge_and_save(directory: str, base, lcfg, adapters, mesh=None,
                   rules=None) -> None:
    """--merge-save: the merged whole tree (lora.merge_lora; gathered to
    rank 0 on a mesh) saved by save_merged, from rank 0 on a mesh."""
    from skypilot_tpu_torch.train import lora as lora_lib
    merged = lora_lib.merge_lora(base, adapters, lcfg, mesh,
                                 rules or model_rules(False))
    if mesh is None or mesh.rank == 0:
        save_merged(directory, merged)
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()


if __name__ == '__main__':
    main()
