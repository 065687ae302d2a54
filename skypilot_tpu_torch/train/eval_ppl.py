"""Perplexity evaluation: score a text corpus with a converted HF
checkpoint (or the debug model), on one card or sharded over ranks.

Counterpart of examples/scripts/eval_ppl.py, with its flags and its
printed line.  Run as::

    python -m skypilot_tpu_torch.train.eval_ppl --data-file corpus.txt \\
        --seq-len 2048 --batch-size 4 [--loss-chunk 512] \\
        [--dp 2 | --fsdp 2 | --tp 2] [--hf-model DIR] [--device cpu]

The corpus (plain text, or JSONL with a "text" field) becomes one token
stream (UTF-8 bytes mod the vocabulary: the port has no tokenizer) cut
into (seq_len + 1) windows; a ragged tail of windows short of a batch is
dropped, and said so.  Each batch's summed next-token NLL comes from
``llama.hidden_states`` + ``losses.chunked_token_logprobs`` under
``--loss-chunk``, else ``llama.forward`` + ``token_logprobs``, under
``torch.no_grad`` (K2 without its lse, K3).  Prints one JSON line:
{"perplexity", "nll", "tokens", "seqs"}, the NLL averaged over every
target token.  ``--dp``, ``--fsdp`` or ``--tp`` above 1 score on one
mesh of dp x fsdp x tp rank processes of this host, as the reference
does: the training forward under ``LLAMA_RULES`` (models/llama.py: fsdp
gathers, tp heads and vocabulary blocks), each rank reading only its
blocks of the model, the batch (default one row a data shard) split
over dp x fsdp, and each rank's NLL added over the ranks in rank order;
rank 0 prints.  The model is ``--hf-model DIR`` (models/convert.py),
else the ``--model-size`` preset (LLAMA_DEBUG by default, as the
reference's only one) with random weights from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import List, Tuple

import torch

from skypilot_tpu_torch.train.train_llama import PRESETS
from skypilot_tpu_torch.train.train_sft import (byte_encoder, load_base,
                                                load_base_sharded)


def corpus_ids_from_text(text: str, vocab_size: int) -> List[int]:
    """A corpus as one token stream: each non-empty line (a JSONL line's
    "text" when it parses as JSON) encoded and concatenated."""
    encode = byte_encoder(vocab_size)
    ids: List[int] = []
    for line in text.split('\n'):
        if not line:
            continue
        if line.lstrip().startswith('{'):
            try:
                line = json.loads(line).get('text', line)
            except ValueError:
                pass
        ids.extend(encode(line))
    return ids


def corpus_ids(path: str, vocab_size: int) -> List[int]:
    with open(path, encoding='utf-8') as f:
        return corpus_ids_from_text(f.read(), vocab_size)


def nll_and_count(params, tokens: torch.Tensor, config, mesh=None
                  ) -> Tuple[torch.Tensor, int]:
    """(summed NLL as a 0-d f32 tensor, target count) of one (B, S + 1)
    batch: the model predicts tokens[:, 1:] from tokens[:, :-1].  On a
    mesh each rank scores its rows of the batch and every rank returns
    the sums added over the ranks."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import losses

    with torch.no_grad():
        if mesh is not None:
            from skypilot_tpu_torch.parallel import collectives, sharding
            rows = sharding.shard_tensor(tokens, sharding.BATCH_SPEC, mesh)
            lp = llama.rank_logprobs(params, rows, config, mesh)
            axes = ('dp', 'fsdp', 'sp')
            return (collectives.all_reduce_sum(-lp.sum(), mesh, axes),
                    lp.numel() * mesh.axis_size(axes))
        if config.loss_chunk:
            h = llama.hidden_states(params, tokens[:, :-1], config)
            lp = losses.chunked_token_logprobs(
                h, params['lm_head'], tokens[:, 1:],
                chunk_size=config.loss_chunk)
        else:
            logits = llama.forward(params, tokens[:, :-1], config)
            lp = losses.token_logprobs(logits, tokens[:, 1:])
    return -lp.sum(), lp.numel()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--hf-model', default='',
                        help='local HF checkpoint directory; empty = '
                             'the --model-size preset, random init')
    parser.add_argument('--model-size', choices=sorted(PRESETS),
                        default='debug')
    parser.add_argument('--data-file', required=True,
                        help='plain-text corpus or JSONL with a "text" '
                             'field')
    parser.add_argument('--seq-len', type=int, default=1024)
    parser.add_argument('--batch-size', type=int, default=0,
                        help='0 = one row (a row a data shard on a '
                             'training mesh)')
    parser.add_argument('--max-batches', type=int, default=0,
                        help='cap evaluated batches (0 = whole corpus)')
    parser.add_argument('--dp', type=int, default=0)
    parser.add_argument('--fsdp', type=int, default=0)
    parser.add_argument('--tp', type=int, default=1)
    parser.add_argument('--loss-chunk', type=int, default=0)
    parser.add_argument('--device', default=None,
                        help='cuda (default) or cpu')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    world = max(args.dp, 1) * max(args.fsdp, 1) * args.tp
    if world > 1:
        from skypilot_tpu_torch.train import mesh_run
        mesh_run.launch(world, _mesh_rank, vars(args))
        return 0
    from skypilot_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.hf_model or args.model_size == 'debug':
        params, config = load_base(args.hf_model, device)
    else:
        from skypilot_tpu_torch.models import llama
        config = PRESETS[args.model_size]
        params = llama.init_params(
            config, torch.Generator(device=device).manual_seed(0), device)
    return evaluate(args, params, config, device)


def _mesh_rank(local_rank: int, procs_per_host: int, argd: dict) -> None:
    """One rank of a `--dp`/`--fsdp`/`--tp` run: its blocks of the model
    under LLAMA_RULES (read out of the --hf-model checkpoint's memory
    map, or drawn from seed 0), the rows of each batch it scores."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import mesh_run
    args = argparse.Namespace(**argd)
    device, info = mesh_run.join(args.device, local_rank, procs_per_host)
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(
            dp=max(args.dp, 1), fsdp=max(args.fsdp, 1), tp=args.tp))
        if args.hf_model:
            params, config = load_base_sharded(args.hf_model, mesh, device)
        else:
            config = (llama.LLAMA_DEBUG if args.model_size == 'debug'
                      else PRESETS[args.model_size])
            params = llama.init_params(
                config, torch.Generator(device=device).manual_seed(0),
                device, shard=sharding.init_shard(mesh,
                                                  sharding.LLAMA_RULES))
        evaluate(args, params, config, device, mesh,
                 quiet=info['rank'] != 0)
    finally:
        mesh_run.leave()


def evaluate(args, params, config, device, mesh=None,
             quiet: bool = False) -> int:
    """Score the corpus; print the JSON line (unless quiet)."""
    if args.loss_chunk:
        config = dataclasses.replace(config, loss_chunk=args.loss_chunk)
    ids = corpus_ids(args.data_file, config.vocab_size)
    window = args.seq_len + 1
    n_windows = len(ids) // window
    if n_windows == 0:
        raise SystemExit(f'corpus too small: {len(ids)} tokens < '
                         f'one {window}-token window')
    stream = torch.tensor(ids[:n_windows * window],
                          dtype=torch.int64).reshape(n_windows, window)
    batch_size = args.batch_size or (
        mesh.axis_size(('dp', 'fsdp')) if mesh is not None else 1)
    # Ragged tail windows (< one full batch) are dropped, and said so:
    # silent exclusion would make perplexities incomparable across batch
    # sizes.
    dropped = n_windows % batch_size
    if dropped and not quiet:
        print(f'note: dropping {dropped} tail window(s) '
              f'({n_windows} windows, batch {batch_size})', flush=True)
    total_nll, total_tokens, batches = 0.0, 0, 0
    for start in range(0, n_windows - batch_size + 1, batch_size):
        batch = stream[start:start + batch_size].to(device)
        nll, count = nll_and_count(params, batch, config, mesh)
        total_nll += float(nll)
        total_tokens += count
        batches += 1
        if args.max_batches and batches >= args.max_batches:
            break
    if total_tokens == 0:
        raise SystemExit(f'corpus yields no full batch: {n_windows} '
                         f'windows < batch {batch_size}')
    nll = total_nll / total_tokens
    if quiet:
        return 0
    print(json.dumps({'perplexity': round(math.exp(nll), 4),
                      'nll': round(nll, 5), 'tokens': total_tokens,
                      'seqs': batches * batch_size}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
