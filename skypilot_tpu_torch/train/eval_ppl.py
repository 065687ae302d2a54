"""Perplexity evaluation on one card: score a text corpus with a
converted HF checkpoint (or the debug model).

Counterpart of examples/scripts/eval_ppl.py, with its flags and its
printed line.  Run as::

    python -m skypilot_tpu_torch.train.eval_ppl --data-file corpus.txt \\
        --seq-len 2048 --batch-size 4 [--loss-chunk 512] \\
        [--hf-model DIR] [--device cpu]

The corpus (plain text, or JSONL with a "text" field) becomes one token
stream (UTF-8 bytes mod the vocabulary: the port has no tokenizer) cut
into (seq_len + 1) windows; a ragged tail of windows short of a batch is
dropped, and said so.  Each batch's summed next-token NLL comes from
``llama.hidden_states`` + ``losses.chunked_token_logprobs`` under
``--loss-chunk``, else ``llama.forward`` + ``token_logprobs``, under
``torch.no_grad`` (K2 without its lse, K3).  Prints one JSON line:
{"perplexity", "nll", "tokens", "seqs"}, the NLL averaged over every
target token.  ``--tp k`` scores with k rank processes of this host over
one sharded model (infer/tp.py's serving rules, the trunk of
``llama_infer.hidden_states`` and lm_head's vocab blocks gathered per
``--loss-chunk`` span of positions); rank 0 prints.  ``--dp``/``--fsdp``
above 1 are refused: the training meshes are ROADMAP item 11(g).  The
model is ``--hf-model DIR`` (models/convert.py), else
the ``--model-size`` preset (LLAMA_DEBUG by default, as the reference's
only one) with random weights from seed 0.
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
                                                refuse_unported)


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
    batch: the model predicts tokens[:, 1:] from tokens[:, :-1].  Under a
    mesh every rank returns the same sum."""
    from skypilot_tpu_torch.infer import llama_infer
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import losses

    with torch.no_grad():
        if mesh is not None:
            h = llama_infer.hidden_states(params, tokens[:, :-1], config,
                                          mesh)
            span = config.loss_chunk or h.shape[1]
            lp = torch.cat([losses.token_logprobs(
                llama_infer.logits(h[:, lo:lo + span], params, mesh),
                tokens[:, 1 + lo:1 + lo + span])
                for lo in range(0, h.shape[1], span)], dim=1)
        elif config.loss_chunk:
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
                        help='0 = one row (one card)')
    parser.add_argument('--max-batches', type=int, default=0,
                        help='cap evaluated batches (0 = whole corpus)')
    parser.add_argument('--dp', type=int, default=0)
    parser.add_argument('--fsdp', type=int, default=0)
    parser.add_argument('--tp', type=int, default=1)
    parser.add_argument('--loss-chunk', type=int, default=0)
    parser.add_argument('--device', default=None,
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    refuse_unported(parser, args, allow=('tp',))
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.tp > 1:
        from skypilot_tpu_torch.infer import multihost
        multihost.launch_local_ranks(args.tp, _rank, (vars(args),))
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


def _rank(local_rank: int, world: int, argd: dict) -> None:
    """One rank of `--tp world`: its shards (read with
    load_hf_model_sharded, or drawn with init_sharded_params from seed
    0), the same batches as every rank."""
    import torch.distributed as dist

    from skypilot_tpu_torch.infer import multihost
    from skypilot_tpu_torch.infer import tp as tp_lib
    from skypilot_tpu_torch.models import convert, llama
    args = argparse.Namespace(**argd)
    device = multihost.rank_device(args.device, local_rank)
    info = multihost.initialize_from_env(
        backend=multihost.default_backend(args.device, world),
        procs_per_host=world, local_rank=local_rank)
    if args.hf_model:
        config = convert.read_hf_config(args.hf_model)
        mesh = multihost.make_replica_mesh(n_kv_heads=config.n_kv_heads)
        params, config = convert.load_hf_model_sharded(args.hf_model, mesh,
                                                       device=device)
    else:
        config = (llama.LLAMA_DEBUG if args.model_size == 'debug'
                  else PRESETS[args.model_size])
        mesh = multihost.make_replica_mesh(n_kv_heads=config.n_kv_heads)
        params = tp_lib.init_sharded_params(
            config, torch.Generator(device=device).manual_seed(0), mesh,
            device)
    evaluate(args, params, config, device, mesh,
             quiet=info['rank'] != 0)
    dist.destroy_process_group()


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
    batch_size = args.batch_size or 1
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
