"""Offline batch inference: JSONL prompts in, JSONL generations out.

Counterpart of examples/scripts/batch_infer.py, with its flags, lines
and printed messages.  Run as::

    python -m skypilot_tpu_torch.infer.batch_infer --input prompts.jsonl \\
        --output gen.jsonl [--resume] [--model-size 8b | --hf-model DIR] \\
        [--device cpu]

It drives the same ContinuousBatcher as the replica (built by
``replica.build_generator``), keeping up to 2 x ``--batch-size``
requests in flight, and writes each result as it finishes, so
``--resume`` (skip the ids already in --output, append) picks a
preempted run up where it stopped; a partial last line left by a cut
write is ended first, and its id runs again.

Input lines:  {"id": optional, "prompt": "text"} (UTF-8 bytes mod the
              vocabulary: the port has no tokenizer) or
              {"id": ..., "prompt_ids": [1, 2, 3]}; the id defaults to
              the line's index.
Output lines: {"id", "prompt_tokens", "output_ids"} ("output_text" is
              the reference's only with a tokenizer).
``--tp k`` runs k rank processes of this host over one sharded model
(infer/multihost.py): rank 0 runs this loop through a MultiHostBatcher,
the others replay its scheduler calls.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_args(argv=None):
    from skypilot_tpu_torch.infer.replica import MODEL_SIZES

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--input', required=True)
    parser.add_argument('--output', required=True)
    parser.add_argument('--hf-model', default='',
                        help='local HF checkpoint directory')
    parser.add_argument('--model-size', choices=MODEL_SIZES,
                        default='debug')
    parser.add_argument('--max-new-tokens', type=int, default=128)
    parser.add_argument('--max-seq-len', type=int, default=1024)
    parser.add_argument('--batch-size', type=int, default=8,
                        help='decode slots')
    parser.add_argument('--temperature', type=float, default=0.0)
    parser.add_argument('--tp', type=int, default=1,
                        help='rank processes of this host (tensor '
                             'parallel, one card each or sharing it)')
    parser.add_argument('--kv-cache-dtype', default=None,
                        choices=[None, 'int8'])
    parser.add_argument('--weights-dtype', default=None,
                        choices=[None, 'int8'])
    parser.add_argument('--prefill-chunk', type=int, default=None)
    parser.add_argument('--resume', action='store_true',
                        help='skip ids already in --output (append)')
    parser.add_argument('--seed', type=int, default=0,
                        help='random weights of --model-size')
    parser.add_argument('--device', default=None,
                        help='cuda (default) or cpu')
    return parser.parse_args(argv)


def read_prompts(path: str, config, done_ids):
    """[(id, token ids)] of the input lines whose id is not in done_ids."""
    from skypilot_tpu_torch.infer.replica import _encode_text

    todo = []
    with open(path, encoding='utf-8') as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            ex = json.loads(line)
            ex_id = ex.get('id', i)
            if ex_id in done_ids:
                continue
            if 'prompt_ids' in ex:
                ids = [int(t) for t in ex['prompt_ids']]
            elif 'prompt' in ex:
                ids = _encode_text(ex['prompt'], config)
            else:
                raise SystemExit(f'{path}:{i + 1}: need "prompt" or '
                                 f'"prompt_ids"')
            todo.append((ex_id, ids))
    return todo


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.tp > 1:
        from skypilot_tpu_torch.infer import multihost
        multihost.launch_local_ranks(args.tp, _rank, (vars(args),))
        return 0
    from skypilot_tpu_torch.infer.replica import build_generator

    gen, config = build_generator(
        args.model_size, args.max_seq_len, args.temperature, args.hf_model,
        args.batch_size, device=args.device, seed=args.seed,
        kv_cache_dtype=args.kv_cache_dtype,
        weights_dtype=args.weights_dtype, prefill_chunk=args.prefill_chunk)
    return run(args, gen, config)


def _rank(local_rank: int, world: int, argd: dict) -> None:
    from skypilot_tpu_torch.infer import multihost
    from skypilot_tpu_torch.infer.replica import rank_generator
    args = argparse.Namespace(**argd)
    gen, channel = rank_generator(local_rank, world, args)
    if channel.role == 'worker':
        multihost.worker_loop(gen, channel)
        return
    run(args, gen, gen.config)


def run(args, gen, config) -> int:
    """The batch loop over a batcher (or a MultiHostBatcher)."""
    done_ids = set()
    torn = False
    if args.resume and os.path.exists(args.output):
        with open(args.output, encoding='utf-8') as f:
            for line in f:
                torn = not line.endswith('\n')
                try:
                    done_ids.add(json.loads(line)['id'])
                except (ValueError, KeyError):
                    continue
    todo = read_prompts(args.input, config, done_ids)
    print(f'batch_infer: {len(todo)} prompts '
          f'({len(done_ids)} already done)', flush=True)

    in_flight = {}   # rid -> (id, prompt tokens)
    written = generated = 0
    start = time.perf_counter()
    try:
        with open(args.output, 'a' if args.resume else 'w',
                  encoding='utf-8') as out:
            if torn:
                # A run cut mid-write left a partial last line: end it,
                # so the first appended record starts a line of its own
                # (the partial one's id is not done and runs again).
                out.write('\n')
            queue = list(todo)
            while queue or in_flight:
                # Keep up to 2x slots in flight: the batcher admits into
                # free slots as others finish (continuous batching).
                while queue and len(in_flight) < 2 * args.batch_size:
                    ex_id, ids = queue.pop(0)
                    rid = gen.submit(ids,
                                     max_new_tokens=args.max_new_tokens)
                    in_flight[rid] = (ex_id, len(ids))
                gen.step()
                for rid in [r for r in list(in_flight) if gen.is_done(r)]:
                    ex_id, n_prompt = in_flight.pop(rid)
                    rec = {'id': ex_id, 'prompt_tokens': n_prompt,
                           'output_ids': gen.result(rid)}
                    out.write(json.dumps(rec) + '\n')
                    out.flush()
                    written += 1
                    generated += len(rec['output_ids'])
                    if written % 50 == 0:
                        print(f'batch_infer: {written} done', flush=True)
    finally:
        gen.close()
    seconds = time.perf_counter() - start
    print(f'batch_infer: wrote {written} generations to {args.output}',
          flush=True)
    if written:
        print(f'batch_infer: {written} prompts, {generated} tokens in '
              f'{seconds:.3f} s ({written / seconds:.3f} prompts/s, '
              f'{generated / seconds:.1f} tokens/s)', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
