#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving path, on the
card: LLAMA3_8B bf16 (random weights; or, with --mixtral-layers N,
Mixtral-8x7B's widths at N layers, chip_smoke.mixtral_config; or, with
--hf-config, Gemma-7B's or Qwen2.5-1.5B's published config as
chip_smoke's phase 12 serves it, converted by convert.config_from_hf),
ContinuousBatcher batch 8, max_seq_len 2048, decode_chunk 16.

Measures, printing one JSON line each:
  prefill   - llama_infer.prefill of a (4, P) group (the batcher's group
              size), CUDA events, median of 5;
  decode    - steady decode with all 8 slots live at context ~P: host
              time per batcher.step() (one 16-step chunk ending in its one
              host fetch), the median of 4 chunks (each chunk's time in
              chunk_ms_all), per step and per token; device memory
              resident after the chunks and the peak since the batcher
              was built;
  profile   - torch.profiler over one decode chunk: device-busy share of
              the wall time, device time by kernel name (top 12), the
              decode attention's (K1 or K7 with its split-KV combine):
              calls, ms and ms a call, and the gaps between consecutive
              kernels on the card (from the first kernel's start to the
              last one's end: the span, the idle time in it, the median
              and largest gap), and the copy kernels (name with 'copy'):
              calls, ms and the longest call, beside the least time a
              copy of one layer's largest weight would take (its bytes
              read and written at 3.35 TB/s), which shows whether a
              product copied a weight.

Run from the root of a checkout on a card:
    python3 scripts/torch_profile_decode.py [--prompt 512] [--int8]
        [--decode-impl pooled paged] [--graphs off on] [--turns 3]
        [--mixtral-layers 16 | --hf-config gemma-7b]

--int8 serves the decode chunks with kv_cache_dtype='int8' and
weights_dtype='int8' (the prefill timing stays bf16).  --decode-impl
picks the decode planes (default 'pooled'; 'paged' is the bucketed slot
cache with the K7 kernel); --graphs picks eager chunks ('off',
graphs=False) or the batcher's CUDA graphs ('on': each timed chunk is a
replay, its graph captured while the slots were admitted).  Every plane
and graphs mode is measured in turns, --turns times each, on one set of
weights in one process, so that host noise shows as the spread between
turns of the same configuration.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (GEMMA_7B, QWEN25_1_5B, mixtral_config,  # noqa: E402
                        streamed_bytes)
from skypilot_tpu_torch.infer import llama_infer  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import convert, llama, moe  # noqa: E402
from skypilot_tpu_torch.train.trainer import tree_leaves  # noqa: E402

CHUNK = 16
BATCH = 8


def card() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def emit(kind: str, **fields) -> None:
    print(json.dumps({'kind': kind, 'card': CARD, **fields}), flush=True)


def time_prefill(params, cfg, prompt_len: int) -> None:
    group = 4
    tokens = torch.randint(0, cfg.vocab_size, (group, prompt_len),
                           device='cuda')
    lengths = torch.full((group,), prompt_len, dtype=torch.int32,
                         device='cuda')
    times = []
    for _ in range(6):
        cache = llama_infer.init_cache(cfg, group, prompt_len,
                                       device='cuda')
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        llama_infer.prefill(params, tokens, cfg, cache, lengths)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times[1:])
    emit('prefill', group=group, prompt=prompt_len, ms=ms,
         tokens_per_s=group * prompt_len / ms * 1e3)


def _gaps(kernels) -> dict:
    """Idle time between consecutive kernels on the card: span from the
    first start to the last end, the idle ms in it, and the median and
    largest gap in us (overlapping kernels count no gap)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    gaps, end = [], spans[0][1]
    for start, stop in spans[1:]:
        gaps.append(max(0.0, start - end))
        end = max(end, stop)
    span_us = end - spans[0][0]
    return {'span_ms': span_us / 1e3, 'idle_ms': sum(gaps) / 1e3,
            'gap_us_median': statistics.median(gaps) if gaps else 0.0,
            'gap_us_max': max(gaps, default=0.0)}


def profile_decode(params, cfg, prompt_len: int, int8: bool,
                   decode_impl: str, graphs: bool, turn: int) -> None:
    dtypes = (dict(kv_cache_dtype='int8', weights_dtype='int8') if int8
              else {})
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(params, cfg, GeneratorConfig(
        max_seq_len=2048, batch_size=BATCH, decode_impl=decode_impl,
        **dtypes), decode_chunk=CHUNK, device='cuda', graphs=graphs)
    gen = torch.Generator().manual_seed(0)
    for _ in range(BATCH):
        prompt = torch.randint(0, cfg.vocab_size, (prompt_len,),
                               generator=gen).tolist()
        batcher.submit(prompt, max_new_tokens=2048 - prompt_len - 1)
    while batcher.num_queued:
        batcher.step()
    assert batcher.num_active == BATCH
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        batcher.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(walls) / CHUNK
    emit('decode', int8=int8, decode_impl=decode_impl, graphs=graphs,
         turn=turn, slots=BATCH, context=int(batcher._host_pos.max()),
         cache_rows=batcher._cache_len,
         chunk_ms=statistics.median(walls), chunk_ms_all=walls,
         step_ms=step_ms,
         tokens_per_s=BATCH / step_ms * 1e3,
         weights_gb=streamed_bytes(batcher.params) / 1e9,
         weights_bound_ms=streamed_bytes(batcher.params) / 3.35e12 * 1e3,
         graph_captures=batcher.graphs.captures if graphs else 0,
         graph_capture_s=batcher.graphs.capture_seconds if graphs else 0.0,
         resident_gb=torch.cuda.memory_allocated() / 1e9,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        batcher.step()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # K1/K7 launch decode_kernel, and decode_combine_kernel after it on
    # the split route: one attention call is both.
    attn = [(n, c, t) for n, (c, t) in by_name.items()
            if 'decode_kernel' in n or 'decode_combine_kernel' in n]
    calls = sum(c for n, c, _ in attn if 'decode_kernel' in n)
    attn_ms = sum(t for _, _, t in attn) / 1e3
    copies = [e for e in kernels if 'copy' in e.name.lower()]
    largest = max(leaf[0].numel() * leaf.element_size()
                  for leaf in tree_leaves(batcher.params['layers']))
    emit('profile', decode_impl=decode_impl, graphs=graphs, turn=turn,
         wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
         device_busy_share=busy_us / wall_us, kernel_launches=len(kernels),
         gaps=_gaps(kernels),
         decode_attention={
             'calls': calls, 'ms': attn_ms,
             'ms_per_call': attn_ms / calls if calls else None,
             'combine_calls': sum(c for n, c, _ in attn
                                  if 'decode_combine_kernel' in n)},
         copies={'calls': len(copies),
                 'ms': sum(e.device_time for e in copies) / 1e3,
                 'longest_call_ms': max((e.device_time for e in copies),
                                        default=0.0) / 1e3,
                 'layer_weight_gb': largest / 1e9,
                 'layer_weight_copy_ms_floor': 2 * largest / 3.35e9},
         top=[{'name': n[:80], 'calls': c, 'ms': t / 1e3,
               'share_of_busy': t / busy_us} for n, (c, t) in top])


def main() -> int:
    global CARD
    parser = argparse.ArgumentParser()
    parser.add_argument('--prompt', type=int, default=512)
    parser.add_argument('--int8', action='store_true',
                        help='int8 KV arena and int8 weights in decode')
    parser.add_argument('--decode-impl', nargs='+', default=['pooled'],
                        choices=['pooled', 'paged', 'inplace'])
    parser.add_argument('--graphs', nargs='+', default=['off'],
                        choices=['off', 'on'],
                        help="eager chunks ('off') and/or CUDA graphs")
    parser.add_argument('--turns', type=int, default=1)
    parser.add_argument('--mixtral-layers', type=int, default=0,
                        help="N > 0: Mixtral-8x7B's widths at N layers "
                             '(the dense MoE block) in place of LLAMA3_8B')
    parser.add_argument('--hf-config', choices=list(HF_CONFIGS),
                        help='a published HF config in place of LLAMA3_8B')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 2
    CARD = card()
    model = moe if args.mixtral_layers else llama
    cfg = (mixtral_config(args.mixtral_layers) if args.mixtral_layers
           else convert.config_from_hf(HF_CONFIGS[args.hf_config])
           if args.hf_config else llama.LLAMA3_8B)
    params = model.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    time_prefill(params, cfg, args.prompt)
    for turn in range(args.turns):
        for impl in args.decode_impl:
            for mode in args.graphs:
                profile_decode(params, cfg, args.prompt, args.int8, impl,
                               mode == 'on', turn)
                # The batcher, its cache and its graphs are gone: the
                # next configuration starts from the same free memory.
                gc.collect()
                torch.cuda.empty_cache()
    return 0


CARD = ''
HF_CONFIGS = {'gemma-7b': GEMMA_7B, 'qwen2.5-1.5b': QWEN25_1_5B}

if __name__ == '__main__':
    sys.exit(main())
