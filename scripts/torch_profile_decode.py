#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving path, on the
card: LLAMA3_8B bf16 (random weights), ContinuousBatcher batch 8,
max_seq_len 2048, decode_chunk 16.

Measures, printing one JSON line each:
  prefill   - llama_infer.prefill of a (4, P) group (the batcher's group
              size), CUDA events, median of 5;
  decode    - steady decode with all 8 slots live at context ~P: host
              time per batcher.step() (one 16-step chunk ending in its one
              host fetch), per step and per token;
  profile   - torch.profiler over one decode chunk: device-busy share of
              the wall time, and device time by kernel name (top 12).

Run from the root of a checkout on a card:
    python3 scripts/torch_profile_decode.py [--prompt 512]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from skypilot_tpu_torch.infer import llama_infer  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402

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


def profile_decode(params, cfg, prompt_len: int) -> None:
    batcher = ContinuousBatcher(params, cfg, GeneratorConfig(
        max_seq_len=2048, batch_size=BATCH), decode_chunk=CHUNK,
        device='cuda')
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
    emit('decode', slots=BATCH, context=int(batcher._host_pos.max()),
         chunk_ms=statistics.median(walls), step_ms=step_ms,
         tokens_per_s=BATCH / step_ms * 1e3,
         weights_gb=cfg.num_params() * 2 / 1e9,
         weights_bound_ms=cfg.num_params() * 2 / 3.35e12 * 1e3)

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
    emit('profile', wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
         device_busy_share=busy_us / wall_us, kernel_launches=len(kernels),
         top=[{'name': n[:80], 'calls': c, 'ms': t / 1e3,
               'share_of_busy': t / busy_us} for n, (c, t) in top])


def main() -> int:
    global CARD
    parser = argparse.ArgumentParser()
    parser.add_argument('--prompt', type=int, default=512)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 2
    CARD = card()
    cfg = llama.LLAMA3_8B
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    time_prefill(params, cfg, args.prompt)
    profile_decode(params, cfg, args.prompt)
    return 0


CARD = ''

if __name__ == '__main__':
    sys.exit(main())
