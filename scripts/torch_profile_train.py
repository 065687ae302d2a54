#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's training step, on the
card: LLAMA_1B at the reference bench's settings (random bf16 weights,
8 x 1024 tokens, remat 'dots', loss_chunk 256), or with --8b LLAMA3_8B's
widths at depth 2 (2 x 4096 tokens, loss_chunk 512), or with --lora-8b
a LoRA-SFT step of LLAMA3_8B at all 32 layers (frozen bf16 base, rank 16,
alpha 32 on the attn target, 2 x 2048 tokens, loss_chunk 512, a prompt
mask over the first quarter of each row), as chip_smoke.py's phase 10a.

Measures, printing one JSON line each:
  step     - host time of one Trainer.run_step ending in a host fetch of
             its loss, median of 5 after 3 warmup steps;
  profile  - torch.profiler over one such step: the device-busy share of
             the wall time, device time by category (K2 flash forward,
             K5 flash dq, K6 flash dk/dv, K3 RMSNorm, cuBLAS products,
             elementwise work, reductions and copies) and the top 15
             kernels by device time.

Run from the root of a checkout on a card:
    python3 scripts/torch_profile_train.py [--8b | --lora-8b]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.train import lora, sft, trainer  # noqa: E402

# Kernel name fragments of each category (first match wins).
CATEGORIES = (
    # Both routes: flash_bwd_dq_kernel (FMA), flash_bwd_dq_mma_kernel
    # (tensor cores), and K6's and K2's likewise.
    ('K5 flash dq', ('flash_bwd_dq_',)),
    ('K6 flash dk/dv', ('flash_bwd_dkv_',)),
    ('K2 flash forward', ('flash_fwd_',)),
    ('K3 rmsnorm', ('rmsnorm_kernel',)),
    ('cuBLAS products', ('gemm', 'xmma', 'cutlass', 'nvjet', 'cublas')),
)
OTHER = 'elementwise, reductions, copies'


def card() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return label
    return OTHER


def emit(kind: str, **fields) -> None:
    print(json.dumps({'kind': kind, 'card': CARD, **fields}), flush=True)


def main() -> int:
    global CARD
    parser = argparse.ArgumentParser()
    parser.add_argument('--8b', dest='eight_b', action='store_true',
                        help='LLAMA3_8B widths at depth 2, 2 x 4096 tokens')
    parser.add_argument('--lora-8b', dest='lora_8b', action='store_true',
                        help='LoRA-SFT of LLAMA3_8B at 32 layers, 2 x 2048 '
                             'tokens')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 2
    CARD = card()
    remat = dict(remat=True, remat_policy='dots')
    if args.lora_8b:
        cfg = dataclasses.replace(llama.LLAMA3_8B, max_seq_len=2048,
                                  loss_chunk=512, **remat)
        batch, seq, label = 2, 2048, 'LLAMA3_8B LoRA-SFT, 32 layers'
    elif args.eight_b:
        cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=2,
                                  max_seq_len=4096, loss_chunk=512, **remat)
        batch, seq, label = 2, 4096, 'LLAMA3_8B widths, 2 layers'
    else:
        cfg = dataclasses.replace(llama.LLAMA_1B, max_seq_len=2048,
                                  loss_chunk=256, **remat)
        batch, seq, label = 8, 1024, 'LLAMA_1B'
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    train_config = trainer.TrainConfig(warmup_steps=2, total_steps=12)
    batches = trainer.synthetic_batches(batch, seq, cfg.vocab_size)
    if args.lora_8b:
        lcfg = lora.LoraConfig(rank=16, alpha=32.0, targets='attn')
        adapters = lora.init_lora(
            params, lcfg, torch.Generator(device='cuda').manual_seed(1))
        tr = trainer.Trainer(
            lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, cfg), params,
                           lcfg), adapters, train_config, device='cuda')
        mask = np.zeros((batch, seq), np.float32)
        mask[:, seq // 4:] = 1.0
        batches = ({**b, 'loss_mask': mask} for b in batches)
    else:
        tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg), params,
                             train_config, device='cuda')
    del params
    for _ in range(3):
        float(tr.run_step(next(batches))['loss'])
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        float(tr.run_step(next(batches))['loss'])
        walls.append(time.perf_counter() - t0)
    step_s = statistics.median(walls)
    emit('step', model=label, tokens=batch * seq, step_s=step_s,
         tokens_per_s=batch * seq / step_s,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(tr.run_step(next(batches))['loss'])
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    by_cat, by_name = {}, {}
    for e in kernels:
        for table, key in ((by_cat, category(e.name)), (by_name, e.name)):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + e.device_time)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    emit('profile', model=label, wall_ms=wall_us / 1e3,
         device_busy_ms=busy_us / 1e3, device_busy_share=busy_us / wall_us,
         kernel_launches=len(kernels),
         categories={k: {'calls': c, 'ms': t / 1e3,
                         'share_of_busy': t / busy_us}
                     for k, (c, t) in sorted(by_cat.items(),
                                             key=lambda kv: -kv[1][1])},
         top=[{'name': n[:90], 'calls': c, 'ms': t / 1e3,
               'share_of_busy': t / busy_us} for n, (c, t) in top])
    return 0


CARD = ''

if __name__ == '__main__':
    sys.exit(main())
