#!/usr/bin/env python3
"""Where the time goes in train_resnet's step on the card: ResNet50 at
batch 256 of 224x224 ones images (bf16 convolutions, channels_last, f32
parameters and batch norms), SGD with momentum 0.9, as chip_smoke.py's
phase 13b drives it.

Measures, printing one JSON line each:
  step     - host time of one step ending in a host fetch of its loss,
             median of --steps after 2 warmup steps; images/s from it;
  profile  - torch.profiler over one such step: the device-busy share of
             the wall time, device time by category (cuDNN convolutions,
             batch norm, elementwise work, reductions, the optimizer's
             foreach kernels) and the top 15 kernels by device time.

Run from the root of a checkout on a card:
    python3 scripts/torch_profile_resnet.py [--batch 256 --size 224
        --steps 10]
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

from skypilot_tpu_torch.models import resnet  # noqa: E402
from skypilot_tpu_torch.train import train_resnet  # noqa: E402

# Kernel name fragments of each category (first match wins).
CATEGORIES = (
    ('batch norm', ('batch_norm', 'batchnorm', 'bn_fw', 'bn_bw')),
    ('cuDNN convolutions', ('conv', 'xmma', 'cutlass', 'sm90', 'dgrad',
                            'wgrad', 'implicit_gemm', 'nchwtonhwc',
                            'nhwctonchw', 'gemm')),
    ('optimizer', ('foreach', 'multi_tensor')),
    ('reductions', ('reduce',)),
)
OTHER = 'elementwise and copies'


def card() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return OTHER


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch', type=int, default=256)
    parser.add_argument('--size', type=int, default=224)
    parser.add_argument('--steps', type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 2
    line = card()
    torch.manual_seed(0)
    model = resnet.ResNet50().cuda()
    step = train_resnet.make_step(model, train_resnet.sgd(model))
    images = torch.ones((args.batch, args.size, args.size, 3),
                        dtype=torch.bfloat16, device='cuda')
    labels = torch.zeros((args.batch,), dtype=torch.long, device='cuda')
    for _ in range(2):
        float(step(images, labels))
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        float(step(images, labels))
        walls.append(time.perf_counter() - t0)
    step_s = statistics.median(walls)
    print(json.dumps({
        'kind': 'step', 'card': line, 'batch': args.batch,
        'image_size': args.size, 'step_ms': step_s * 1e3,
        'step_ms_all': [w * 1e3 for w in walls],
        'images_per_s': args.batch / step_s,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}),
        flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step(images, labels))
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
    print(json.dumps({
        'kind': 'profile', 'card': line, 'wall_ms': wall_us / 1e3,
        'device_busy_ms': busy_us / 1e3,
        'device_busy_share': busy_us / wall_us,
        'kernel_launches': len(kernels),
        'categories': {k: {'calls': c, 'ms': t / 1e3,
                           'share_of_busy': t / busy_us}
                       for k, (c, t) in sorted(by_cat.items(),
                                               key=lambda kv: -kv[1][1])},
        'top': [{'name': n[:100], 'calls': c, 'ms': t / 1e3,
                 'share_of_busy': t / busy_us} for n, (c, t) in top]}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
