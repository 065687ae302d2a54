#!/usr/bin/env python3
"""Phases 12a and 12c of chip_smoke.py alone: Gemma-7B served on the card.
Builds the kernels (or reuses the build), writes Gemma-7B's published
config at all 28 layers as an HF checkpoint (17.08 GB of random bf16
weights from a seed, under a temporary directory that is removed after),
loads it with convert.load_hf_model, serves phase 5's 8 requests through
the replica and the batcher's CUDA graphs (12a), then again with spec_k
12 and fuse_budget 264 in bf16 and with int8 KV (12c: every K4 launch on
the tensor-core route at head_dim 256), and prints each path's launch
counts and a summary line.

Run from the root of a checkout on a card:
    python3 scripts/torch_gemma_serve_smoke.py
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_gemma_serve_smoke: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import (_kernels, attention, decode_attention,
                                        rmsnorm)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD['line'] = cs.nvidia_smi_line()
    cs.CARD['kind'] = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    cs.log(f'build {time.perf_counter() - start:.1f} s; {cs.CARD["line"]}')
    da = decode_attention
    counters = [da.decode_attention_pooled, attention.flash_attention,
                rmsnorm.rms_norm, da.decode_window_attention_pooled,
                da.fused_step_attention_pooled]
    paths = {}
    scratch = tempfile.mkdtemp(prefix='gemma_serve_smoke_')
    try:
        cs.gemma_path(counters, paths, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for key, launches in paths.items():
        cs.log(f'launches {key}: ' + json.dumps(
            {k: v for k, v in launches.items() if v}))
    cs.log(json.dumps({'card': cs.CARD['line'],
                       'seconds': time.perf_counter() - start}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
