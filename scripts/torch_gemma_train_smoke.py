#!/usr/bin/env python3
"""Phase 22 of chip_smoke.py alone: Gemma fine-tuning on the card.
Builds the kernels (or reuses the build), then runs 22a (Gemma-7B's
widths at 4 of its 28 layers, 1 x 4096, 6 steps of Trainer.fit), 22b (a
Gemma-like head_dim-256 config in bf16, card vs host) and 22c
(train_llama --hf-model on a 2-layer Gemma-7B-width checkpoint as a
child), and prints each path's launch counts and a summary line.  The
flash backward's own checks and times are scripts/torch_flash_bwd_bench.py.

Run from the root of a checkout on a card:
    python3 scripts/torch_gemma_train_smoke.py [--arms 22a,22b,22c]
        [--root DIR]

--root runs the arms over another checkout's port (its own build
directory), e.g. a parent commit unpacked beside this one, so that two
trees are timed by the same harness on one card; there 22a does not
require the tensor-core route of K5 and K6.
"""
from __future__ import annotations

import argparse
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
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--arms', default='22a,22b,22c')
    parser.add_argument('--root', default=HERE,
                        help='checkout whose skypilot_tpu_torch to import')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_gemma_train_smoke: no CUDA device', file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from skypilot_tpu_torch.ops import _kernels, attention, rmsnorm
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD['line'] = cs.nvidia_smi_line()
    cs.CARD['kind'] = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    cs.log(f'{attention.__file__}: build {time.perf_counter() - start:.1f} '
           f's; {cs.CARD["line"]}')
    counters = [attention.flash_attention, rmsnorm.rms_norm,
                attention.flash_attention_dq, attention.flash_attention_dkv]
    arms = {'22a': lambda d: cs.gemma_train_path(
                counters, d, check_route=root == HERE)[0],
            '22b': lambda d: cs.gemma_train_parity(),
            '22c': cs.gemma_entry_path}
    paths = {}
    scratch = tempfile.mkdtemp(prefix='gemma_train_smoke_')
    try:
        for sub in args.arms.split(','):
            t0 = time.perf_counter()
            out = arms[sub](scratch)
            if out is not None:
                paths[sub] = out
            cs.log(f'{sub}: {time.perf_counter() - t0:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for key, launches in paths.items():
        cs.log(f'launches {key}: ' + json.dumps(
            {k: v for k, v in launches.items() if v}))
    cs.log(json.dumps({'root': root, 'card': cs.CARD['line'],
                       'seconds': time.perf_counter() - start}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
