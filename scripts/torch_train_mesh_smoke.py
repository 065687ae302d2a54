#!/usr/bin/env python3
"""Phase 17 of chip_smoke.py alone: training meshes with their ranks as
processes sharing cuda:0 over gloo (no number of it is a multi-card
rate).  Builds the kernels (or reuses the build), checks K2 with its
lse, K5 and K6 at every train shape (the per-rank ones of phase 17
among them) and K3 against their plain versions, then runs phase 17
(17a-17f in one spawn of 4 ranks, then 17g) and prints the launch
counts of each path, each kernel's entry and a summary line.

Run from the root of a checkout on a card:
    python3 scripts/torch_train_mesh_smoke.py
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
        print('torch_train_mesh_smoke: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import _kernels, attention, rmsnorm
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD['line'] = cs.nvidia_smi_line()
    cs.CARD['kind'] = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    ptxas = cs.ptxas_report(_kernels.LIBRARY.build_log)
    cs.log(f'build {time.perf_counter() - start:.1f} s; {cs.CARD["line"]}')
    entries = {f'{k} {s}': v for (k, s), v in
               cs.check_flash_train(attention, ptxas).items()}
    for name in ('rms_norm', 'rms_norm[LLAMA_1B d2048]',
                 'rms_norm[MoE small d1024]'):
        entries[name] = cs.check_rmsnorm(rmsnorm, name, ptxas)
    cs.log(f'kernel checks done at {time.perf_counter() - start:.1f} s')
    paths = {}
    scratch = tempfile.mkdtemp(prefix='train_mesh_smoke_')
    t0 = time.perf_counter()
    try:
        cs.mesh_training_path(paths, scratch)
        cs.close_rank_pools()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    cs.log(f'phase 17: {time.perf_counter() - t0:.1f} s')
    for key, launches in paths.items():
        cs.log(f'launches {key}: ' + json.dumps(
            {k: v for k, v in launches.items() if v}))
    for name, entry in entries.items():
        cs.log(f'entry {name}: ' + json.dumps(
            {k: v for k, v in entry.items() if k != 'by_rows'}))
    cs.log(json.dumps({'card': cs.CARD['line'],
                       'seconds': time.perf_counter() - start}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
