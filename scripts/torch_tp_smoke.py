#!/usr/bin/env python3
"""Phase 16 of chip_smoke.py alone: tensor-parallel serving with its
ranks as processes sharing cuda:0 over gloo (no number of it is a
multi-card rate).  Builds the kernels (or reuses the build), checks K1,
K2 and K4 at the per-rank shapes and K3 at d 8192 against their plain
versions, then runs 16a-16f (or those named) and prints each kernel's
entry with its launches in those paths, and a summary line.

Run from the root of a checkout on a card:
    python3 scripts/torch_tp_smoke.py [a b c d e f]
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('torch_tp_smoke: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import _kernels, attention, decode_attention
    from skypilot_tpu_torch.ops import rmsnorm
    subs = argv or list('abcdef')
    cs.CARD['line'] = cs.nvidia_smi_line()
    cs.CARD['kind'] = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    ptxas = cs.ptxas_report(_kernels.LIBRARY.build_log)
    cs.log(f'build {time.perf_counter() - start:.1f} s; {cs.CARD["line"]}')
    entries = {}
    for seed, label in enumerate(('LLAMA3_8B tp2 rank',
                                  'LLAMA3_70B tp4 rank',
                                  'Qwen2.5-1.5B tp4 rank'), 30):
        entries[label], entries[f'combine {label}'] = cs.check_decode_at(
            decode_attention, ptxas, label, seed)
    for name in cs.FLASH_SHAPES:
        if 'rank' in name:
            entries[name] = cs.check_flash_at(attention, ptxas, name)
    entries['norm'] = cs.check_rmsnorm(rmsnorm, 'rms_norm[LLAMA3_70B d8192]',
                                       ptxas)
    window = cs.check_window(decode_attention, ptxas, 4, 4,
                             cs.TP_WINDOW_SHAPES, 'LLAMA3_8B tp2 rank')
    entries.update({f'window {k}': v for k, v in window.items()})
    cs.log(f'kernel checks done at {time.perf_counter() - start:.1f} s')
    paths, stats = {}, {}
    scratch = tempfile.mkdtemp(prefix='tp_smoke_')
    runs = {'a': lambda: cs.tp_collectives_path(),
            'b': lambda: cs.tp_serve_path(paths),
            'c': lambda: cs.tp_70b_path(paths),
            'd': lambda: cs.tp_qwen_path(paths, scratch),
            'e': lambda: cs.tp_overlap_path(paths),
            'f': lambda: cs.tp_channel_path()}
    try:
        for sub in subs:
            t0 = time.perf_counter()
            stats[sub] = runs[sub]()
            stats[sub + '_s'] = time.perf_counter() - t0
            cs.log(f'16{sub}: {stats[sub + "_s"]:.1f} s')
        cs.close_rank_pools()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for key, launches in paths.items():
        cs.log(f'launches {key}: ' + json.dumps(
            {k: v for k, v in launches.items() if v}))
    for name, entry in entries.items():
        cs.log(f'entry {name}: ' + json.dumps(
            {k: v for k, v in entry.items() if k != 'by_rows'}))
    cs.log(json.dumps({'card': cs.CARD['line'],
                       'seconds': time.perf_counter() - start,
                       'subs': subs}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
