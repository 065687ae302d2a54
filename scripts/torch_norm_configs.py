#!/usr/bin/env python3
"""K3's launch policy on the card: RMSNorm (ops/rmsnorm.py::rms_norm) in
bf16 at chip_smoke.py's widths (NORM_SHAPES: 4096, 3072, 1536) and row
counts (NORM_TIMED: 8, 104, 264, 2048; and 8192, a training step's
8 x 1024), at every threads-a-row count from 32 to 1,024 that the
kernel takes there (the fewest vectors a thread that cover the row and
fit its launch bounds) and grids of a block for every few rows or
capped at 4 or 16 blocks an SM, the policy's own (_norm_launch)
marked.  Each configuration is first held to the plain version
(chip_smoke.row_tol), then timed as a replayed CUDA graph
(chip_smoke.graph_ms: device time, L2 flushed before each replay), and
above 264 rows also eagerly (chip_smoke.time_ms, which counts the
wrapper's host time where it outlasts the flush), beside F.rms_norm
timed the same ways.  Also prints the host time of one call of the
wrapper and of F.rms_norm at each shape (enqueue only, no sync).
Prints one JSON line per (width, rows, configuration), the card's name
and power limit in each.

Run from the root of a checkout on a card:
    python3 scripts/torch_norm_configs.py
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from skypilot_tpu_torch.ops import _kernels  # noqa: E402
from skypilot_tpu_torch.ops import rmsnorm  # noqa: E402

ROWS = cs.NORM_TIMED + (8192,)


def _configs(rows, d, sms):
    """(tpr, nv, grid) for every threads-a-row count the kernel takes,
    each with a block for every rpb rows (no walk) and, where that is
    more, capped at 4 and at 16 blocks an SM (a walk)."""
    nvec = d * 2 // 16
    for tpr in (32, 64, 128, 256, 512, 1024):
        if tpr > 32 and tpr > nvec:
            break
        need = -(-nvec // tpr)
        cap = rmsnorm._NORM_MAX_VECS[max(tpr, rmsnorm._NORM_MIN_BLOCK)]
        nv = next((v for v in rmsnorm._NORM_VECS if need <= v <= cap), None)
        if nv is None:
            continue
        blocks = -(-rows // (max(tpr, rmsnorm._NORM_MIN_BLOCK) // tpr))
        for grid in sorted({blocks, min(blocks, 4 * sms),
                            min(blocks, 16 * sms)}):
            yield tpr, nv, grid


def _host_us(fn, reps=200):
    """Host microseconds of one call of fn (enqueue only), the median of
    `reps` calls in a row after a synchronize."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print('needs an NVIDIA card', file=sys.stderr)
        return 2
    card = cs.nvidia_smi_line()
    sms = _kernels.sm_count(torch.device('cuda'))
    gen = torch.Generator(device='cuda').manual_seed(17)
    policy = rmsnorm._norm_launch
    try:
        for name, (d, eps, _) in cs.NORM_SHAPES.items():
            for rows in ROWS:
                x = torch.randn(rows, d, generator=gen,
                                device='cuda').bfloat16()
                w = (1 + 0.1 * torch.randn(d, generator=gen, device='cuda')
                     ).bfloat16()
                want = rmsnorm._rms_norm_plain(x, w, eps)
                eager = rows > cs.NORM_GRAPH_ROWS

                def lib_fn():
                    return torch.nn.functional.rms_norm(x, (d,), w, eps)

                def fn():
                    return rmsnorm.rms_norm(x, w, eps)

                lib = {'graph_ms': cs.graph_ms(lib_fn),
                       'ms': cs.time_ms(lib_fn) if eager else None}
                host_us = {'rms_norm': _host_us(fn),
                           'library': _host_us(lib_fn)}
                b_ms, _ = cs.bound(2 * x.numel() * 2 + d * 2, 4 * x.numel(),
                                   cs.BF16_FLOPS)
                chosen = policy(rows, d, 2, sms)
                for cfg in _configs(rows, d, sms):
                    rmsnorm._norm_launch = lambda *a, cfg=cfg: cfg
                    err = cs.check_close(f'{name} rows={rows} {cfg}', fn(),
                                         want, cs.row_tol(want))
                    g_ms = cs.graph_ms(fn)
                    print(json.dumps({
                        'card': card, 'name': name, 'rows': rows, 'd': d,
                        'threads_a_row': cfg[0], 'vectors_a_thread': cfg[1],
                        'blocks': cfg[2], 'policy': cfg == chosen,
                        'graph_ms': g_ms,
                        'ms': cs.time_ms(fn) if eager else None,
                        'host_us': host_us, 'library': lib,
                        'bound_ms': b_ms, 'bound_share': b_ms / g_ms,
                        'max_abs_err': err}), flush=True)
                    rmsnorm._norm_launch = policy
    finally:
        rmsnorm._norm_launch = policy
    return 0


if __name__ == '__main__':
    sys.exit(main())
