#!/usr/bin/env python3
"""Phase 21 of chip_smoke.py alone: a tick's host syncs, held against
the linter.  Builds the kernels (or reuses the build), then (a) runs
``python -m skypilot_tpu_torch.analysis --json --graph-stats`` as a
child, which must exit 0 with the committed findings, and (b) the sync
census: 32 warm ticks of a graphed 8-slot ContinuousBatcher at
LLAMA3_8B's widths (4 of 32 layers, bf16) under
torch.cuda.set_sync_debug_mode('warn'); every main-thread synchronizing
call must lie in engine.host_fetch or on a line the linter flags
SKY101/SKY105.  Prints the SYNC_CENSUS line and the launch counts.

Run from the root of a checkout on a card:
    python3 scripts/torch_sync_census.py
"""
from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('torch_sync_census: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import _kernels, attention
    from skypilot_tpu_torch.ops import decode_attention, rmsnorm
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD['line'] = cs.nvidia_smi_line()
    cs.CARD['kind'] = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    cs.log(f'build {time.perf_counter() - start:.1f} s; {cs.CARD["line"]}')
    t0 = time.perf_counter()
    counters = [decode_attention.decode_attention_pooled,
                attention.flash_attention, rmsnorm.rms_norm]
    census, launches, (graph, suppressed, lint_s) = cs.sync_census(
        counters, HERE)
    cs.log(f'21a: lint child {lint_s:.1f} s, graph {json.dumps(graph)}, '
           f'{suppressed} baselined')
    cs.log(f'21b launches: {json.dumps(launches, sort_keys=True)}')
    cs.log(json.dumps({'card': cs.CARD['line'],
                       'phase_s': time.perf_counter() - t0,
                       'seconds': time.perf_counter() - start}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
