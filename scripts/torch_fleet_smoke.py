#!/usr/bin/env python3
"""Phase 19 of chip_smoke.py alone: the serving fleet
(skypilot_tpu_torch/serve/traffic/simulator.py: traffic, routing, SLO
burn, autoscalers, failover, the fleet doctor and disaggregated prefill)
over the port's batchers, LLAMA_DEBUG f32 on the card and on the host,
then LLAMA3_8B's widths in bf16 at 8 of its 32 layers with every
byte budget and link rate x16.  Builds the kernels (or reuses the build), checks K1 (and its
combine), K2 and K3 at the fleet's shapes against their plain versions,
then runs phase 19 and prints the launch counts of each 8B arm, each
kernel's entry and a summary line.

Run from the root of a checkout on a card:
    python3 scripts/torch_fleet_smoke.py [--skip-checks]
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
        print('torch_fleet_smoke: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import (_kernels, attention,
                                        decode_attention, rmsnorm)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD['line'] = cs.nvidia_smi_line()
    cs.CARD['kind'] = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    ptxas = cs.ptxas_report(_kernels.LIBRARY.build_log)
    cs.log(f'build {time.perf_counter() - start:.1f} s; {cs.CARD["line"]}')
    entries = {}
    if '--skip-checks' not in argv:
        label = 'LLAMA3_8B fleet'
        entries[label], entries[f'combine {label}'] = cs.check_decode_at(
            decode_attention, ptxas, label, 33)
        name = 'flash_attention[LLAMA3_8B fleet prefill]'
        entries[name] = cs.check_flash_at(attention, ptxas, name)
        entries['rms_norm'] = cs.check_rmsnorm(rmsnorm, 'rms_norm', ptxas)
        cs.log(f'kernel checks done at {time.perf_counter() - start:.1f} s')
    da = decode_attention
    counters = [da.decode_attention_pooled, attention.flash_attention,
                rmsnorm.rms_norm]
    paths = {}
    t0 = time.perf_counter()
    stats = cs.fleet_path(paths, counters)
    cs.log(f'phase 19: {time.perf_counter() - t0:.1f} s')
    for key, launches in paths.items():
        cs.log(f'launches {key}: ' + json.dumps(
            {k: v for k, v in launches.items() if v}))
    for name, entry in entries.items():
        cs.log(f'entry {name}: ' + json.dumps(
            {k: v for k, v in entry.items() if k != 'by_rows'}))
    cs.log(json.dumps({'card': cs.CARD['line'],
                       'memory': stats['memory'],
                       'seconds': time.perf_counter() - start}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
