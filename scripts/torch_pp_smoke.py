#!/usr/bin/env python3
"""Phase 18 of chip_smoke.py alone: pipelines over 'pp' (pp x dp, pp 4,
pp x fsdp, pp x sp), LoRA-SFT, LoRA-DPO and GRPO on training meshes,
MoE's 'capacity' router under sp, and the legacy decode planes at tp 2
(K7 per shard), with the ranks as processes sharing cuda:0 over gloo (no
number of it is a multi-card rate).  Builds the kernels (or reuses the
build), checks K2 with its lse, K5 and K6 at every train shape (18a's
microbatch and 18d's rank among them), K3 at the ranks' widths and K7 at
the per-shard shape against their plain versions, then runs phase 18
and prints the launch counts of each path, each kernel's entry and a
summary line.

Run from the root of a checkout on a card:
    python3 scripts/torch_pp_smoke.py [--skip-checks]
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
        print('torch_pp_smoke: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import (_kernels, attention,
                                        decode_attention, rmsnorm)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD['line'] = cs.nvidia_smi_line()
    cs.CARD['kind'] = torch.cuda.get_device_name(0)
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    ptxas = cs.ptxas_report(_kernels.LIBRARY.build_log)
    cs.log(f'build {time.perf_counter() - start:.1f} s; {cs.CARD["line"]}')
    entries = {}
    if '--skip-checks' not in argv:
        entries.update({f'{k} {s}': v for (k, s), v in
                        cs.check_flash_train(attention, ptxas).items()})
        for name in ('rms_norm', 'rms_norm[LLAMA_1B d2048]',
                     'rms_norm[MoE small d1024]'):
            entries[name] = cs.check_rmsnorm(rmsnorm, name, ptxas)
        for label, entry in cs.check_contig_decode(
                decode_attention, ptxas, kv_heads=4, group=4,
                tag='LLAMA3_8B tp2 rank', seed=33,
                variants=('bf16', 'int8')).items():
            entries[entry['name']] = entry
        cs.log(f'kernel checks done at {time.perf_counter() - start:.1f} s')
    paths = {}
    scratch = tempfile.mkdtemp(prefix='pp_smoke_')
    t0 = time.perf_counter()
    try:
        cs.pp_training_path(paths, scratch)
        cs.log(f'18a-e: {time.perf_counter() - t0:.1f} s')
        t1 = time.perf_counter()
        cs.legacy_tp_path(paths)
        cs.log(f'18f: {time.perf_counter() - t1:.1f} s')
        cs.close_rank_pools()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    cs.log(f'phase 18: {time.perf_counter() - t0:.1f} s')
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
    sys.exit(main(sys.argv[1:]))
