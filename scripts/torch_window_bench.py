#!/usr/bin/env python3
"""K4 (the window attention, csrc/paged_window.cu) at head_dim 256 on the
card: checks and times, on their own.

Builds the kernels (or reuses the build), prints the ptxas registers and
spills of every paged_window instantiation and the route that
skk_paged_window_route reports for bf16 at head_dim 64, 128 and 256.
Then, unless --time-only, runs chip_smoke.py phase 3's check_window at
head_dim 256 for Gemma-7B (16 KV heads, G 1) and Gemma-2B's MQA (1 KV
head, G 8): f32, bf16 and int8 arenas at the verify shape (B 8, W 13)
and the fused lane (B 1, W 264 from row 436), each against its plain
version, twice bitwise, on poisoned arenas, at W 1 against K1, the
combine alone, timed beside SDPA's.  Last, it times bf16 and int8 K4 at
those shapes (eager and as a replayed CUDA graph, chip_smoke.time_ms and
graph_ms) with the route each launch took.  The last line is one JSON
object with the times and routes.

    python3 scripts/torch_window_bench.py [--time-only] [--root DIR]

--root imports the port from another checkout (its own build directory),
so that two trees are timed by the same harness on one card, e.g. a
parent commit unpacked beside this one, where bf16 at head_dim 256 takes
the FMA kernel: run parent, this, this, parent.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

VERIFY_POS = [0, cs.BS - 1, cs.BS, 2 * cs.BS + 5, 700, 1000, 1500,
              cs.T_WIDTH * cs.BS - 1]
SHAPES = (('verify', VERIFY_POS, 13), ('fused', [436], 264))


def time_window(da, gen, kv_heads, group, lane, pos_list, win, int8):
    """Eager and graph ms of one bf16 K4 launch, and its route."""
    fn = da.decode_window_attention_pooled
    batch, layer, head_dim = len(pos_list), 1, 256
    n_blocks = 1 + batch * cs.T_WIDTH
    positions = torch.tensor(pos_list, dtype=torch.int32, device='cuda')
    tables = cs._tables([p + win - 1 for p in pos_list], n_blocks, 6)
    q = torch.randn(batch, win, kv_heads, group, head_dim, generator=gen,
                    device='cuda').to(torch.bfloat16)
    k, v, ks, vs = cs._arena(gen, torch.bfloat16, n_blocks, int8, kv_heads,
                             head_dim)

    def kernel():
        return fn(q, k, v, tables, layer, positions, ks, vs)

    tc = fn.launches_tc
    kernel()
    route = 'tc' if fn.launches_tc > tc else 'fma'
    return {'shape': f'{lane} q ({batch}, {win}, {kv_heads}, {group}, 256) '
                     f'{"int8" if int8 else "bf16"} arena',
            'route': route, 'ms': cs.time_ms(kernel),
            'graph_ms': cs.graph_ms(kernel)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--time-only', action='store_true')
    parser.add_argument('--root', default=HERE,
                        help='checkout whose skypilot_tpu_torch to import')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_window_bench: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from skypilot_tpu_torch.ops import _kernels
    from skypilot_tpu_torch.ops import decode_attention as da
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    cs.CARD['line'] = card
    start = time.perf_counter()
    lib = _kernels.LIBRARY.get()
    cs.log(f'{da.__file__}: built in {time.perf_counter() - start:.1f} s; '
           f'{card}')
    ptxas = cs.ptxas_report(_kernels.LIBRARY.build_log)
    window = {n: i for n, i in ptxas.items() if 'paged_window' in n}
    for name, info in sorted(window.items()):
        cs.log(f'  ptxas {name}: {info}')
    routes = {hd: lib.skk_paged_window_route(1, hd) for hd in (64, 128, 256)}
    cs.log(f'  skk_paged_window_route(bf16, hd): {routes}')
    result = {'root': os.path.abspath(args.root), 'card': card,
              'bf16_routes': routes, 'ptxas': window}
    if not args.time_only:
        checked = {}
        for tag, kv, group in cs.WINDOW_HD256:
            entries = cs.check_window(da, ptxas, kv, group, tag=tag,
                                      head_dim=256)
            checked[tag] = {' '.join(k) if isinstance(k, tuple) else k: e
                            for k, e in entries.items()}
            torch.cuda.empty_cache()
        result['checked'] = checked
    gen = torch.Generator(device='cuda').manual_seed(24)
    times = []
    for tag, kv, group in cs.WINDOW_HD256:
        for lane, pos_list, win in SHAPES:
            for int8 in (False, True):
                t = dict(time_window(da, gen, kv, group, lane, pos_list, win,
                                     int8), config=tag)
                cs.log(f'  {json.dumps(t)}')
                times.append(t)
        torch.cuda.empty_cache()
    result['times'] = times
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
