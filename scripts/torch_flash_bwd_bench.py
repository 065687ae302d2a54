#!/usr/bin/env python3
"""K5 and K6 (the flash backward, csrc/flash_bwd.cu) on the card: checks
and times, on their own.

Builds the kernels (or reuses the build), prints the ptxas registers and
spills of every flash-backward instantiation, holds K5 and K6 in bf16 at
head_dim 256 against their plain versions at the edges of the tensor-core
tiles (S 1, 16, 17, 31, 33, 65 and 1000; groups 1, 2 and 8; causal and
not), at Gemma-2B's shape (8 query heads over 1 KV head) and at
Gemma-7B's training shape, then times K5, K6, their plain versions and
SDPA's backward (dq, dk and dv in one call; the library yardstick, used
nowhere in the port) at Gemma-7B's training shape, q (1, 4096, 16, 256)
causal, and at the 8B trunk's, q (2, 4096, 32, 128) over 8 KV heads.
The last line is one JSON object with the times, bounds and routes.

    python3 scripts/torch_flash_bwd_bench.py [--time-only] [--root DIR]

--root imports the port from another checkout (its own build directory),
so that two trees are timed by the same harness on one card, e.g. a
parent commit unpacked beside this one: run parent, this, this, parent.
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

# (label, (B, S, H, KV, head_dim)) of the timed shapes.
TIMED = (('gemma7b', (1, 4096, 16, 16, 256)), ('8b', (2, 4096, 32, 8, 128)))
# The tile edges of the D-256 kernels: K5's 16-row warps, 32-key tiles
# and 128-row q-tiles; K6's 16-key pairs, 64-key blocks and 32-column
# passes.
EDGE_SEQS = (1, 16, 17, 31, 33, 65, 1000)


def check(at, gen):
    n = 0
    for seq in EDGE_SEQS:
        for group in (1, 2, 8):
            for causal in (True, False):
                q, k, v, do = cs._attn_operands(gen, 2, seq, 2 * group, 2, 256,
                                                torch.bfloat16)
                cs._check_train_kernels(at, q, k, v, do, causal,
                                        f'bf16 hd256 S={seq} G={group} '
                                        f'causal={causal}')
                n += 1
    for tag, shape in (('Gemma-2B G8 ragged', (2, 700, 8, 1, 256)),
                       ('Gemma-7B train', (1, 4096, 16, 16, 256))):
        batch, seq, heads, kv, hd = shape
        q, k, v, do = cs._attn_operands(gen, batch, seq, heads, kv, hd,
                                        torch.bfloat16)
        cs._check_train_kernels(at, q, k, v, do, True, tag)
        n += 1
    return n


def time_shape(at, gen, shape):
    batch, seq, heads, kv, hd = shape
    q, k, v, do = cs._attn_operands(gen, batch, seq, heads, kv, hd,
                                    torch.bfloat16)
    o, lse = at.flash_attention_fwd(q, k, v, True, need_lse=True)
    delta = at._delta(o, do).contiguous()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with torch.enable_grad():
        lib_out = cs.sdpa(qt, kt, vt, is_causal=True)
    lib_do = do.transpose(1, 2)
    pairs = batch * heads * seq * (seq + 1) // 2
    qb, kb, sb = q.numel() * 2, k.numel() * 2, lse.numel() * 4
    out = {'shape': f'q ({batch}, {seq}, {heads}, {hd}) kv {kv} causal bf16',
           'sdpa_bwd_ms': cs.time_ms(lambda: torch.autograd.grad(
               lib_out, (qt, kt, vt), lib_do, retain_graph=True))}
    for name, fn, plain, nbytes, flops in (
            ('dq', lambda: at.flash_attention_dq(q, k, v, do, lse, delta),
             lambda: at._flash_attention_dq_plain(q, k, v, do, lse, delta),
             3 * qb + 2 * kb + 2 * sb, 6 * hd * pairs),
            ('dkv', lambda: at.flash_attention_dkv(q, k, v, do, lse, delta),
             lambda: at._flash_attention_dkv_plain(q, k, v, do, lse, delta),
             2 * qb + 4 * kb + 2 * sb, 8 * hd * pairs)):
        ms = cs.time_ms(fn)
        b_ms, by = cs.bound(nbytes, flops, cs.BF16_FLOPS)
        out[name] = {'ms': ms, 'tflops': flops / ms / 1e9,
                     'plain_ms': cs.time_ms(plain, 3), 'bound_ms': b_ms,
                     'bound_by': by}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--time-only', action='store_true')
    parser.add_argument('--root', default=HERE,
                        help='checkout whose skypilot_tpu_torch to import')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_flash_bwd_bench: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from skypilot_tpu_torch.ops import _kernels, attention as at
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    start = time.perf_counter()
    _kernels.LIBRARY.get()
    cs.log(f'{at.__file__}: built in {time.perf_counter() - start:.1f} s; '
           f'{card}')
    ptxas = {n: i for n, i in cs.ptxas_report(
        _kernels.LIBRARY.build_log).items() if 'flash_bwd' in n}
    for name, info in sorted(ptxas.items()):
        cs.log(f'  ptxas {name}: {info}')
    lib = _kernels.LIBRARY.get()
    routes = {hd: lib.skk_flash_bwd_route(1, hd) for hd in (64, 128, 256)}
    cs.log(f'  skk_flash_bwd_route(bf16, hd): {routes}')
    gen = torch.Generator(device='cuda').manual_seed(23)
    result = {'root': os.path.abspath(args.root), 'card': card,
              'bf16_routes': routes, 'ptxas': ptxas}
    if not args.time_only:
        result['checked'] = check(at, gen)
    for label, shape in TIMED:
        result[label] = time_shape(at, gen, shape)
        cs.log(f'  {label}: {json.dumps(result[label])}')
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
