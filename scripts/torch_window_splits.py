#!/usr/bin/env python3
"""K4's split policy on the card: the window attention
(ops/decode_attention.py::decode_window_attention_pooled) at
chip_smoke.py's phase 3 shapes (verify: B 8, W 13 at positions 0..2047;
the fused lane: B 1, W 264 from row 436; bf16 and int8 arenas) for
LLAMA3_8B (8 KV heads, G 4, hd 128), Gemma-7B (16 KV heads, G 1, hd 256)
and Gemma-2B's MQA (1 KV head, G 8, hd 256), with the splits that the
policy of _window_splits gives when it aims for 1, 2, 4 or 8 blocks an
SM (_WINDOW_BLOCKS_PER_SM).  Each
setting is first held to the plain version (chip_smoke.TOL), then timed
as a replayed CUDA graph
(chip_smoke.graph_ms: device time, L2 flushed before each replay).
Prints one JSON line per (shape, arena, target), the card's name and
power limit in each.

Run from the root of a checkout on a card:
    python3 scripts/torch_window_splits.py
"""
from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from skypilot_tpu_torch.ops import _kernels  # noqa: E402
from skypilot_tpu_torch.ops import decode_attention as da  # noqa: E402

TARGETS = (1, 2, 4, 8)


def main() -> int:
    if not torch.cuda.is_available():
        print('needs an NVIDIA card', file=sys.stderr)
        return 2
    card = cs.nvidia_smi_line()
    gen = torch.Generator(device='cuda').manual_seed(6)
    layer = 1
    shapes = (('verify', [0, cs.BS - 1, cs.BS, 2 * cs.BS + 5, 700, 1000,
                          1500, cs.T_WIDTH * cs.BS - 1], 13),
              ('fused', [436], 264))
    default = da._WINDOW_BLOCKS_PER_SM
    configs = (('LLAMA3_8B', cs.KV_HEADS, cs.GROUP, cs.HEAD_DIM),) + tuple(
        (tag, kv, group, 256) for tag, kv, group in cs.WINDOW_HD256)
    try:
        for (config, kv_heads, group, head_dim), (lane, pos_list, win) in (
                (c, s) for c in configs for s in shapes):
            batch = len(pos_list)
            n_blocks = 1 + batch * cs.T_WIDTH
            positions = torch.tensor(pos_list, dtype=torch.int32,
                                     device='cuda')
            tables = cs._tables([p + win - 1 for p in pos_list], n_blocks, 6)
            for label, int8 in (('bf16', False), ('int8', True)):
                q = torch.randn(batch, win, kv_heads, group, head_dim,
                                generator=gen,
                                device='cuda').to(torch.bfloat16)
                k, v, ks, vs = cs._arena(gen, torch.bfloat16, n_blocks, int8,
                                         kv_heads, head_dim)

                def kernel():
                    return da.decode_window_attention_pooled(
                        q, k, v, tables, layer, positions, ks, vs)

                want = da._decode_window_attention_plain(
                    q, k, v, tables, layer, positions, ks, vs)
                for target in TARGETS:
                    da._WINDOW_BLOCKS_PER_SM = target
                    da._decode_splits.cache_clear()
                    da._window_splits.cache_clear()
                    splits, split_len = da._window_splits(
                        batch, kv_heads,
                        -(-win * group // da._WINDOW_ROWS[head_dim]),
                        cs.T_WIDTH * cs.BS, da._WINDOW_CHUNK,
                        _kernels.sm_count(torch.device('cuda')))
                    err = cs.check_close(
                        f'{config} {lane} {label} target {target}',
                        kernel(), want)
                    print(json.dumps({
                        'card': card, 'config': config, 'shape': lane,
                        'arena': label,
                        'blocks_per_sm': target, 'splits': splits,
                        'split_len': split_len, 'max_abs_err': err,
                        'graph_ms': cs.graph_ms(kernel)}), flush=True)
    finally:
        da._WINDOW_BLOCKS_PER_SM = default
        da._decode_splits.cache_clear()
        da._window_splits.cache_clear()
    return 0


if __name__ == '__main__':
    sys.exit(main())
