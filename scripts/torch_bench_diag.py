"""Two measurements behind numbers of the port's bench, on the card.

spec: why bench_spec's spec-on tokens can differ from spec-off's in bf16.
  LLAMA_1B at bench_spec's shapes (8 slots, 32-token prompts from
  RandomState(0), the bench's seed-0 weights), in bf16 and in f32.  From
  one pooled arena it runs, step after step, the plain decode step
  (decode_step_pooled: 8 rows through every product, K1) and, on copies
  of the same arena, the verify window (decode_verify_pooled at W 13: 104
  rows, K4) and a one-row window (W 1: 8 rows, K4), and compares their
  logits for the same token at the same position.  Then the pieces alone:
  every dense product of layer 0 and the lm_head at 8 rows against the
  same 8 rows inside 104 (and 1 row alone), K3 at 8 against 104 rows,
  and K4's row 0 at W 13 and W 1 against K1 on the model's layer-0
  arena.
decode: bench.bench_decode as the bench runs it, with every batcher
  tick recorded (spans on or off, queue, wall and event seconds, graph
  captures and replays, garbage-collector seconds).
spans: what the spans-on arm of bench_decode measures.  The steady
  decode arm (LLAMA_1B, 16 slots, prompt 64, 256 new, chunk 128) as
  bench_decode's steady_tok_s runs it, in the order off, on, off, on
  (a new batcher each), then one batcher timed off and then on; every
  tick's seconds, its queue length before it, and the graph captures
  and replays it made.

Run: python3 scripts/torch_bench_diag.py [--parts spec,decode,spans]
[--out chiprun_out/bench_diag.json].  Prints one JSON line a part and
writes all of it to --out.  Needs the card.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from skypilot_tpu_torch import bench  # noqa: E402


def _diff(a, b):
    a, b = a.float(), b.float()
    return {'max_abs': float((a - b).abs().max()),
            'elems_differing': int((a != b).sum()),
            'elems': a.numel()}


def _top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _clone(arena):
    return {k: v.clone() for k, v in arena.items()}


def spec_numerics(dtype, dev, config, steps=8):
    from skypilot_tpu_torch.infer import block_pool, llama_infer, quant
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.ops import rmsnorm

    config = dataclasses.replace(config, dtype=dtype)
    params = bench._init_params(config, dev)
    slots, prompt_len, win, bs, t_width = 8, 32, 13, 64, 8
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, config.vocab_size, (slots, prompt_len))
    arena = block_pool.init_arena(config, 1 + slots * t_width, bs,
                                  device=dev)
    tables = torch.arange(1, 1 + slots * t_width, dtype=torch.int32,
                          device=dev).reshape(slots, t_width)
    out = {'dtype': str(dtype).split('.')[-1], 'steps': []}
    with torch.no_grad():
        last = []
        for s in range(slots):
            h, _ = llama_infer.prefill_window_pooled(
                params, torch.as_tensor(prompts[s], device=dev), config,
                arena, tables[s], 0)
            last.append(h[-1])
        token = llama_infer.logits(torch.stack(last), params).argmax(-1)
        positions = torch.full((slots,), prompt_len, dtype=torch.int32,
                               device=dev)
        first_state = None
        for _ in range(steps):
            drafts = torch.as_tensor(
                rng.randint(1, config.vocab_size, (slots, win - 1)),
                device=dev)
            window = torch.cat([token[:, None], drafts], 1).int()
            if first_state is None:
                first_state = (_clone(arena), token.clone(),
                               positions.clone())
            a13, a1 = _clone(arena), _clone(arena)
            l13, _ = llama_infer.decode_verify_pooled(
                params, window, config, a13, positions, tables)
            l1, _ = llama_infer.decode_verify_pooled(
                params, window[:, :1], config, a1, positions, tables)
            ls, _ = llama_infer.decode_step_pooled(
                params, token.int(), config, arena, positions, tables)
            gap = _top2_gap(ls)
            d13 = _diff(ls, l13[:, 0])
            step = {
                'step_vs_verify13': d13,
                'step_vs_verify1': _diff(ls, l1[:, 0]),
                'verify1_vs_verify13': _diff(l1[:, 0], l13[:, 0]),
                'argmax_equal_step_verify13': int(
                    (ls.argmax(-1) == l13[:, 0].argmax(-1)).sum()),
                'max_abs_logit': float(ls.abs().max()),
                'top2_gap_min': float(gap.min()),
                'top2_gap_median': float(gap.median()),
                'rows_top2_gap_le_step_verify_diff': int(
                    (gap <= d13['max_abs']).sum()),
                'rows_top2_gap_zero': int((gap == 0).sum()),
            }
            # The K/V rows each path wrote at `positions`, layers 0 and
            # last: the first product whose row count differs.
            blk = tables.long()[torch.arange(slots, device=dev),
                                positions.long() // bs]
            off = positions.long() % bs
            for layer in (0, config.n_layers - 1):
                step[f'k_row_layer{layer}_step_vs_verify13'] = _diff(
                    arena['k'][layer, blk, off], a13['k'][layer, blk, off])
                step[f'k_row_layer{layer}_step_vs_verify1'] = _diff(
                    arena['k'][layer, blk, off], a1['k'][layer, blk, off])
            out['steps'].append(step)
            token = ls.argmax(-1)
            positions = positions + 1
            del a13, a1

        # The pieces alone, on seeded inputs at the model's widths.
        gen = torch.Generator(device=dev).manual_seed(1)
        lp = llama.layer_params(params, 0)
        weights = {name: lp['attn'][name] for name in ('wq', 'wk', 'wv',
                                                       'wo')}
        weights.update({name: lp['mlp'][name] for name in (
            'w_gate', 'w_up', 'w_down')})
        weights['lm_head'] = params['lm_head']
        gemm = {}
        for name, w in weights.items():
            x = torch.randn(slots * win, w.shape[0], generator=gen,
                            device=dev).to(dtype)
            y8 = quant.matmul(x[:slots], w)
            y104 = quant.matmul(x, w)[:slots]
            y1 = torch.cat([quant.matmul(x[i:i + 1], w)
                            for i in range(slots)])
            gemm[name] = {'shape': list(w.shape),
                          'rows8_vs_rows104': _diff(y8, y104),
                          'rows8_vs_rows1': _diff(y8, y1)}
        out['products'] = gemm
        x = torch.randn(slots * win, config.d_model, generator=gen,
                        device=dev).to(dtype)
        out['rms_norm_rows8_vs_rows104'] = _diff(
            rmsnorm.rms_norm(x[:slots], lp['ln1'], eps=config.norm_eps),
            rmsnorm.rms_norm(x, lp['ln1'], eps=config.norm_eps)[:slots])
        arena0, token0, pos0 = first_state
        q = torch.randn(slots, win, config.n_kv_heads,
                        config.n_heads // config.n_kv_heads,
                        config.head_dim, generator=gen,
                        device=dev).to(dtype)
        o13 = da.decode_window_attention_pooled(
            q, arena0['k'], arena0['v'], tables, 0, pos0, None, None)
        o1 = da.decode_window_attention_pooled(
            q[:, :1].contiguous(), arena0['k'], arena0['v'], tables, 0,
            pos0, None, None)
        o_k1 = da.decode_attention_pooled(
            q[:, 0].contiguous(), arena0['k'], arena0['v'], tables, 0,
            pos0, None, None)
        out['attention'] = {'k4_w13_row0_vs_k1': _diff(o13[:, 0], o_k1),
                            'k4_w1_vs_k1': _diff(o1[:, 0], o_k1),
                            'k4_w13_row0_vs_w1': _diff(o13[:, 0], o1[:, 0])}
    del params, arena
    bench._release(dev)
    return out


def span_arms(dev, config, slots=16, prompt_len=64, max_new=256,
              chunk=128):
    import statistics

    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.telemetry import spans as spans_lib

    params = bench._init_params(config, dev)
    base = GeneratorConfig(max_seq_len=prompt_len + max_new + 1,
                           batch_size=slots, temperature=0.0,
                           prompt_buckets=[prompt_len])
    prompts = [[(7 * (i + 1)) % config.vocab_size] * prompt_len
               for i in range(slots)]

    def run_batch(batcher, ticks=None):
        rids = [batcher.submit(p, max_new_tokens=max_new) for p in prompts]
        while batcher.num_queued or batcher.num_active:
            queued = batcher.num_queued
            graphs = batcher.graphs
            c0, r0 = ((graphs.captures, graphs.replays) if graphs
                      else (0, 0))
            t0 = bench._now(dev)
            batcher.step()
            dt = bench._now(dev) - t0
            if ticks is not None:
                ticks.append({'queued_before': queued,
                              'seconds': round(dt, 5),
                              'captures': (graphs.captures - c0
                                           if graphs else 0),
                              'replays': (graphs.replays - r0
                                          if graphs else 0)})
        for r in rids:
            batcher.result(r)

    def timed(batcher):
        ticks = []
        run_batch(batcher, ticks)
        pure = [t['seconds'] for t in ticks if t['queued_before'] == 0]
        return {'ticks': ticks,
                'steady_tok_s': (round(slots * chunk
                                       / statistics.median(pure), 1)
                                 if pure else None)}

    out = {'fresh_batchers': []}
    try:
        for on in (False, True, False, True):
            spans_lib.set_enabled(on)
            batcher = ContinuousBatcher(params, config, base,
                                        decode_chunk=chunk, device=dev)
            try:
                run_batch(batcher)
                arm = timed(batcher)
            finally:
                batcher.close()
            arm['spans'] = on
            out['fresh_batchers'].append(arm)
            spans_lib.default_buffer().clear()
        spans_lib.set_enabled(False)
        batcher = ContinuousBatcher(params, config, base,
                                    decode_chunk=chunk, device=dev)
        try:
            run_batch(batcher)
            off = timed(batcher)
            spans_lib.set_enabled(True)
            on = timed(batcher)
        finally:
            batcher.close()
        out['one_batcher'] = {'off': off, 'on': on}
    finally:
        spans_lib.set_enabled(None)
        spans_lib.default_buffer().clear()
    del params
    bench._release(dev)
    return out


def decode_ticks(dev):
    """bench.bench_decode as the bench runs it, every batcher tick
    recorded: the batcher's config, whether spans were on, the queue
    before the tick, its wall seconds (synchronized), the device time
    between CUDA events around it, the graph captures and replays it
    made, and the seconds Python's garbage collector ran inside it."""
    import gc

    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.telemetry import spans as spans_lib

    batchers = {}
    collecting = {'t0': None, 'seconds': 0.0}

    def on_gc(phase, info):
        if phase == 'start':
            collecting['t0'] = time.perf_counter()
        elif collecting['t0'] is not None:
            collecting['seconds'] += time.perf_counter() - collecting['t0']
            collecting['t0'] = None

    orig_step = ContinuousBatcher.step

    def step(self):
        ticks = batchers.setdefault(id(self), {
            'kv': self.gen.kv_cache_dtype,
            'weights': self.gen.weights_dtype,
            'impl': self.gen.decode_impl, 'ticks': []})['ticks']
        graphs = self.graphs
        c0, r0 = (graphs.captures, graphs.replays) if graphs else (0, 0)
        queued = self.num_queued
        card = dev.type == 'cuda'
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        gc0 = collecting['seconds']
        t0 = bench._now(dev)
        if card:
            start.record()
        orig_step(self)
        if card:
            end.record()
        dt = bench._now(dev) - t0
        ticks.append({'spans': spans_lib.enabled(), 'queued_before': queued,
                      'seconds': round(dt, 5),
                      'event_ms': (round(start.elapsed_time(end), 3)
                                   if card else None),
                      'captures': graphs.captures - c0 if graphs else 0,
                      'replays': graphs.replays - r0 if graphs else 0,
                      'gc_seconds': round(collecting['seconds'] - gc0, 5)})

    gc.callbacks.append(on_gc)
    ContinuousBatcher.step = step
    try:
        out = bench.bench_decode(dev)
    finally:
        ContinuousBatcher.step = orig_step
        gc.callbacks.remove(on_gc)
    return {'span_overhead': out['span_overhead'],
            'steady': {v: out[v]['steady_decode_tok_s']
                       for v in ('bf16', 'int8_kv', 'int8_w_kv')},
            'batchers': list(batchers.values())}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--parts', default='spec,decode,spans')
    parser.add_argument('--device', default='cuda',
                        help="'cpu' runs LLAMA_DEBUG at small shapes (a "
                             "dry run of the script)")
    parser.add_argument('--out', default=os.path.join(
        HERE, 'chiprun_out', 'bench_diag.json'))
    args = parser.parse_args()
    from skypilot_tpu_torch.models import llama
    dev = torch.device(args.device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        print('torch_bench_diag: no CUDA device', file=sys.stderr)
        return 2
    small = dev.type == 'cpu'
    config = llama.LLAMA_DEBUG if small else llama.LLAMA_1B
    result = {'card': bench.card_line()}
    for part in args.parts.split(','):
        t0 = time.perf_counter()
        if part == 'spec':
            result['spec'] = [spec_numerics(dt, dev, config)
                              for dt in (torch.bfloat16, torch.float32)]
        elif part == 'decode':
            result['decode'] = decode_ticks(dev)
        elif part == 'spans':
            result['spans'] = (span_arms(dev, config, 2, 8, 16, 8) if small
                               else span_arms(dev, config))
        else:
            raise SystemExit(f'unknown part {part}')
        result[f'{part}_seconds'] = round(time.perf_counter() - t0, 1)
        print(part, json.dumps(result[part])[:20000], flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(result['card'])
    return 0


if __name__ == '__main__':
    sys.exit(main())
