#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (skypilot_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: needs torch.cuda; prints the card's name and power limit.
2. build: compiles skypilot_tpu_torch/csrc/*.cu with nvcc (in parallel)
   into build/torch_kernels/ and loads the library.
3. kernels: holds each hand-written kernel against its plain PyTorch
   version on the card, at the shapes the Llama-3-8B serving path gives
   it, in bf16 and f32; times kernel, plain version and one PyTorch
   library call (CUDA events, median of 25, L2 flushed before each), and
   computes each kernel's bound from the bytes and operations of this
   run's inputs.
4. slice parity: a 2-layer LLAMA_DEBUG model in f32 served on the card
   (kernels) and on the host (plain versions) from the same weights:
   identical greedy tokens, allclose first-step logits.
5. main path: random LLAMA3_8B bf16 weights on the card behind the HTTP
   replica (ContinuousBatcher, batch 8, max_seq_len 2048, prefill_chunk
   256, decode_chunk 16); 8 requests of 17..700 prompt tokens, 48 new
   tokens each, greedy.  Every kernel's launch count on this phase must
   be > 0.

The last lines of standard output are the {"kernels": [...]} line, the
nvidia-smi name/power-limit line, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16 peak
TIMING_REPS = 25
# Tolerances of kernel vs plain version, (atol, rtol).  f32: both sides
# compute in f32 and differ only in summation order.  bf16: the plain
# versions round scores (flash) or probabilities (both attentions) to
# bf16 where the kernels keep f32, and every output is rounded to bf16
# (one ulp is 2^-8 relative), so the bound is a few bf16 ulps.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 2e-2)}
# Slice parity in f32: sums taken in another order across 2 layers.
LOGITS_TOL = (2e-4, 1e-4)

CARD = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


# ---- timing ---------------------------------------------------------------

_FLUSH = None


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of fn() in ms, each call after an L2 flush
    (the serving path finds its operands cold in HBM)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device='cuda')
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    atol, rtol = TOL[ref.dtype]
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise AssertionError(f'{name}: non-finite kernel output')
    err = (o - r).abs()
    excess = (err - (atol + rtol * r.abs())).max().item()
    max_err = err.max().item()
    log(f'  {name}: max_abs_err={max_err:.3e} (atol={atol} rtol={rtol})')
    if excess > 0:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (max_abs_err {max_err:.3e})')
    return max_err


def sdpa(q, k, v, **kw):
    """scaled_dot_product_attention, the yardstick of both attentions."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=k.shape[1] != q.shape[1], **kw)


# ---- phase 3: kernels -----------------------------------------------------

def check_rmsnorm(rmsnorm):
    gen = torch.Generator(device='cuda').manual_seed(3)
    d = 4096
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (8, 2048, 5):
            x = torch.randn(rows, d, generator=gen, device='cuda').to(dtype)
            w = (1 + 0.1 * torch.randn(d, generator=gen, device='cuda')
                 ).to(dtype)
            err = check_close(f'rms_norm {dtype} rows={rows}',
                              rmsnorm.rms_norm(x, w, 1e-5),
                              rmsnorm._rms_norm_plain(x, w, 1e-5))
            if dtype == torch.bfloat16 and rows == 2048:
                nbytes = 2 * x.numel() * 2 + d * 2
                b_ms, by = bound(nbytes, 4 * x.numel(), BF16_FLOPS)
                result = {
                    'name': 'rms_norm', 'route': 'cuda',
                    'source': 'skypilot_tpu_torch/csrc/rmsnorm.cu',
                    'replaces': 'skypilot_tpu/ops/rmsnorm.py:31',
                    'shape': f'x ({rows}, {d}) bf16',
                    'max_abs_err': err,
                    'ms': time_ms(lambda: rmsnorm.rms_norm(x, w, 1e-5)),
                    'plain_ms': time_ms(
                        lambda: rmsnorm._rms_norm_plain(x, w, 1e-5)),
                    'bound_ms': b_ms, 'bound_by': by,
                    'library_ms': time_ms(
                        lambda: torch.nn.functional.rms_norm(
                            x, (d,), w, 1e-5)),
                }
    return result


def check_flash(attention):
    gen = torch.Generator(device='cuda').manual_seed(4)
    heads, kv_heads, hd = 32, 8, 128
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, causal in ((4, 512, True), (1, 700, True),
                                   (1, 700, False), (2, 64, True)):
            q = torch.randn(batch, seq, heads, hd, generator=gen,
                            device='cuda').to(dtype)
            k = torch.randn(batch, seq, kv_heads, hd, generator=gen,
                            device='cuda').to(dtype)
            v = torch.randn(batch, seq, kv_heads, hd, generator=gen,
                            device='cuda').to(dtype)
            err = check_close(
                f'flash_attention {dtype} B={batch} S={seq} '
                f'causal={causal}',
                attention.flash_attention(q, k, v, causal=causal),
                attention._attention_plain(q, k, v, causal=causal))
            if dtype == torch.bfloat16 and seq == 512:
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
                pairs = batch * heads * seq * (seq + 1) // 2
                b_ms, by = bound(nbytes, 4 * hd * pairs, BF16_FLOPS)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                result = {
                    'name': 'flash_attention', 'route': 'cuda',
                    'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
                    'replaces': 'skypilot_tpu/ops/attention.py:120',
                    'shape': f'q ({batch}, {seq}, {heads}, {hd}) kv '
                             f'{kv_heads} causal bf16',
                    'max_abs_err': err,
                    'ms': time_ms(
                        lambda: attention.flash_attention(q, k, v)),
                    'plain_ms': time_ms(
                        lambda: attention._attention_plain(q, k, v)),
                    'bound_ms': b_ms, 'bound_by': by,
                    'library_ms': time_ms(
                        lambda: sdpa(qt, kt, vt, is_causal=True)),
                }
    return result


def check_decode(decode_attention):
    gen = torch.Generator(device='cuda').manual_seed(5)
    batch, kv_heads, group, hd, bs, t_width = 8, 8, 4, 128, 64, 32
    n_layers, n_blocks, layer = 2, 1 + batch * t_width, 1
    # Mixed positions: 0, block edges (BS-1, BS), mid, and the table end.
    positions = torch.tensor([0, bs - 1, bs, 2 * bs + 5, 700, 1000,
                              1500, t_width * bs - 1], dtype=torch.int32,
                             device='cuda')
    rng = np.random.RandomState(5)
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((batch, t_width), np.int32)
    for b in range(batch):
        live = int(positions[b]) // bs + 1
        tables[b, :live] = perm[b * t_width:b * t_width + live]
    tables = torch.as_tensor(tables, device='cuda')
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(batch, kv_heads, group, hd, generator=gen,
                        device='cuda').to(dtype)
        shape = (n_layers, n_blocks, bs, kv_heads, hd)
        k = torch.randn(shape, generator=gen, device='cuda').to(dtype)
        v = torch.randn(shape, generator=gen, device='cuda').to(dtype)

        def kernel():
            return decode_attention.decode_attention_pooled(
                q, k, v, tables, layer, positions)

        def plain():
            return decode_attention._decode_attention_plain(
                q, k, v, tables, layer, positions)

        err = check_close(f'decode_attention_pooled {dtype}', kernel(),
                          plain())
        # Poisoned rows past each position and unmapped blocks must not
        # change the kernel's output.
        k2, v2 = k.clone(), v.clone()
        mapped = set(tables.flatten().tolist()) - {0}
        for blk in range(n_blocks):
            if blk not in mapped:
                k2[:, blk] = 1e4
                v2[:, blk] = -1e4
        for b in range(batch):
            p = int(positions[b])
            blk = int(tables[b, p // bs])
            k2[layer, blk, p % bs + 1:] = 1e4
            v2[layer, blk, p % bs + 1:] = -1e4
        poisoned = decode_attention.decode_attention_pooled(
            q, k2, v2, tables, layer, positions)
        if not torch.equal(poisoned, kernel()):
            raise AssertionError('decode_attention_pooled read keys past '
                                 'a position or outside its table')
        if dtype == torch.bfloat16:
            live_keys = int(torch.clamp_max(positions.long() + 1,
                                            t_width * bs).sum())
            nbytes = (2 * q.numel() * 2 + 2 * live_keys * kv_heads * hd * 2
                      + tables.numel() * 4 + batch * 4)
            b_ms, by = bound(nbytes, 4 * hd * kv_heads * group * live_keys,
                             BF16_FLOPS)
            k_g = decode_attention._gather_layer(k, tables, layer)
            v_g = decode_attention._gather_layer(v, tables, layer)
            qs = q.reshape(batch, kv_heads * group, 1, hd)
            ks, vs = k_g.transpose(1, 2), v_g.transpose(1, 2)
            mask = (torch.arange(k_g.shape[1], device='cuda')[None, :]
                    <= positions.long()[:, None])[:, None, None, :]
            result = {
                'name': 'decode_attention_pooled', 'route': 'cuda',
                'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
                'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
                'shape': f'q ({batch}, {kv_heads}, {group}, {hd}) '
                         f'BS {bs} T {t_width} live keys {live_keys} bf16',
                'max_abs_err': err, 'ms': time_ms(kernel),
                'plain_ms': time_ms(plain), 'bound_ms': b_ms,
                'bound_by': by,
                'library_ms': time_ms(lambda: sdpa(qs, ks, vs,
                                                   attn_mask=mask)),
            }
    return result


# ---- phase 4: slice parity ------------------------------------------------

def slice_parity():
    from skypilot_tpu_torch.infer import llama_infer
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA_DEBUG
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   'cpu')
    params_gpu = _to_device(params_cpu, 'cuda')
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (5, 40, 100, 17)]
    budgets = [12, 9, 7, 10]

    tokens = np.zeros((2, 64), np.int64)
    tokens[0, :40] = prompts[1]
    tokens[1, :17] = prompts[3]
    lengths = np.asarray([40, 17], np.int32)
    logits = {}
    for dev, params in (('cpu', params_cpu), ('cuda', params_gpu)):
        cache = llama_infer.init_cache(cfg, 2, 64, device=dev)
        logits[dev], _ = llama_infer.prefill(
            params, torch.as_tensor(tokens, device=dev), cfg, cache,
            torch.as_tensor(lengths, device=dev))
    atol, rtol = LOGITS_TOL
    lerr = (logits['cuda'].cpu() - logits['cpu']).abs().max().item()
    log(f'  prefill logits max_abs_err={lerr:.3e} (atol={atol} '
        f'rtol={rtol})')
    torch.testing.assert_close(logits['cuda'].cpu(), logits['cpu'],
                               atol=atol, rtol=rtol)

    outs = {}
    for dev, params in (('cpu', params_cpu), ('cuda', params_gpu)):
        b = ContinuousBatcher(params, cfg, GeneratorConfig(
            max_seq_len=256, batch_size=3, prompt_buckets=[16, 64, 128],
            prefill_chunk=64, kv_block_size=16), decode_chunk=4,
            device=dev)
        rids = [b.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        b.run_until_idle()
        b.pool.check_invariant()
        outs[dev] = [b.result(r) for r in rids]
    if outs['cpu'] != outs['cuda']:
        raise AssertionError(f'greedy tokens differ: card {outs["cuda"]} '
                             f'host {outs["cpu"]}')
    log(f'  greedy tokens identical on card and host '
        f'({sum(len(o) for o in outs["cpu"])} tokens)')


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---- phase 5: main path ---------------------------------------------------

def main_path(counters):
    from skypilot_tpu_torch.infer import engine, replica
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA3_8B
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    torch.cuda.synchronize()
    log(f'  LLAMA3_8B bf16 random weights: {cfg.num_params() / 1e9:.2f}B '
        f'params in {time.perf_counter() - t0:.1f} s')
    batcher = ContinuousBatcher(params, cfg, GeneratorConfig(
        max_seq_len=2048, batch_size=8, prefill_chunk=256),
        decode_chunk=16, device='cuda')
    # Warm-up (cuBLAS handles, allocator pools), then count from zero.
    warm = batcher.submit([1, 2, 3], max_new_tokens=2)
    batcher.run_until_idle()
    batcher.result(warm)
    batcher.decode_tokens, batcher.decode_seconds = 0, 0.0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    server, thread = replica.serve(batcher, '127.0.0.1', 0, 'llama3-8b')
    url = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        with urllib.request.urlopen(f'{url}/health', timeout=30) as r:
            health = json.loads(r.read())
        assert health['status'] == 'ok', health
        rng = np.random.RandomState(2)
        lengths = [17, 60, 128, 250, 300, 450, 600, 700]
        prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
                   for n in lengths]
        max_new = 48
        responses = [None] * len(prompts)

        def send(i):
            body = json.dumps({'prompt_ids': prompts[i],
                               'max_new_tokens': max_new}).encode()
            req = urllib.request.Request(
                f'{url}/generate', data=body,
                headers={'Content-Type': 'application/json'})
            with urllib.request.urlopen(req, timeout=600) as r:
                responses[i] = json.loads(r.read())

        for c in counters:
            c.launches = 0
        syncs0 = engine.host_fetch.calls
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        syncs = engine.host_fetch.calls - syncs0
    finally:
        replica.shutdown_replica(server, thread)
    for i, resp in enumerate(responses):
        if resp is None or resp.get('num_generated') != max_new:
            raise AssertionError(f'request {i} (prompt {lengths[i]}): '
                                 f'{resp}')
        if not all(0 <= t < cfg.vocab_size for t in resp['output_ids']):
            raise AssertionError(f'request {i}: token out of range')
    batcher.pool.check_invariant()
    st = batcher.pool.stats()
    if st['blocks_live'] or st['reserved']:
        raise AssertionError(f'pool not returned: {st}')
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f'{name} was never launched on the main '
                                 f'path')
    ttfts = sorted(r['ttft_s'] for r in responses)
    stats = {
        'card': CARD['line'],
        'requests': len(responses),
        'prompt_tokens': sum(lengths),
        'generated_tokens': sum(r['num_generated'] for r in responses),
        'wall_s': wall,
        'ttft_s_median': statistics.median(ttfts),
        'ttft_s_max': ttfts[-1],
        'decode_tokens_per_s': batcher.decode_tokens
        / batcher.decode_seconds,
        'decode_tokens': batcher.decode_tokens,
        'decode_seconds': batcher.decode_seconds,
        'host_fetches': syncs,
        'resident_gb_before_requests': weights_gb,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        'launches': launches,
    }
    log('  main path: ' + json.dumps(stats))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run '
              'needs an NVIDIA card', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import _kernels, attention, decode_attention
    from skypilot_tpu_torch.ops import rmsnorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD['line'] = nvidia_smi_line()
    CARD['kind'] = torch.cuda.get_device_name(0)
    log(f'[1/5] device: {CARD["line"]} | torch {torch.__version__} '
        f'cuda {torch.version.cuda}')

    log('[2/5] build')
    _kernels.LIBRARY.get()
    log(f'  built {_kernels.LIBRARY.path.name} in '
        f'{_kernels.LIBRARY.build_seconds:.1f} s')
    (_kernels.BUILD_DIR / 'build.log').write_text(_kernels.LIBRARY.build_log)
    for line in _kernels.LIBRARY.build_log.splitlines():
        if 'spill' in line and ' 0 bytes spill stores' not in line:
            log(f'  ptxas: {line.strip()}')

    log('[3/5] kernels vs plain versions')
    results = [check_decode(decode_attention), check_flash(attention),
               check_rmsnorm(rmsnorm)]
    counters = [decode_attention.decode_attention_pooled,
                attention.flash_attention, rmsnorm.rms_norm]
    log('[4/5] slice parity, LLAMA_DEBUG f32, card vs host')
    slice_parity()

    log('[5/5] main path, LLAMA3_8B bf16 behind the HTTP replica')
    launches = main_path(counters)
    for res, counter in zip(results, counters):
        res['launches'] = launches[counter.__name__]
    log(json.dumps({'kernels': results}))
    log(CARD['line'])
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': CARD['kind'],
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
