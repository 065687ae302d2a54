#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (skypilot_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: needs torch.cuda; prints the card's name and power limit.
2. build: compiles skypilot_tpu_torch/csrc/*.cu with nvcc (in parallel)
   into build/torch_kernels/ and loads the library; fails if ptxas
   reports a spill in a tensor-core kernel (K2, K4, K5 and K6 in bf16,
   hd 64 and 128) or in a K1/K7 decode kernel or a combine kernel (K1/K7
   and K4).
3. kernels: holds each hand-written kernel against its plain PyTorch
   version on the card, at the shapes the Llama-3-8B serving path gives
   it, in bf16 and f32 (and int8 arenas for the two paged attentions);
   times kernel, plain version and one PyTorch library call (CUDA events,
   median of 25, L2 flushed before each), and computes each kernel's
   bound from the bytes and operations of this run's inputs.  The paged
   kernels are also run on arenas poisoned past each window and outside
   the tables, and K7 (the contiguous decode, q (8, 8, 4, 128) over the
   1024-row bucket) on caches poisoned past each position, which must
   not change their output.  K1 and K7 take their split-KV route there
   (and on every main path): K1 is also timed with one slot at position
   8191 (T 128, LLAMA3_8B's max_seq_len), both (and their SDPA
   yardstick) are also timed as a replayed CUDA graph (device time
   without the wrapper's host work), and the combine pass alone is held
   to _combine_splits_plain on the partials of K1's bf16 launch and
   timed.  K4 (the window attention) takes its tensor-core route in bf16
   and over an int8 arena (the FMA route in f32), split-KV at both of
   its shapes: checked twice (bitwise), timed eager and as a replayed
   graph beside SDPA's, and its combine pass alone held to
   _combine_splits_plain on the partials of the verify bf16 launch.
   K2 (o, and its lse) is held to
   _flash_fwd_plain, its own numerics, and to _attention_plain, the JAX
   reference_attention's, at the prefill shape and ragged S.  The
   training kernels (K2 with its lse, K5 dq, K6 dk/dv) are held to their
   plain versions in bf16 and f32 at the LLAMA_1B training shape (8,
   1024, 16/8 heads, 128) and a ragged S, and in bf16 at the 8B trunk's
   (2, 4096, 32/8, 128), and timed at both train shapes; their library
   call is SDPA's forward with grad, and its backward (one time for dq,
   dk and dv) for K5 and K6.  The entries of K2, K5 and K6 carry their
   design, TFLOP/s and the ptxas registers and spill of the
   instantiation timed.
4. slice parity: a 2-layer LLAMA_DEBUG model in f32 served on the host
   (plain versions), on the card eagerly (graphs=False) and on the card
   through the engines' CUDA graphs (the default) from the same weights:
   identical greedy tokens on all three (plain, spec_k=3, fuse_budget,
   int8 KV and weights; the legacy batcher planes 'paged', 'inplace' and
   'paged' with int8 KV; the Generator on the pooled plane, with
   spec_k=3, and on 'paged', which stays eager), each graph key captured
   once and chunks replayed; allclose first-step logits; spec_k=3, the
   fused schedule, the legacy planes and the Generator give the plain
   schedule's tokens (int8 KV aside).  Training parity on the same model:
   first-step gradients under remat False, True and 'dots' on card and
   host, and 3 Trainer steps (loss, grad_norm) on both.
5. main path: random LLAMA3_8B bf16 weights on the card behind the HTTP
   replica (ContinuousBatcher, batch 8, max_seq_len 2048, prefill_chunk
   256, decode_chunk 16); 8 requests of 17..700 prompt tokens, 48 new
   tokens each, greedy, sent as one burst admitted in a fixed order;
   served first eagerly (graphs=False), then through the batcher's CUDA
   graphs (the main path): identical greedy tokens.  Each run prints
   decode tokens/s, graph captures, capture seconds (inside
   decode_seconds), replays and the live share of the decode chunks'
   slot-steps.
6. main path with speculative verify and fused steps, twice on phase 5's
   weights: (a) bf16 with spec_k 12 and fuse_budget 264, (b) the same
   with int8 KV and int8 weights.  The same 8 requests.
7. the legacy decode_impl='paged' plane (K7 over the bucketed slot
   cache) on phase 5's weights: the same 8 requests behind the replica
   (a) in bf16 and (b) with int8 KV, and (c) one Generator.generate of
   the 8 prompts.  K1 must not launch; the slot cache must grow, and
   shrink back to its smallest bucket for a short request afterwards.
   Prints TTFT, decode tokens/s, migrations and memory.
8. train path: Trainer(loss_fn, params, config).fit on random bf16
   weights, remat 'dots', chunked CE: (a) LLAMA_1B at the reference
   bench's settings (8 x 1024 tokens, loss_chunk 256, 12 steps, warmup 2
   of 12), (b) LLAMA3_8B's widths at depth 2 (2 x 4096 tokens,
   loss_chunk 512, 6 steps).  Prints step time, tokens/s, MFU against
   989e12 (6N with and without the embedding), first and last loss, peak
   memory and launches per step.

Every kernel of a main-path run must launch > 0 times in that run (the
counts are set to 0 just before it and read just after; a replayed graph
adds the launches its capture recorded, engine.ChunkGraphs); the window
kernel must launch from both verify and fused ticks, K7 (and never K1)
on every phase 7 path, and K2, K3, K5 and K6 from both train paths; K2,
K5 and K6 only on their tensor-core route, on every path of phases 5 to
8 (all bf16 at head_dim 128), and K4 on phase 6's paths, where it must
also take its split route; K1 and K7 only on their split route on every
path of phases 5 to 7 (B KV = 64 < 2 x 132 SMs).  The last lines
of standard output are
the {"kernels": [...]} line, the nvidia-smi name/power-limit line, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16 peak
TIMING_REPS = 25
# Tolerances of kernel vs plain version, (atol, rtol), by q's dtype.
# f32: both sides compute in f32 and differ only in summation order.
# bf16: the plain versions round scores (flash) or probabilities (all
# attentions) to bf16 where the kernels keep f32, and every output is
# rounded to bf16 (one ulp is 2^-8 relative), so the bound is a few bf16
# ulps.  An int8 arena takes its q dtype's tolerance: the kernels
# dequantize before each product, the plain versions scale after it.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 2e-2)}
# bf16 outputs whose plain version computes in f32 as the kernel does
# (the flash backward's dq, dk, dv; K7; K2's o against _flash_fwd_plain,
# where p is rounded to bf16 against the running max of a 64-key tile on
# the card and against the row's final max in the plain version: the
# same p up to one rounding each), elementwise: atol one bf16 ulp
# (2^-7) of the largest element of the same row (the row's elements
# share their sums' terms, so their f32 noise scales with it; a causal
# gradient's rows differ in scale by 50x), never below the f32
# summation-order atol (rows that cancel to ~0); rtol two ulps (2^-6):
# the f32 sums of both sides round to bf16 on either side of a boundary.
BF16_ROW_ULPS = (2 ** -7, 2 ** -6)
# Slice parity in f32: sums taken in another order across 2 layers (and,
# for int8, the scales applied before the product on the card and after
# it on the host).
LOGITS_TOL = (2e-4, 1e-4)
# Paged-attention shapes of the Llama-3-8B serving path (8 KV heads of
# G 4, head_dim 128, 64-row blocks, 32 blocks a slot at max_seq_len 2048).
KV_HEADS, GROUP, HEAD_DIM, BS, T_WIDTH = 8, 4, 128, 64, 32

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


def graph_ms(fn, reps: int = TIMING_REPS) -> float:
    """time_ms of fn() captured once in a CUDA graph and replayed: the
    device time of its kernels without the host work of its wrapper
    (which time_ms counts where the host is slower than the L2 flush).
    The capture fails if fn reads a device value on the host."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def ptxas_report(build_log: str):
    """Registers and spilled bytes (stores + loads) of each kernel
    instantiation, by mangled name, from nvcc's -Xptxas=-v output."""
    report, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = {'registers': None, 'spill_bytes': 0}
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            report[name]['spill_bytes'] += int(m.group(1)) + int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            report[name]['registers'] = int(m.group(1))
    return report


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor,
                tol=None) -> float:
    """Max abs error of out against ref; fails past atol + rtol |ref|
    (atol may be a tensor that broadcasts against ref)."""
    atol, rtol = tol or TOL[ref.dtype]
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise AssertionError(f'{name}: non-finite kernel output')
    err = (o - r).abs()
    excess = (err - (atol + rtol * r.abs())).max().item()
    max_err = err.max().item()
    if torch.is_tensor(atol):
        atol = f'{atol.min().item():.2e}..{atol.max().item():.2e}'
    log(f'  {name}: max_abs_err={max_err:.3e} (atol={atol} rtol={rtol})')
    if excess > 0:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (max_abs_err {max_err:.3e})')
    return max_err


def row_tol(ref: torch.Tensor):
    """(atol, rtol) of an output computed in f32 on both sides:
    BF16_ROW_ULPS in bf16, with atol a tensor of one value per row; TOL
    otherwise."""
    if ref.dtype != torch.bfloat16:
        return TOL[ref.dtype]
    ulp, rtol = BF16_ROW_ULPS
    row_max = ref.float().abs().amax(-1, keepdim=True)
    return torch.clamp_min(ulp * row_max, TOL[torch.float32][0]), rtol


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


def _tc_entry(ptxas, stem, design=None):
    """The design of a kernel (TC_DESIGN, the flash kernels', by default)
    and the ptxas registers and spill of its instantiation `stem` (a
    mangled-name fragment)."""
    found = [i for n, i in ptxas.items() if stem in n]
    if len(found) != 1:
        raise AssertionError(f'ptxas report has {len(found)} {stem}')
    return {'design': design or TC_DESIGN,
            'ptxas_registers': found[0]['registers'],
            'ptxas_spill_bytes': found[0]['spill_bytes']}


# Mangled-name patterns of the timed K1/K7 instantiations (bf16 q,
# head_dim 128, the 4-row block of group 4; the cache bf16 or int8, i.e.
# signed char 'a') and of the bf16 combine kernel.
DECODE_KERNELS = {
    ('pooled', 'bf16'): r'decode_kernelI13__nv_bfloat16S\w*?_Li128ELi4E\w*PooledRows',
    ('pooled', 'int8'): r'decode_kernelI13__nv_bfloat16aLi128ELi4E\w*PooledRows',
    ('contig', 'bf16'): r'decode_kernelI13__nv_bfloat16S\w*?_Li128ELi4E\w*ContigRows',
    ('contig', 'int8'): r'decode_kernelI13__nv_bfloat16aLi128ELi4E\w*ContigRows',
    'combine': r'decode_combine_kernelI13__nv_bfloat16E',
}


def _decode_ptxas(ptxas, key):
    """ptxas registers and spill of one K1/K7/combine instantiation (None
    where the report names none: the spill check of phase 2 covers every
    instantiation all the same)."""
    found = [i for n, i in ptxas.items()
             if re.search(DECODE_KERNELS[key], n)]
    if len(found) != 1:
        log(f'  ptxas report has {len(found)} {DECODE_KERNELS[key]}')
        return {'ptxas_registers': None, 'ptxas_spill_bytes': None}
    return {'ptxas_registers': found[0]['registers'],
            'ptxas_spill_bytes': found[0]['spill_bytes']}


def _check_fwd(at, q, k, v, causal, tag, need_lse=False):
    """K2's o (and lse) against _flash_fwd_plain (o per row in bf16,
    row_tol; lse f32) and against _attention_plain (o at TOL) and
    _attention_lse_plain.  Returns the max abs error against
    _flash_fwd_plain, o and lse."""
    if need_lse:
        o, lse = at.flash_attention_fwd(q, k, v, causal, need_lse=True)
    else:
        o, lse = at.flash_attention(q, k, v, causal=causal), None
    want, want_lse = at._flash_fwd_plain(q, k, v, causal)
    err = check_close(f'flash_attention o {tag}', o, want, row_tol(want))
    check_close(f'flash_attention o vs _attention_plain {tag}', o,
                at._attention_plain(q, k, v, causal))
    if lse is not None:
        err = max(err, check_close(f'flash_attention lse {tag}', lse,
                                   want_lse))
        check_close(f'flash_attention lse vs _attention_lse_plain {tag}',
                    lse, at._attention_lse_plain(q, k, causal))
    return err, o, lse


def check_flash(attention, ptxas):
    gen = torch.Generator(device='cuda').manual_seed(4)
    heads, kv_heads, hd = 32, 8, 128
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, causal in ((4, 512, True), (1, 700, True),
                                   (1, 700, False), (2, 64, True),
                                   (2, 1, True), (2, 63, False),
                                   (2, 65, True), (2, 129, False)):
            q = torch.randn(batch, seq, heads, hd, generator=gen,
                            device='cuda').to(dtype)
            k = torch.randn(batch, seq, kv_heads, hd, generator=gen,
                            device='cuda').to(dtype)
            v = torch.randn(batch, seq, kv_heads, hd, generator=gen,
                            device='cuda').to(dtype)
            err, _, _ = _check_fwd(attention, q, k, v, causal,
                                   f'{dtype} B={batch} S={seq} '
                                   f'causal={causal}')
            if dtype == torch.bfloat16 and seq == 512:
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
                pairs = batch * heads * seq * (seq + 1) // 2
                flops = 4 * hd * pairs
                b_ms, by = bound(nbytes, flops, BF16_FLOPS)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                ms = time_ms(lambda: attention.flash_attention(q, k, v))
                result = dict({
                    'name': 'flash_attention', 'route': 'cuda',
                    'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
                    'replaces': 'skypilot_tpu/ops/attention.py:120',
                    'shape': f'q ({batch}, {seq}, {heads}, {hd}) kv '
                             f'{kv_heads} causal bf16',
                    'max_abs_err': err, 'ms': ms,
                    'plain_ms': time_ms(
                        lambda: attention._flash_fwd_plain(q, k, v)),
                    'bound_ms': b_ms, 'bound_by': by,
                    'library_ms': time_ms(
                        lambda: sdpa(qt, kt, vt, is_causal=True)),
                    'tflops': flops / ms / 1e9,
                }, **_tc_entry(ptxas, TC_KERNELS['lse']))
    return result


# Attention shapes of the two train paths: (B, S, H, KV, head_dim).
TRAIN_SHAPES = {'1b': (8, 1024, 16, 8, 128), '8b': (2, 4096, 32, 8, 128)}


def _attn_operands(gen, batch, seq, heads, kv, hd, dtype):
    """q, k, v and an incoming gradient do, (B, S, H or KV, hd)."""
    return [torch.randn(batch, seq, h, hd, generator=gen,
                        device='cuda').to(dtype)
            for h in (heads, kv, kv, heads)]


def _check_train_kernels(at, q, k, v, do, causal, tag):
    """K2 with its lse (_check_fwd), K5 and K6 against their plain
    versions on the same inputs (o and lse from the kernel feed both
    backward sides).
    Returns the max abs errors by kernel (K2's over o and lse) and the
    kernels' outputs."""
    e_lse, o, lse = _check_fwd(at, q, k, v, causal, tag, need_lse=True)
    delta = at._delta(o, do).contiguous()
    want = at._flash_attention_dq_plain(q, k, v, do, lse, delta, causal)
    e_dq = check_close(
        f'flash_attention_dq {tag}',
        at.flash_attention_dq(q, k, v, do, lse, delta, causal), want,
        row_tol(want))
    del want
    got = at.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    want = at._flash_attention_dkv_plain(q, k, v, do, lse, delta, causal)
    e_dkv = max(check_close(f'flash_attention_dkv {n} {tag}', g, w,
                            row_tol(w))
                for n, g, w in zip(('dk', 'dv'), got, want))
    return {'lse': e_lse, 'dq': e_dq, 'dkv': e_dkv}, o, lse, delta


# The bf16 hd-128 route of K2, K5 and K6 (timed below): its design and
# the mangled-name stem of each instantiation in the ptxas report.
TC_DESIGN = 'mma.sync m16n8k16 bf16 -> f32, ldmatrix, cp.async x2'
TC_KERNELS = {'lse': 'flash_fwd_mma_kernelILi128E',
              'dq': 'flash_bwd_dq_mma_kernelILi128E',
              'dkv': 'flash_bwd_dkv_mma_kernelILi128E'}


def check_flash_train(attention, ptxas):
    """K2 with its lse, K5 and K6 against their plain versions in f32
    and bf16 at the LLAMA_1B shape and a ragged S; then, in bf16 and
    causal at both train shapes, checked again and timed.  Returns the
    kernels line entries by (kernel, shape), each with the error measured
    at its own shape, its TFLOP/s, the design and the ptxas registers and
    spill of the instantiation timed."""
    at = attention
    gen = torch.Generator(device='cuda').manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, causal in ((8, 1024, True), (2, 700, True),
                                   (2, 700, False)):
            q, k, v, do = _attn_operands(gen, batch, seq, 16, 8, 128, dtype)
            _check_train_kernels(at, q, k, v, do, causal,
                                 f'{dtype} B={batch} S={seq} causal={causal}')
            del q, k, v, do
    results = {}
    for key, (batch, seq, heads, kv, hd) in TRAIN_SHAPES.items():
        q, k, v, do = _attn_operands(gen, batch, seq, heads, kv, hd,
                                     torch.bfloat16)
        # At the 8B shape the plain versions hold several (2, 32, 4096,
        # 4096) f32 tensors, 4.3 GB each: they fit on the card at B 2.
        errs, o, lse, delta = _check_train_kernels(
            at, q, k, v, do, True,
            f'torch.bfloat16 B={batch} S={seq} H={heads} causal=True')
        pairs = batch * heads * seq * (seq + 1) // 2
        qb, kb, sb = q.numel() * 2, k.numel() * 2, lse.numel() * 4
        # Fewer repetitions of the plain versions at the 8B shape.
        plain_reps = 3 if seq > 2048 else TIMING_REPS
        shape = (f'q ({batch}, {seq}, {heads}, {hd}) kv {kv} causal bf16')
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))

        def lib_fwd():
            with torch.enable_grad():
                return sdpa(qt, kt, vt, is_causal=True)

        lib_out = lib_fwd()
        lib_do = do.transpose(1, 2)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), lib_do, retain_graph=True))
        rows = {
            'lse': ('flash_attention[lse]', 'flash_fwd.cu',
                    'skypilot_tpu/ops/attention.py:120',
                    lambda: at.flash_attention_fwd(q, k, v, True, True),
                    lambda: at._flash_fwd_plain(q, k, v, True),
                    2 * qb + 2 * kb + sb, 4 * hd * pairs, time_ms(lib_fwd)),
            'dq': ('flash_attention_dq', 'flash_bwd.cu',
                   'skypilot_tpu/ops/attention.py:257',
                   lambda: at.flash_attention_dq(q, k, v, do, lse, delta),
                   lambda: at._flash_attention_dq_plain(q, k, v, do, lse,
                                                        delta),
                   3 * qb + 2 * kb + 2 * sb, 6 * hd * pairs, lib_bwd_ms),
            'dkv': ('flash_attention_dkv', 'flash_bwd.cu',
                    'skypilot_tpu/ops/attention.py:279',
                    lambda: at.flash_attention_dkv(q, k, v, do, lse, delta),
                    lambda: at._flash_attention_dkv_plain(q, k, v, do, lse,
                                                          delta),
                    2 * qb + 4 * kb + 2 * sb, 8 * hd * pairs, lib_bwd_ms),
        }
        for kernel, (name, src, replaces, fn, plain, nbytes, flops,
                     lib_ms) in rows.items():
            b_ms, by = bound(nbytes, flops, BF16_FLOPS)
            ms = time_ms(fn)
            results[kernel, key] = {
                'name': name if key == '1b' else f'{name}[8B trunk]',
                'route': 'cuda', 'source': f'skypilot_tpu_torch/csrc/{src}',
                'replaces': replaces, 'shape': shape,
                'max_abs_err': errs[kernel], 'ms': ms,
                'plain_ms': time_ms(plain, plain_reps), 'bound_ms': b_ms,
                'bound_by': by, 'library_ms': lib_ms,
                'tflops': flops / ms / 1e9,
            }
            results[kernel, key].update(_tc_entry(ptxas, TC_KERNELS[kernel]))
            log(f'  {results[kernel, key]["name"]} {shape}: {ms:.3f} ms, '
                f'{flops / ms / 1e9:.1f} TFLOP/s (plain '
                f'{results[kernel, key]["plain_ms"]:.3f}, library '
                f'{lib_ms:.3f}, bound {b_ms:.4f} by {by})')
        del q, k, v, do, o, lse, delta, qt, kt, vt, lib_out, lib_do, rows
        torch.cuda.empty_cache()
    return results


def _tables(last_rows, n_blocks, seed, t_width=T_WIDTH):
    """Scattered block tables covering each slot's rows 0..last_rows[b]
    (capped at the table), drawn from blocks 1.. of the arena."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((len(last_rows), t_width), np.int32)
    for b, last in enumerate(last_rows):
        live = min(int(last) // BS + 1, t_width)
        tables[b, :live] = perm[b * t_width:b * t_width + live]
    return torch.as_tensor(tables, device='cuda')


def _arena(gen, dtype, n_blocks, int8):
    """A 2-layer (L, NB, BS, KV, hd) K/V arena, int8 with f32 scales when
    int8 (quantized from `dtype` values)."""
    from skypilot_tpu_torch.infer import llama_infer
    shape = (2, n_blocks, BS, KV_HEADS, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    v = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    if not int8:
        return k, v, None, None
    (k8, ks), (v8, vs) = (llama_infer._quantize_kv(x) for x in (k, v))
    return k8, v8, ks, vs


def _poison(k, v, tables, last_rows, layer):
    """Copies of the arena with every block no table maps, and every row
    past each slot's last visible row, set to huge values."""
    value = 127 if k.dtype == torch.int8 else 1e4
    k2, v2 = k.clone(), v.clone()
    mapped = set(tables.flatten().tolist()) - {0}
    for blk in range(k.shape[1]):
        if blk not in mapped:
            k2[:, blk] = value
            v2[:, blk] = -value
    for b, last in enumerate(last_rows):
        if last < tables.shape[1] * BS - 1:
            blk = int(tables[b, last // BS])
            k2[layer, blk, last % BS + 1:] = value
            v2[layer, blk, last % BS + 1:] = -value
    return k2, v2


def _kv_bytes(keys, k):
    """Bytes of `keys` K and V rows of all KV heads (plus their f32
    scales for an int8 arena)."""
    per_row = KV_HEADS * HEAD_DIM * k.element_size()
    if k.dtype == torch.int8:
        per_row += KV_HEADS * 4
    return 2 * keys * per_row


def _gathered(k, v, ks, vs, tables, layer, dtype):
    """(B, KV, S, hd) views of one layer through the tables in `dtype`
    (int8 dequantized): the library call's operands."""
    from skypilot_tpu_torch.ops import decode_attention as da
    k_g = da._gather_layer(k, tables, layer)
    v_g = da._gather_layer(v, tables, layer)
    if ks is not None:
        k_g = da._dequantize(k_g, da._gather_layer(ks, tables, layer), dtype)
        v_g = da._dequantize(v_g, da._gather_layer(vs, tables, layer), dtype)
    return k_g.transpose(1, 2), v_g.transpose(1, 2)


def _split_of(da, batch, capacity):
    """(splits, split_len) of a K1/K7 launch at the phase 3 shapes."""
    return da._decode_splits(batch, KV_HEADS, capacity, da._DECODE_CHUNK,
                             da._sm_count(torch.device('cuda')))


def check_decode(decode_attention, ptxas):
    """K1 in f32, bf16 and on an int8 arena (bf16 q), then the combine
    pass alone on the partials of the bf16 launch, then K1 bf16 with one
    slot at position 8191; returns the kernels line entries of the bf16
    and int8 variants (the long-context row nested in the bf16 one) and
    of the combine."""
    da = decode_attention
    gen = torch.Generator(device='cuda').manual_seed(5)
    batch, layer = 8, 1
    n_blocks = 1 + batch * T_WIDTH
    capacity = T_WIDTH * BS
    # Mixed positions: 0, block edges (BS-1, BS), mid, and the table end.
    positions = torch.tensor([0, BS - 1, BS, 2 * BS + 5, 700, 1000,
                              1500, T_WIDTH * BS - 1], dtype=torch.int32,
                             device='cuda')
    last = positions.tolist()
    tables = _tables(last, n_blocks, 5)
    splits, split_len = _split_of(da, batch, capacity)
    results = {}
    for label, dtype, int8 in (('f32', torch.float32, False),
                               ('bf16', torch.bfloat16, False),
                               ('int8', torch.bfloat16, True)):
        q = torch.randn(batch, KV_HEADS, GROUP, HEAD_DIM, generator=gen,
                        device='cuda').to(dtype)
        k, v, ks, vs = _arena(gen, dtype, n_blocks, int8)

        def kernel(k=k, v=v):
            return da.decode_attention_pooled(
                q, k, v, tables, layer, positions, ks, vs)

        def plain():
            return da._decode_attention_plain(
                q, k, v, tables, layer, positions, ks, vs)

        out = kernel()
        err = check_close(f'decode_attention_pooled {label}', out, plain())
        if not torch.equal(kernel(), out):
            raise AssertionError(f'decode_attention_pooled {label}: two '
                                 f'calls differ')
        k2, v2 = _poison(k, v, tables, last, layer)
        if not torch.equal(kernel(k2, v2), out):
            raise AssertionError(f'decode_attention_pooled {label} read '
                                 f'keys past a position or outside its '
                                 f'table')
        del k2, v2
        if label == 'f32':
            continue
        if label == 'bf16':
            results['combine'] = _check_combine(
                da, q, k, v, tables, layer, positions, capacity, out, ptxas)
        live_keys = int(torch.clamp_max(positions.long() + 1,
                                        capacity).sum())
        nbytes = (2 * q.numel() * 2 + _kv_bytes(live_keys, k)
                  + tables.numel() * 4 + batch * 4)
        b_ms, by = bound(nbytes, 4 * HEAD_DIM * KV_HEADS * GROUP * live_keys,
                         BF16_FLOPS)
        kt, vt = _gathered(k, v, ks, vs, tables, layer, dtype)
        qs = q.reshape(batch, KV_HEADS * GROUP, 1, HEAD_DIM)
        mask = (torch.arange(kt.shape[2], device='cuda')[None, :]
                <= positions.long()[:, None])[:, None, None, :]
        results[label] = {
            'name': 'decode_attention_pooled'
                    + ('' if label == 'bf16' else '[int8]'),
            'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
            'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
            'shape': f'q ({batch}, {KV_HEADS}, {GROUP}, {HEAD_DIM}) bf16, '
                     f'{"int8" if int8 else "bf16"} arena, BS {BS} '
                     f'T {T_WIDTH}, live keys {live_keys}',
            'splits': splits, 'split_len': split_len,
            'max_abs_err': err, 'ms': time_ms(kernel),
            'graph_ms': graph_ms(kernel),
            'plain_ms': time_ms(plain), 'bound_ms': b_ms, 'bound_by': by,
            'library_ms': time_ms(lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            'library_graph_ms': graph_ms(
                lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            **_decode_ptxas(ptxas, ('pooled', label)),
        }
    results['bf16']['long_context'] = check_decode_long(da)
    return results


def _check_combine(da, q, k, v, tables, layer, positions, capacity, out,
                   ptxas):
    """The combine kernel alone on the partials that K1's bf16 launch
    left in its scratch, against _combine_splits_plain (per row: both sum
    the same f32 terms in f32) and bitwise against the launch's own
    output; returns its kernels line entry."""
    batch = q.shape[0]
    _, scratch, split_len = da._decode_attention_cuda(
        q, k, v, tables, layer, positions, None, None)
    if scratch is None:
        raise AssertionError('decode_attention_pooled: the phase 3 shape '
                             'did not take the split route')
    acc, ml = da._split_partials(q, scratch)
    live = da._live_splits(positions, capacity, split_len)

    def kernel():
        return da._decode_combine_cuda(acc, ml, positions, capacity,
                                       split_len, q.dtype)

    def plain():
        return da._combine_splits_plain(ml[..., 0], ml[..., 1], acc,
                                        live).to(q.dtype)

    got, want = kernel(), plain()
    err = check_close('decode_combine bf16', got, want, row_tol(want))
    if not torch.equal(got, out):
        raise AssertionError('decode_combine: not the split launch\'s '
                             'output')
    parts = int(live.sum()) * KV_HEADS * GROUP
    nbytes = parts * (HEAD_DIM + 2) * 4 + got.numel() * 2 + batch * 4
    b_ms, by = bound(nbytes, parts * HEAD_DIM * 2, BF16_FLOPS)
    return {
        'name': 'decode_combine', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
        'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
        'shape': f'partials of K1 bf16: {acc.shape[2]} splits of '
                 f'{split_len} keys, {int(live.sum())} live over {batch} '
                 f'slots, G {GROUP}, hd {HEAD_DIM}',
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel), 'plain_ms': time_ms(plain),
        'bound_ms': b_ms, 'bound_by': by, 'library_ms': None,
        **_decode_ptxas(ptxas, 'combine'),
    }


# K1 over a whole LLAMA3_8B context: one slot at position 8191 (the
# 8192-token max_seq_len in 64-row blocks).
LONG_T_WIDTH = 8192 // BS


def check_decode_long(da):
    """K1 bf16, one slot at position 8191 (T 128): against its plain
    version, on a poisoned arena, timed with its bound and SDPA's."""
    gen = torch.Generator(device='cuda').manual_seed(9)
    layer, n_blocks = 1, 1 + LONG_T_WIDTH
    capacity = LONG_T_WIDTH * BS
    positions = torch.tensor([capacity - 1], dtype=torch.int32,
                             device='cuda')
    tables = _tables([capacity - 1], n_blocks, 9, LONG_T_WIDTH)
    q = torch.randn(1, KV_HEADS, GROUP, HEAD_DIM, generator=gen,
                    device='cuda').to(torch.bfloat16)
    k, v, _, _ = _arena(gen, torch.bfloat16, n_blocks, False)

    def kernel(k=k, v=v):
        return da.decode_attention_pooled(q, k, v, tables, layer, positions)

    def plain():
        return da._decode_attention_plain(q, k, v, tables, layer, positions)

    out = kernel()
    err = check_close('decode_attention_pooled bf16 position 8191', out,
                      plain())
    k2, v2 = _poison(k, v, tables, [capacity - 1], layer)
    if not torch.equal(kernel(k2, v2), out):
        raise AssertionError('decode_attention_pooled at position 8191 read '
                             'outside its table')
    del k2, v2
    splits, split_len = _split_of(da, 1, capacity)
    nbytes = 2 * q.numel() * 2 + _kv_bytes(capacity, k) + tables.numel() * 4 + 4
    b_ms, by = bound(nbytes, 4 * HEAD_DIM * KV_HEADS * GROUP * capacity,
                     BF16_FLOPS)
    kt, vt = _gathered(k, v, None, None, tables, layer, torch.bfloat16)
    qs = q.reshape(1, KV_HEADS * GROUP, 1, HEAD_DIM)
    return {
        'shape': f'q (1, {KV_HEADS}, {GROUP}, {HEAD_DIM}) bf16, bf16 arena, '
                 f'BS {BS} T {LONG_T_WIDTH}, position {capacity - 1}, '
                 f'{capacity} keys',
        'splits': splits, 'split_len': split_len,
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel), 'plain_ms': time_ms(plain),
        'bound_ms': b_ms, 'bound_by': by,
        'library_ms': time_ms(lambda: sdpa(qs, kt, vt)),
        'library_graph_ms': graph_ms(lambda: sdpa(qs, kt, vt)),
    }


# Mangled-name fragments of the timed K4 tensor-core instantiations
# (head_dim 128; the arena bf16 or int8, i.e. signed char 'a') and of its
# combine kernel, and the design of each.
WINDOW_KERNELS = {'bf16': 'paged_window_mma_kernelI13__nv_bfloat16Li128E',
                  'int8': 'paged_window_mma_kernelIaLi128E',
                  'combine': 'paged_window_combine_kernelILi128E'}
_WINDOW_TC = ('mma.sync m16n8k16 bf16 -> f32, ldmatrix, cp.async x2, '
              '64-row tiles, split-KV + combine')
WINDOW_DESIGN = {'bf16': _WINDOW_TC,
                 'int8': _WINDOW_TC + ', int8 -> bf16 in shared memory',
                 'combine': 'a warp a row, its live splits in ascending '
                            'order, f32'}



def check_window(decode_attention, ptxas):
    """K4 at the verify shape (B 8, W 13) and the fused-lane shape (B 1,
    W 264 from row 436), in f32, bf16 and on an int8 arena (bf16 q):
    against the plain version, twice (bitwise), on poisoned arenas, and
    at W = 1 against K1; bf16 and int8 must take the tensor-core route
    and f32 the FMA route.  Then the combine pass alone on the partials
    of the verify bf16 launch.  Returns the kernels line entries of the
    bf16 and int8 variants and of the combine."""
    da = decode_attention
    counter = da.decode_window_attention_pooled
    gen = torch.Generator(device='cuda').manual_seed(6)
    layer = 1
    capacity = T_WIDTH * BS
    verify_pos = [0, BS - 1, BS, 2 * BS + 5, 700, 1000, 1500,
                  T_WIDTH * BS - 1]
    shapes = (('verify', verify_pos, 13), ('fused', [436], 264))
    results = {}
    for lane, pos_list, win in shapes:
        batch = len(pos_list)
        n_blocks = 1 + batch * T_WIDTH
        positions = torch.tensor(pos_list, dtype=torch.int32, device='cuda')
        last = [p + win - 1 for p in pos_list]
        tables = _tables(last, n_blocks, 6)
        splits, split_len = da._window_splits(
            batch, KV_HEADS, -(-win * GROUP // da._WINDOW_ROWS), capacity,
            da._WINDOW_CHUNK, da._sm_count(torch.device('cuda')))
        for label, dtype, int8 in (('f32', torch.float32, False),
                                   ('bf16', torch.bfloat16, False),
                                   ('int8', torch.bfloat16, True)):
            q = torch.randn(batch, win, KV_HEADS, GROUP, HEAD_DIM,
                            generator=gen, device='cuda').to(dtype)
            k, v, ks, vs = _arena(gen, dtype, n_blocks, int8)

            def kernel(k=k, v=v):
                return da.decode_window_attention_pooled(
                    q, k, v, tables, layer, positions, ks, vs)

            def plain():
                return da._decode_window_attention_plain(
                    q, k, v, tables, layer, positions, ks, vs)

            name = f'decode_window_attention_pooled {lane} {label}'
            tc = counter.launches_tc
            out = kernel()
            if counter.launches_tc - tc != int(label != 'f32'):
                route = 'FMA' if label == 'f32' else 'tensor-core'
                raise AssertionError(f'{name}: not on the {route} route')
            err = check_close(name, out, plain())
            if not torch.equal(kernel(), out):
                raise AssertionError(f'{name}: two calls differ')
            k2, v2 = _poison(k, v, tables, last, layer)
            if not torch.equal(kernel(k2, v2), out):
                raise AssertionError(f'{name} read keys past its window '
                                     f'or outside its table')
            del k2, v2
            one = da.decode_window_attention_pooled(
                q[:, :1], k, v, tables, layer, positions, ks, vs)[:, 0]
            check_close(f'{name} W=1 vs K1', one, da.decode_attention_pooled(
                q[:, 0].contiguous(), k, v, tables, layer, positions, ks,
                vs))
            if label == 'f32':
                continue
            if (lane, label) == ('verify', 'bf16'):
                results['combine'] = _check_window_combine(
                    da, q, k, v, tables, layer, positions, out, ptxas)
            rows = torch.clamp_max(
                positions.long()[:, None] + torch.arange(win, device='cuda')
                + 1, capacity)                          # keys per row
            pairs = int(rows.sum()) * KV_HEADS * GROUP
            keys = int(rows[:, -1].sum())
            nbytes = (2 * q.numel() * 2 + _kv_bytes(keys, k)
                      + tables.numel() * 4 + batch * 4)
            b_ms, by = bound(nbytes, 4 * HEAD_DIM * pairs, BF16_FLOPS)
            kt, vt = _gathered(k, v, ks, vs, tables, layer, dtype)
            qs = q.permute(0, 2, 3, 1, 4).reshape(
                batch, KV_HEADS * GROUP, win, HEAD_DIM)
            mask = (torch.arange(kt.shape[2], device='cuda')[None, None, :]
                    < rows[:, :, None])[:, None]        # (B, 1, W, S)
            # SDPA's row order is (KV, G, W); logged, not held to a bound.
            lib_out = sdpa(qs, kt, vt, attn_mask=mask)
            lib_err = (out.permute(0, 2, 3, 1, 4).reshape(lib_out.shape)
                       .float() - lib_out.float()).abs().max().item()
            log(f'  {name}: max_abs_err vs SDPA {lib_err:.3e}')
            suffix = lane if label == 'bf16' else f'int8 {lane}'
            results[(lane, label)] = {
                'name': f'decode_window_attention_pooled[{suffix}]',
                'route': 'cuda',
                'source': 'skypilot_tpu_torch/csrc/paged_window.cu',
                'replaces': 'skypilot_tpu/ops/decode_attention.py:456',
                'shape': f'q ({batch}, {win}, {KV_HEADS}, {GROUP}, '
                         f'{HEAD_DIM}) bf16, {"int8" if int8 else "bf16"} '
                         f'arena, BS {BS} T {T_WIDTH}, positions '
                         f'{pos_list if batch == 1 else "0..2047"}, '
                         f'{keys} keys',
                'splits': splits, 'split_len': split_len,
                'max_abs_err': err, 'ms': time_ms(kernel),
                'graph_ms': graph_ms(kernel),
                'plain_ms': time_ms(plain), 'bound_ms': b_ms,
                'bound_by': by,
                'library_ms': time_ms(
                    lambda: sdpa(qs, kt, vt, attn_mask=mask)),
                'library_graph_ms': graph_ms(
                    lambda: sdpa(qs, kt, vt, attn_mask=mask)),
                **_tc_entry(ptxas, WINDOW_KERNELS[label],
                            WINDOW_DESIGN[label]),
            }
            log(f'  {name}: {splits} splits of {split_len}, ms '
                f'{results[lane, label]["ms"]:.4f}, graph '
                f'{results[lane, label]["graph_ms"]:.4f}, library graph '
                f'{results[lane, label]["library_graph_ms"]:.4f}')
    return results


def _check_window_combine(da, q, k, v, tables, layer, positions, out,
                          ptxas):
    """K4's combine kernel alone on the partials of the verify bf16
    launch, against _combine_splits_plain (per row: both sum the same f32
    terms in f32) and bitwise against the launch's own output; returns
    its kernels line entry."""
    batch, win = q.shape[:2]
    capacity = tables.shape[1] * BS
    _, scratch, split_len = da._decode_window_attention_cuda(
        q, k, v, tables, layer, positions, None, None,
        da.decode_window_attention_pooled)
    if scratch is None:
        raise AssertionError('decode_window_attention_pooled: the verify '
                             'shape did not take the split route')
    acc, ml = da._split_partials(q, scratch)
    live = da._window_live_splits(positions, win, GROUP, capacity,
                                  split_len)

    def kernel():
        return da._window_combine_cuda(acc, ml, positions, win, capacity,
                                       split_len)

    def plain():
        o = da._combine_splits_plain(ml[..., 0], ml[..., 1], acc, live)
        return o.reshape(batch, KV_HEADS, win, GROUP, HEAD_DIM).permute(
            0, 2, 1, 3, 4).to(q.dtype)

    got, want = kernel(), plain()
    err = check_close('paged_window_combine bf16', got, want, row_tol(want))
    if not torch.equal(got, out):
        raise AssertionError('paged_window_combine: not the split launch\'s '
                             'output')
    parts = int(live.sum()) * KV_HEADS
    nbytes = parts * (HEAD_DIM + 2) * 4 + got.numel() * 2 + batch * 4
    b_ms, by = bound(nbytes, parts * HEAD_DIM * 2, BF16_FLOPS)
    return {
        'name': 'paged_window_combine', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/paged_window.cu',
        'replaces': 'skypilot_tpu/ops/decode_attention.py:456',
        'shape': f'partials of K4 verify bf16: {acc.shape[2]} splits of '
                 f'{split_len}, {int(live.sum())} live (row, split) pairs '
                 f'over {batch} slots x {win * GROUP} rows, hd {HEAD_DIM}',
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel), 'plain_ms': time_ms(plain),
        'bound_ms': b_ms, 'bound_by': by, 'library_ms': None,
        **_tc_entry(ptxas, WINDOW_KERNELS['combine'],
                    WINDOW_DESIGN['combine']),
    }


# K7's cache at the 8B serving shape of phase 7: batch 8, the 1024-row
# bucket that the 700-token prompt and its 48 new tokens need.  The timed
# positions give K1's 5,515 live keys inside 1024 rows.
CONTIG_LEN = 1024
CONTIG_POSITIONS = ([0, 63, 64, 133, 511, 700, 1000, 1023],
                    [63, 64, 288, 1000, 1023, 1023, 1023, 1023])


def check_contig_decode(decode_attention, ptxas):
    """K7 in f32, bf16 and on an int8 cache (bf16 q) at q (8, 8, 4, 128)
    over a 2-layer (L, 8, 1024, 8, 128) cache: against its plain version
    at two position sets (block edges, and K1's live-key count), and on a
    cache poisoned past each position.  Returns the kernels line entries
    of the bf16 and int8 variants, timed at the second set."""
    da = decode_attention
    gen = torch.Generator(device='cuda').manual_seed(8)
    batch, layer = 8, 1
    shape = (2, batch, CONTIG_LEN, KV_HEADS, HEAD_DIM)
    results = {}
    for label, dtype, int8 in (('f32', torch.float32, False),
                               ('bf16', torch.bfloat16, False),
                               ('int8', torch.bfloat16, True)):
        q = torch.randn(batch, KV_HEADS, GROUP, HEAD_DIM, generator=gen,
                        device='cuda').to(dtype)
        k = torch.randn(shape, generator=gen, device='cuda').to(dtype)
        v = torch.randn(shape, generator=gen, device='cuda').to(dtype)
        ks = vs = None
        if int8:
            from skypilot_tpu_torch.infer import llama_infer
            (k, ks), (v, vs) = (llama_infer._quantize_kv(x) for x in (k, v))
        for pos_list in CONTIG_POSITIONS:
            positions = torch.tensor(pos_list, dtype=torch.int32,
                                     device='cuda')

            def kernel(k=k, v=v):
                return da.decode_attention(q, k, v, layer, positions, ks, vs)

            def plain():
                return da._decode_attention_contig_plain(
                    q, k, v, layer, positions, ks, vs)

            out, want = kernel(), plain()
            # Both sides keep the probabilities and the dequantized cache
            # in f32 and round only the output: per-row bf16 ulps.
            err = check_close(f'decode_attention {label} positions '
                              f'{pos_list}', out, want, row_tol(want))
            del want
            if not torch.equal(kernel(), out):
                raise AssertionError(f'decode_attention {label}: two calls '
                                     f'differ')
            value = 127 if int8 else 1e4
            k2, v2 = k.clone(), v.clone()
            for b, p in enumerate(pos_list):
                k2[layer, b, p + 1:] = value
                v2[layer, b, p + 1:] = -value
            if not torch.equal(kernel(k2, v2), out):
                raise AssertionError(f'decode_attention {label} read keys '
                                     f'past a position')
            del k2, v2
        if label == 'f32':
            continue
        live_keys = int((positions.long() + 1).sum())
        nbytes = 2 * q.numel() * 2 + _kv_bytes(live_keys, k) + batch * 4
        b_ms, by = bound(nbytes, 4 * HEAD_DIM * KV_HEADS * GROUP * live_keys,
                         BF16_FLOPS)
        kt, vt = k[layer], v[layer]
        if int8:
            kt = da._dequantize(kt, ks[layer], dtype)
            vt = da._dequantize(vt, vs[layer], dtype)
        kt, vt = kt.transpose(1, 2), vt.transpose(1, 2)    # (B, KV, S, hd)
        qs = q.reshape(batch, KV_HEADS * GROUP, 1, HEAD_DIM)
        mask = (torch.arange(CONTIG_LEN, device='cuda')[None, :]
                <= positions.long()[:, None])[:, None, None, :]
        splits, split_len = _split_of(da, batch, CONTIG_LEN)
        results[label] = {
            'name': 'decode_attention' + ('' if label == 'bf16' else '[int8]'),
            'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
            'replaces': 'skypilot_tpu/ops/decode_attention.py:202',
            'shape': f'q ({batch}, {KV_HEADS}, {GROUP}, {HEAD_DIM}) bf16, '
                     f'{"int8" if int8 else "bf16"} cache (2, {batch}, '
                     f'{CONTIG_LEN}, {KV_HEADS}, {HEAD_DIM}), live keys '
                     f'{live_keys}',
            'splits': splits, 'split_len': split_len,
            'max_abs_err': err, 'ms': time_ms(kernel),
            'graph_ms': graph_ms(kernel),
            'plain_ms': time_ms(plain), 'bound_ms': b_ms, 'bound_by': by,
            'library_ms': time_ms(lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            'library_graph_ms': graph_ms(
                lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            **_decode_ptxas(ptxas, ('contig', label)),
        }
    return results


# ---- phase 4: slice parity ------------------------------------------------

def _serve_debug(params, cfg, dev, prompts, budgets, graphs=None, **extra):
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    b = ContinuousBatcher(params, cfg, GeneratorConfig(
        max_seq_len=256, batch_size=3, prompt_buckets=[16, 64, 128],
        prefill_chunk=64, kv_block_size=16, **extra), decode_chunk=4,
        device=dev, graphs=graphs)
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    b.run_until_idle()
    if b.pooled:
        b.pool.check_invariant()
    return b, [b.result(r) for r in rids]


def _generate_debug(params, cfg, dev, prompts, budgets, graphs=None,
                    **extra):
    """The lockstep Generator on the same prompts, each row cut to its
    request's budget (generate() runs twice: the second call replays
    the first one's graphs, and must return the same tokens)."""
    from skypilot_tpu_torch.infer.engine import Generator, GeneratorConfig
    gen = Generator(params, cfg, GeneratorConfig(
        max_seq_len=256, batch_size=len(prompts),
        prompt_buckets=[16, 64, 128], decode_chunk=4, kv_block_size=16,
        **extra), device=dev, graphs=graphs)
    out = gen.generate(prompts, max_new_tokens=max(budgets))
    again = gen.generate(prompts, max_new_tokens=max(budgets))
    if again != out:
        raise AssertionError(f'Generator {extra} on {dev}: a second '
                             f'generate() gave other tokens')
    if gen.pooled:
        gen.pool.check_invariant()
    return gen, [o[:n] for o, n in zip(out, budgets)]


def _card_and_host(label, run, params, cfg, prompts, budgets, extra):
    """The same requests on the host (plain versions), on the card
    eagerly (graphs=False) and on the card through the engine's graphs
    (the default): identical greedy tokens on all three.  The graph run
    must have replayed chunks and captured each key once (on a legacy
    plane: once per bucket it reached).  Returns {run: (engine,
    tokens)}."""
    out = {}
    for name, dev, graphs in (('host', 'cpu', None),
                              ('card eager', 'cuda', False),
                              ('card graphs', 'cuda', None)):
        out[name] = run(params[dev], cfg, dev, prompts, budgets,
                        graphs=graphs, **extra)
    eng = out['card graphs'][0]
    if eng.graphs is not None:
        g = eng.graphs
        if not g.replays or (getattr(eng, 'pooled', True)
                             and g.captures != len(g.keys())):
            raise AssertionError(f'{label}: {g.captures} captures of '
                                 f'{len(g.keys())} keys, {g.replays} '
                                 f'replays')
    _same_tokens(f'{label}: card graphs vs card eager',
                 out['card graphs'][1], out['card eager'][1])
    _same_tokens(f'{label}: card vs host', out['card graphs'][1],
                 out['host'][1])
    graphs = ('no graphs (eager)' if eng.graphs is None else
              f'{eng.graphs.captures} captures, {eng.graphs.replays} '
              f'replays')
    log(f'  {label}: greedy tokens identical on the host, the card eager '
        f'and the card through graphs ({graphs}; '
        f'{sum(len(o) for o in out["host"][1])} tokens)')
    return out


def _same_tokens(what, got, want):
    """Identical greedy tokens, or an error naming the first request and
    position where they part."""
    if got == want:
        return
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            at = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                      min(len(g), len(w)))
            raise AssertionError(f'{what}: request {i} differs at token {at}:'
                                 f' {g} vs {w}')
    raise AssertionError(f'{what}: {got} vs {want}')


def _logits_close(what, got, want):
    atol, rtol = LOGITS_TOL
    err = (got.cpu() - want).abs().max().item()
    log(f'  {what} max_abs_err={err:.3e} (atol={atol} rtol={rtol})')
    torch.testing.assert_close(got.cpu(), want, atol=atol, rtol=rtol)


def slice_parity():
    from skypilot_tpu_torch.infer import block_pool, engine, llama_infer
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA_DEBUG
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   'cpu')
    params = {'cpu': params_cpu, 'cuda': _to_device(params_cpu, 'cuda')}
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (5, 40, 100, 17)]
    budgets = [12, 9, 7, 10]

    tokens = np.zeros((2, 64), np.int64)
    tokens[0, :40] = prompts[1]
    tokens[1, :17] = prompts[3]
    lengths = np.asarray([40, 17], np.int32)
    logits = {}
    for dev in ('cpu', 'cuda'):
        cache = llama_infer.init_cache(cfg, 2, 64, device=dev)
        logits[dev], _ = llama_infer.prefill(
            params[dev], torch.as_tensor(tokens, device=dev), cfg, cache,
            torch.as_tensor(lengths, device=dev))
    _logits_close('prefill logits', logits['cuda'], logits['cpu'])

    # int8 weights and an int8 arena: prefill, then the first decode step
    # through K1's int8 variant.
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    first = logits['cpu'].argmax(-1).to(torch.int32)
    step = {}
    for dev in ('cpu', 'cuda'):
        p8 = engine.prepare_params(params[dev], engine.GeneratorConfig(
            weights_dtype='int8'))
        cache = llama_infer.init_cache(cfg, 2, 64, kv_dtype='int8',
                                       device=dev)
        _, cache = llama_infer.prefill(
            p8, torch.as_tensor(tokens, device=dev), cfg, cache,
            torch.as_tensor(lengths, device=dev))
        arena = block_pool.init_arena(cfg, 9, 16, kv_dtype='int8',
                                      device=dev)
        tbl = torch.as_tensor(tables, device=dev)
        llama_infer.scatter_prefill_pooled(cache, arena, tbl)
        step[dev], _ = llama_infer.decode_step_pooled(
            p8, first.to(dev), cfg, arena,
            torch.as_tensor(lengths, device=dev), tbl)
    _logits_close('int8 first decode step logits', step['cuda'], step['cpu'])

    runs = (('plain', {}), ('spec_k=3', dict(spec_k=3)),
            ('fuse_budget=16', dict(fuse_budget=16)),
            ('int8 KV + weights', dict(kv_cache_dtype='int8',
                                       weights_dtype='int8')))
    outs = {}
    for label, extra in runs:
        three = _card_and_host(label, _serve_debug, params, cfg, prompts,
                               budgets, extra)
        for name, (b, _) in three.items():
            if 'spec_k' in extra and not b.spec_proposed:
                raise AssertionError(f'{label} on {name}: no verify chunk')
            if 'fuse_budget' in extra and not b._fuse_policy.stats.steps:
                raise AssertionError(f'{label} on {name}: no fused step')
        outs[label, 'cuda'] = three['card graphs'][1]
    for label in ('spec_k=3', 'fuse_budget=16'):
        _same_tokens(f'{label} vs plain schedule', outs[label, 'cuda'],
                     outs['plain', 'cuda'])
    log('  spec_k=3 and fuse_budget=16 give the plain schedule\'s tokens')

    # The legacy planes (K7 on 'paged') through the batcher, and the
    # lockstep Generator on the pooled and 'paged' planes.
    legacy = (('batcher paged', _serve_debug, dict(decode_impl='paged')),
              ('batcher inplace', _serve_debug, dict(decode_impl='inplace')),
              ('batcher paged int8 KV', _serve_debug,
               dict(decode_impl='paged', kv_cache_dtype='int8')),
              ('Generator pooled', _generate_debug, {}),
              ('Generator pooled spec_k=3', _generate_debug, dict(spec_k=3)),
              ('Generator paged', _generate_debug,
               dict(decode_impl='paged')))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        for label, run, extra in legacy:
            three = _card_and_host(label, run, params, cfg, prompts,
                                   budgets, extra)
            for name, (engine_obj, _) in three.items():
                if run is _serve_debug and not engine_obj.pooled and \
                        not engine_obj.migrations['grow']:
                    raise AssertionError(f'{label} on {name}: no migration')
            outs[label, 'cuda'] = three['card graphs'][1]
            if 'int8' not in label:
                _same_tokens(f'{label} vs the pooled batcher',
                             outs[label, 'cuda'], outs['plain', 'cuda'])
    log('  batcher paged / inplace / paged int8 KV and Generator pooled / '
        'spec_k=3 / paged: greedy tokens identical to the pooled '
        'batcher\'s (int8 aside)')


def _clone_to(tree, device):
    """A copy of a parameter tree on `device` (a Trainer updates the
    tensors it is given in place)."""
    if isinstance(tree, dict):
        return {k: _clone_to(v, device) for k, v in tree.items()}
    return tree.detach().clone().to(device)


def train_parity():
    """LLAMA_DEBUG f32 on the card (kernels) and the host (plain
    versions): first-step gradients under remat False, True and 'dots'
    (card vs host, and each remat setting vs none on the card), then 3
    Trainer steps with lr 1e-3 (loss and grad_norm of each)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer

    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    # 63 input tokens: a ragged last tile in every attention kernel.
    tokens = next(trainer.synthetic_batches(4, 63, cfg.vocab_size))['tokens']
    grads = {}
    for remat, policy in ((False, None), (True, None), (True, 'dots')):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        for dev in ('cpu', 'cuda'):
            p = trainer.tree_map(lambda t: t.requires_grad_(),
                                 _clone_to(params, dev))
            loss = llama.loss_fn(
                p, {'tokens': torch.from_numpy(tokens).to(dev)}, c)
            grads[policy or remat, dev] = [
                g.cpu() for g in torch.autograd.grad(
                    loss, trainer.tree_leaves(p))]
    for key in (False, True, 'dots'):
        err = 0.0
        for got, want in zip(grads[key, 'cuda'], grads[key, 'cpu']):
            if not float(got.abs().max()) > 0:
                raise AssertionError(f'remat={key}: a zero gradient')
            scale = float(want.abs().max())
            err = max(err, float((got - want).abs().max()) / scale)
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * scale)
        same = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(grads[key, 'cuda'],
                                   grads[False, 'cuda']))
        log(f'  first-step gradients remat={key}: card vs host max '
            f'err/max|grad| {err:.2e} (tolerance 1e-4); vs remat=False '
            f'on the card {same:.2e}')
        if same > 1e-5:
            raise AssertionError(f'remat={key} changes the gradients on '
                                 f'the card by {same:.2e} of their scale')
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=4)
    steps = {}
    for dev in ('cpu', 'cuda'):
        tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg),
                             _clone_to(params, dev), tc, device=dev)
        batches = trainer.synthetic_batches(4, 63, cfg.vocab_size)
        steps[dev] = [(float(m['loss']), float(m['grad_norm'])) for m in (
            tr.run_step(next(batches)) for _ in range(3))]
    log(f'  3 Trainer steps (loss, grad_norm): card {steps["cuda"]}, host '
        f'{steps["cpu"]}')
    np.testing.assert_allclose(steps['cuda'], steps['cpu'], rtol=1e-5)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---- phases 5 to 7: main paths ----------------------------------------------

# Prompt lengths of the 8 serving requests (48 new tokens each).
SERVE_LENGTHS = [17, 60, 128, 250, 300, 450, 600, 700]


def _graph_stats(graphs, before=(0, 0.0, 0)):
    """Captures, capture seconds and replays of an engine's graphs since
    `before` (zeros without graphs)."""
    now = ((graphs.captures, graphs.capture_seconds, graphs.replays)
           if graphs is not None else (0, 0.0, 0))
    return dict(zip(('graph_captures', 'graph_capture_s', 'graph_replays'),
                    (a - b for a, b in zip(now, before))))


def _burst(batcher, send, n):
    """Send n requests as one burst that the batcher admits in a fixed
    order: its ticks wait until all n are queued, and request i is sent
    once request i - 1 is queued.  So every run of a path prefills the
    same groups (a group's size changes the rounding of its bf16
    products) and two runs can be held to identical greedy tokens."""
    step, burst = batcher.step, threading.Event()
    batcher.step = lambda: step() if burst.is_set() else None
    threads = []
    try:
        for i in range(n):
            threads.append(threading.Thread(target=send, args=(i,)))
            threads[-1].start()
            deadline = time.perf_counter() + 60
            while batcher.num_queued <= i:
                if time.perf_counter() > deadline:
                    raise AssertionError(f'request {i} was never queued')
                time.sleep(0.001)
    finally:
        burst.set()
        del batcher.step           # the class's method again, no cycle
    for t in threads:
        t.join(900)


def serve_path(label, params, gen_config, counters, graphs=None):
    """Serve the 8 requests (one burst, _burst) through the HTTP replica
    with every launch count set to 0 just before and read just after;
    returns (the counts, the migrations, each request's tokens).  Fails
    unless every request returns 48 in-range tokens and the pool comes
    back empty (on a legacy plane: every slot comes back free and
    frozen, and one short request afterwards shrinks the slot cache to
    its smallest bucket).  graphs: the batcher's argument (None: graphs
    on the card)."""
    from skypilot_tpu_torch.infer import engine, replica
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(params, cfg, gen_config, decode_chunk=16,
                                device='cuda', graphs=graphs)
    # Warm-up (cuBLAS handles, allocator pools, the 16-step chunk's
    # graph), then count from zero.
    warm = batcher.submit([1, 2, 3], max_new_tokens=2)
    batcher.run_until_idle()
    batcher.result(warm)
    batcher.decode_tokens, batcher.decode_seconds = 0, 0.0
    batcher.spec_proposed = batcher.spec_accepted = 0
    batcher.slot_steps = batcher.live_slot_steps = 0
    warm_graphs = _graph_stats(batcher.graphs)
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    retries0 = torch.cuda.memory_stats()['num_alloc_retries']
    server, thread = replica.serve(batcher, '127.0.0.1', 0, 'llama3-8b')
    url = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        with urllib.request.urlopen(f'{url}/health', timeout=30) as r:
            health = json.loads(r.read())
        assert health['status'] == 'ok', health
        rng = np.random.RandomState(2)
        lengths = SERVE_LENGTHS
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

        fuse0 = (batcher._fuse_policy.stats.steps,
                 batcher._fuse_policy.stats.prefill_tokens) \
            if batcher._fuse_policy else (0, 0)
        _zero(counters)
        syncs0 = engine.host_fetch.calls
        mig0 = dict(batcher.migrations)
        t0 = time.perf_counter()
        _burst(batcher, send, len(prompts))
        wall = time.perf_counter() - t0
        launches = _counts(counters)
        syncs = engine.host_fetch.calls - syncs0
    finally:
        replica.shutdown_replica(server, thread)
    for i, resp in enumerate(responses):
        if resp is None or resp.get('num_generated') != max_new:
            raise AssertionError(f'{label}: request {i} (prompt '
                                 f'{lengths[i]}): {resp}')
        if not all(0 <= t < cfg.vocab_size for t in resp['output_ids']):
            raise AssertionError(f'{label}: request {i}: token out of range')
    migrations = {k: v - mig0[k] for k, v in batcher.migrations.items()}
    cache_len = batcher._cache_len
    if batcher.pooled:
        batcher.pool.check_invariant()
        st = batcher.pool.stats()
        if st['blocks_live'] or st['reserved']:
            raise AssertionError(f'{label}: pool not returned: {st}')
    else:
        if sorted(batcher._free) != list(range(gen_config.batch_size)) \
                or not bool(batcher._done.all()):
            raise AssertionError(f'{label}: slots not returned: free '
                                 f'{batcher._free}')
        short = batcher.submit([1, 2, 3], max_new_tokens=2)
        batcher.run_until_idle()
        batcher.result(short)
        if batcher._cache_len != batcher.cache_buckets[0]:
            raise AssertionError(f'{label}: the slot cache stayed at '
                                 f'{batcher._cache_len} rows')
    ttfts = sorted(r['ttft_s'] for r in responses)
    run_graphs = _graph_stats(batcher.graphs, tuple(warm_graphs.values()))
    stats = {
        'card': CARD['line'],
        'graphs': batcher.graphs is not None,
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
        **run_graphs,
        # The same tokens over the decode seconds that were not capture.
        'decode_tokens_per_s_without_capture': batcher.decode_tokens / (
            batcher.decode_seconds - run_graphs['graph_capture_s']),
        'graph_captures_warmup': warm_graphs['graph_captures'],
        'graph_capture_s_warmup': warm_graphs['graph_capture_s'],
        'graph_keys': len(batcher.graphs.keys()) if batcher.graphs else 0,
        'live_slot_share': (batcher.live_slot_steps / batcher.slot_steps
                            if batcher.slot_steps else None),
        'spec_proposed': batcher.spec_proposed,
        'spec_accepted': batcher.spec_accepted,
        'fused_steps': (batcher._fuse_policy.stats.steps - fuse0[0]
                        if batcher._fuse_policy else 0),
        'fused_prefill_tokens': (
            batcher._fuse_policy.stats.prefill_tokens - fuse0[1]
            if batcher._fuse_policy else 0),
        'host_fetches': syncs,
        'migrations': migrations,
        'cache_len': cache_len,
        'resident_gb_before_requests': resident_gb,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        # The allocator's cache held by the process, and the cudaMallocs
        # that failed and emptied that cache to retry (each a device
        # synchronize and a free of every cached segment).
        'reserved_gb': torch.cuda.memory_reserved() / 1e9,
        'alloc_retries': torch.cuda.memory_stats()['num_alloc_retries']
        - retries0,
        'launches': launches,
    }
    log(f'  {label}: ' + json.dumps(stats))
    return launches, migrations, [r['output_ids'] for r in responses]


def generate_path(label, params, gen_config, counters):
    """One Generator.generate of the 8 serving prompts, 48 new tokens
    each, with every launch count set to 0 just before and read just
    after; returns the counts.  Fails unless every row returns 48
    in-range tokens."""
    from skypilot_tpu_torch.infer.engine import Generator
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    gen = Generator(params, cfg, gen_config, device='cuda')
    gen.warmup()
    warm_graphs = _graph_stats(gen.graphs)
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.RandomState(2)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
               for n in SERVE_LENGTHS]
    _zero(counters)
    mig0 = dict(gen.migrations)
    t0 = time.perf_counter()
    out = gen.generate(prompts, max_new_tokens=48)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    for i, row in enumerate(out):
        if len(row) != 48 or not all(0 <= t < cfg.vocab_size for t in row):
            raise AssertionError(f'{label}: row {i} (prompt '
                                 f'{SERVE_LENGTHS[i]}): {len(row)} tokens')
    st = gen.last_stats
    stats = {
        'card': CARD['line'], 'rows': len(out),
        'prompt_tokens': sum(SERVE_LENGTHS),
        'generated_tokens': st['generated_tokens'], 'wall_s': wall,
        'ttft_s': st['ttft_s'],
        'decode_tokens_per_s': st['decode_tokens'] / st['decode_seconds'],
        'decode_tokens': st['decode_tokens'],
        'decode_seconds': st['decode_seconds'],
        **_graph_stats(gen.graphs, tuple(warm_graphs.values())),
        'live_slot_share': st['live_slot_steps'] / st['decode_tokens'],
        'host_fetches': st['host_fetches'],
        'migrations': {k: v - mig0[k] for k, v in gen.migrations.items()},
        'cache_len': st['cache_len'],
        'resident_gb_before_generate': resident_gb,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        'launches': launches,
    }
    log(f'  {label}: ' + json.dumps(stats))
    return launches


def train_path(label, cfg, batch, seq, steps, train_config, counters):
    """Trainer.fit on random bf16 weights with every launch count set to
    0 just before and read just after; returns the counts.  Fails unless
    the first and last losses are finite."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer

    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    first = next(trainer.synthetic_batches(batch, seq, cfg.vocab_size))
    with torch.no_grad():
        first_loss = float(llama.loss_fn(params, {'tokens': torch.as_tensor(
            first['tokens'], device='cuda')}, cfg))
    tr = trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg), params,
                         train_config, device='cuda')
    del params
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    n_all = cfg.num_params()
    n_matmul = n_all - cfg.vocab_size * cfg.d_model
    _zero(counters)
    t0 = time.perf_counter()
    out = tr.fit(trainer.synthetic_batches(batch, seq, cfg.vocab_size),
                 steps, log_every=0, tokens_per_batch=batch * seq,
                 flops_per_token=6 * n_all)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    if not (np.isfinite(first_loss) and np.isfinite(out['loss'])):
        raise AssertionError(f'{label}: loss {first_loss} -> {out["loss"]}')
    stats = {
        'card': CARD['line'],
        'params_b': n_all / 1e9, 'params_b_without_embed': n_matmul / 1e9,
        'tokens_per_step': batch * seq, 'steps': steps,
        'step_time_s': out['step_time_s'],
        'tokens_per_s': out['tokens_per_sec'],
        'mfu_6n_all': out['mfu'],
        'mfu_6n_without_embed': (6 * n_matmul * out['tokens_per_sec']
                                 / BF16_FLOPS),
        'first_loss': first_loss, 'last_loss': out['loss'],
        'grad_norm': out['grad_norm'], 'fit_wall_s': wall,
        'resident_gb_before_fit': resident_gb,
        'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log(f'  {label}: ' + json.dumps(stats))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Launch counts by route: '<name>[tc]' the tensor-core kernels of K2, K5
# and K6, '<name>[split]' the split-KV launches of K1 and K7.
ROUTES = {'tc': 'launches_tc', 'split': 'launches_split'}


def _zero(counters):
    for c in counters:
        c.launches = 0
        for attr in ROUTES.values():
            if hasattr(c, attr):
                setattr(c, attr, 0)


def _counts(counters):
    """Launch counts by wrapper name, and by route (ROUTES)."""
    out = {c.__name__: c.launches for c in counters}
    for route, attr in ROUTES.items():
        out.update({f'{c.__name__}[{route}]': getattr(c, attr)
                    for c in counters if hasattr(c, attr)})
    return out


def _need(label, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f'{name} was never launched on the {label} '
                                 f'path')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run '
              'needs an NVIDIA card', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import _kernels, attention, decode_attention
    from skypilot_tpu_torch.ops import rmsnorm
    from skypilot_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD['line'] = nvidia_smi_line()
    CARD['kind'] = torch.cuda.get_device_name(0)
    log(f'[1/8] device: {CARD["line"]} | torch {torch.__version__} '
        f'cuda {torch.version.cuda}')

    log('[2/8] build')
    _kernels.LIBRARY.get()
    log(f'  built {_kernels.LIBRARY.path.name} in '
        f'{_kernels.LIBRARY.build_seconds:.1f} s')
    (_kernels.BUILD_DIR / 'build.log').write_text(_kernels.LIBRARY.build_log)
    for line in _kernels.LIBRARY.build_log.splitlines():
        if 'spill' in line and ' 0 bytes spill stores' not in line:
            log(f'  ptxas: {line.strip()}')
    ptxas = ptxas_report(_kernels.LIBRARY.build_log)
    for name, info in ptxas.items():
        if '_mma_kernel' in name and info['spill_bytes']:
            raise AssertionError(f'tensor-core kernel {name} spills: {info}')
        if ('decode_kernel' in name or 'combine_kernel' in name) \
                and info['spill_bytes']:
            raise AssertionError(f'decode kernel {name} spills: {info}')

    log('[3/8] kernels vs plain versions')
    t0 = time.perf_counter()
    decode = check_decode(decode_attention, ptxas)
    contig = check_contig_decode(decode_attention, ptxas)
    window = check_window(decode_attention, ptxas)
    flash, norm = check_flash(attention, ptxas), check_rmsnorm(rmsnorm)
    train = check_flash_train(attention, ptxas)
    k1 = decode_attention.decode_attention_pooled
    k4v = decode_attention.decode_window_attention_pooled
    k4f = decode_attention.fused_step_attention_pooled
    k7 = decode_attention.decode_attention
    k2, k3 = attention.flash_attention, rmsnorm.rms_norm
    k5, k6 = attention.flash_attention_dq, attention.flash_attention_dkv
    counters = [k1, k2, k3, k4v, k4f, k5, k6, k7]
    tiny = torch.zeros(1, device='cuda')
    read = torch.zeros(10 << 20, dtype=torch.bfloat16, device='cuda')
    log(f'  timing floor (time_ms): one tiny kernel '
        f'{time_ms(lambda: tiny.add_(1)):.4f} ms; torch.sum over 20 MB '
        f'{time_ms(read.sum):.4f} ms (bound 0.0063)')
    del tiny, read
    log(f'  phase 3: {time.perf_counter() - t0:.1f} s')

    log('[4/8] slice parity, LLAMA_DEBUG f32, card vs host')
    slice_parity()
    train_parity()

    log('[5/8] main path, LLAMA3_8B bf16 behind the HTTP replica')
    cfg = llama.LLAMA3_8B
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    torch.cuda.synchronize()
    log(f'  LLAMA3_8B bf16 random weights: {cfg.num_params() / 1e9:.2f}B '
        f'params in {time.perf_counter() - t0:.1f} s')
    base = dict(max_seq_len=2048, batch_size=8, prefill_chunk=256)
    paths = {}
    # The same burst eagerly, then through graphs (the main path, whose
    # counts the kernels line reports): identical greedy tokens.
    eager5, _, eager_out = serve_path('main path eager (graphs=False)',
                                      params, GeneratorConfig(**base),
                                      counters, graphs=False)
    paths['5'], _, graph_out = serve_path('main path', params,
                                          GeneratorConfig(**base), counters)
    _same_tokens('phase 5: graphs vs eager', graph_out, eager_out)
    log(f'  phase 5: greedy tokens identical eager and through graphs '
        f'({sum(map(len, graph_out))} tokens)')
    for key, launches in (('5 eager', eager5), ('5', paths['5'])):
        _need(key, launches, [c.__name__ for c in (k1, k2, k3)])
        if launches[f'{k1.__name__}[split]'] != launches[k1.__name__]:
            raise AssertionError(f'{k1.__name__} missed the split route on '
                                 f'the {key} path')

    log('[6/8] main path with spec_k 12 and fuse_budget 264: (a) bf16, '
        '(b) int8 KV and weights')
    spec = dict(base, spec_k=12, fuse_budget=264)
    paths['6a'], _, _ = serve_path('6a bf16 spec+fused', params,
                                   GeneratorConfig(**spec), counters)
    paths['6b'], _, _ = serve_path('6b int8 spec+fused', params,
                                   GeneratorConfig(
                                       **spec, kv_cache_dtype='int8',
                                       weights_dtype='int8'), counters)
    for key in ('6a', '6b'):
        _need(key, paths[key], [c.__name__ for c in (k1, k2, k3, k4v, k4f)]
              + [f'{c.__name__}[{r}]' for c in (k4v, k4f)
                 for r in ('tc', 'split')])

    log("[7/8] legacy plane decode_impl='paged' (K7): (a) bf16 and (b) int8 "
        'KV behind the HTTP replica, (c) Generator.generate')
    legacy = dict(base, decode_impl='paged', decode_chunk=16)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        paths['7a'], mig_a, _ = serve_path('7a paged bf16', params,
                                           GeneratorConfig(**legacy),
                                           counters)
        paths['7b'], mig_b, _ = serve_path(
            '7b paged int8 KV', params,
            GeneratorConfig(**legacy, kv_cache_dtype='int8'), counters)
        paths['7c'] = generate_path('7c Generator paged bf16', params,
                                    GeneratorConfig(**legacy), counters)
    for key in ('7a', '7b', '7c'):
        _need(key, paths[key], [c.__name__ for c in (k2, k3, k7)])
        if paths[key][k1.__name__]:
            raise AssertionError(f'{k1.__name__} launched on the {key} path')
    if not mig_a['grow'] + mig_b['grow']:
        raise AssertionError('the paged plane never grew its slot cache')
    del params
    gc.collect()
    torch.cuda.empty_cache()

    log('[8/8] train path: (a) LLAMA_1B at the bench settings, (b) '
        'LLAMA3_8B widths at depth 2')
    remat = dict(remat=True, remat_policy='dots')
    paths['8a'] = train_path(
        '8a LLAMA_1B 8x1024', dataclasses.replace(
            llama.LLAMA_1B, max_seq_len=2048, loss_chunk=256, **remat),
        8, 1024, 12, trainer.TrainConfig(warmup_steps=2, total_steps=12),
        counters)
    paths['8b'] = train_path(
        '8b LLAMA3_8B widths, 2 layers, 2x4096', dataclasses.replace(
            llama.LLAMA3_8B, n_layers=2, max_seq_len=4096, loss_chunk=512,
            **remat),
        2, 4096, 6, trainer.TrainConfig(warmup_steps=2, total_steps=6),
        counters)
    for key in ('8a', '8b'):
        _need(key, paths[key], [c.__name__ for c in (k2, k3, k5, k6)])
    for key, launches in paths.items():
        # Every path runs bf16 at head_dim 128: the tensor-core route only;
        # and 8 slots x 8 KV heads < 2 blocks an SM: the split route only.
        route = [(c, 'tc') for c in (k2, k5, k6)]
        route += [(c, 'split') for c in (k1, k7) if key[0] in '567']
        route += [(c, 'tc') for c in (k4v, k4f) if key[0] == '6']
        for c, r in route:
            if launches[f'{c.__name__}[{r}]'] != launches[c.__name__]:
                raise AssertionError(
                    f'{c.__name__}: {launches[c.__name__]} launches on the '
                    f'{key} path, {launches[f"{c.__name__}[{r}]"]} of them on '
                    f'the {r} route')

    def entry(res, counter, keys):
        by_path = {k: paths[k][counter.__name__] for k in keys}
        out = dict(res, launches=sum(by_path.values()),
                   launches_by_path=by_path)
        for route, attr in ROUTES.items():
            if hasattr(counter, attr):
                out[attr] = sum(paths[k][f'{counter.__name__}[{route}]']
                                for k in keys)
        return out

    every = tuple(paths)
    kernels = [
        entry(decode['bf16'], k1, ('5', '6a')),
        entry(decode['int8'], k1, ('6b',)),
        entry(flash, k2, every),
        entry(norm, k3, every),
        entry(window['verify', 'bf16'], k4v, ('6a',)),
        entry(window['fused', 'bf16'], k4f, ('6a',)),
        entry(window['verify', 'int8'], k4v, ('6b',)),
        entry(window['fused', 'int8'], k4f, ('6b',)),
        entry(contig['bf16'], k7, ('7a', '7c')),
        entry(contig['int8'], k7, ('7b',)),
    ]
    # The combine runs inside every split launch of K1 and K7.
    split_paths = {k: paths[k][f'{c.__name__}[split]']
                   for c, keys in ((k1, ('5', '6a', '6b')),
                                   (k7, ('7a', '7b', '7c'))) for k in keys}
    kernels.append(dict(decode['combine'],
                        launches=sum(split_paths.values()),
                        launches_by_path=split_paths))
    # K4's combine runs inside every split launch of K4.
    window_split = {k: sum(paths[k][f'{c.__name__}[split]']
                           for c in (k4v, k4f)) for k in ('6a', '6b')}
    kernels.append(dict(window['combine'],
                        launches=sum(window_split.values()),
                        launches_by_path=window_split))
    kernels += [entry(train[name, key], counter, (path,))
                for name, counter in (('lse', k2), ('dq', k5), ('dkv', k6))
                for key, path in (('1b', '8a'), ('8b', '8b'))]
    log(json.dumps({'kernels': kernels}))
    log(CARD['line'])
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': CARD['kind'],
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
