#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (skypilot_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: needs torch.cuda; prints the card's name and power limit.
2. build: compiles skypilot_tpu_torch/csrc/*.cu with nvcc (in parallel)
   into build/torch_kernels/ and loads the library; fails if ptxas
   reports a spill in a tensor-core kernel (K2 in bf16 at hd 64, 128 and
   256; K4, K5 and K6 at hd 64 and 128), in a K1/K7 decode kernel or a
   combine kernel (K1/K7 and K4), or in K3 (whose rows live in
   registers).
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
   timed; K1 and the combine again at the shape of 10c's GRPO rollouts
   (LLAMA_1B: G 2 over 8 KV heads, 8 slots, a 2-block table), each with
   its own kernels line entry; K1 and the combine also at the decode
   shapes of 12a (Gemma-7B: 16 KV heads of 256, G 1) and 12b
   (Qwen2.5-1.5B: 2 KV heads of 128, G 6), and K1 in bf16 and over an
   int8 arena on tables in which 8 slots share the 16 blocks of one
   1,024-token head (phase 14's warm decode: the entries
   paged_decode[shared blocks] and [int8 shared blocks], their bound
   counting each shared byte once).  K2 with and without its lse at the
   prefill shapes of phase 12 (FLASH_SHAPES), f32 and bf16 at ragged S
   and then in bf16 at the shape, timed both ways: Gemma-7B's q (4, 512,
   16, 256) and Qwen2.5-1.5B's q (4, 512, 12, 128) over 2 KV heads, both
   of which must take the tensor-core route; K3 at the widths and eps of
   every main path (NORM_SHAPES: 4096 at 1e-5, Gemma-7B's 3072 and
   Qwen2.5-1.5B's 1536 at 1e-6) at 1, 8, 104, 264, 2048 and 4097 rows,
   timed at 8, 104 and 264 rows as a replayed graph (as decode replays
   it) and at 2048 eagerly, each beside F.rms_norm timed the same way,
   with the launch policy's configuration; the training kernels also at G 6,
   ragged and at 12b's LoRA-SFT shape (2, 2048, 12/2 heads, 128).  K4 (the window attention) takes its tensor-core route in bf16
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
   host, and 3 Trainer steps (loss, grad_norm) on both; and the
   first-step adapter gradients of LoRA-SFT and LoRA-DPO on both.  MoE
   parity on a 2-layer MoE model at LLAMA_DEBUG's attention widths (4
   experts, top 2, f32): identical greedy tokens on the host, the card
   eager and the card through graphs (pooled plane, plain and spec_k=3),
   and first-step gradients of moe.loss_fn card vs host under
   router_impl 'capacity' and 'dense'.
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
9. checkpoints, LLAMA_1B at phase 8a's settings, under a temp dir that
   is removed after (fails early without ~28 GB free): (a) Trainer A
   takes 8 steps with async saves every 4 (keep_last 2); Trainer B,
   from another seed, restores the latest step, which must be 8 and
   equal A's state leaf by leaf (torch.equal); one forward and backward
   run twice from B's state must be bitwise repeatable, and 3 more
   steps of A and B on the same batches must give identical losses,
   grad norms and states.  Prints the snapshot stall
   and write + commit seconds a save, GB/s, restore seconds, and the
   step time with a save in flight beside 8a's.  (b) `python -m
   skypilot_tpu_torch.train.train_llama --model-size 1b --seq-len 1024
   --batch-size 8 --steps 16 --checkpoint-every 4` in a child process,
   sent SIGTERM once it has printed `saved step 8` and started staging
   step 12; relaunched with `--resume auto`, it must print `resumed
   from step N` for the newest committed step N and finish at step 16
   with a finite loss.  Prints the recovery seconds (relaunch to
   `resumed from step N`).
10. post-training, after the memory of phases 8-9 is freed: random
   LLAMA3_8B bf16 weights at all 32 layers (remat 'dots', loss_chunk
   512) as a frozen base.  (a) LoRA-SFT (rank 16, alpha 32, the attn
   target) through Trainer.fit, 6 steps of 2 x 2048 tokens from a
   {prompt, completion} JSONL the phase writes: the base never requires
   grad, its float64 checksum is unchanged, every B has moved; prints
   step time, tokens/s, completion tokens/s, peak memory, launches a
   step and MFU with its formula, (4N + 2N_adapted) x tokens/s / 989e12.
   (b) LoRA-DPO on the same base, 4 steps of 2 pairs x 1024 tokens, beta
   0.1: the step-0 loss must be log 2 (B = 0: policy = reference), and
   K2 must run without its lse in the reference passes; prints
   dpo_metrics.  (c) GRPO on LLAMA_1B (group 8, 2 prompts, 32 new
   tokens, temperature 1, kl_coef 0.05, 3 steps, the token-band reward):
   a greedy Generator over the Trainer's live tensors, captured before
   the steps, must then give a fresh Generator's tokens over a clone of
   the params; prints rollout and update seconds and the reward.  (d)
   train_sft (LoRA, checkpoint, --merge-save), train_dpo (LoRA) and
   train_rl at debug size as child processes: the merged file must equal
   merge_lora of the restored adapters bitwise and give the same greedy
   tokens; all finish with finite losses.
11. Mixtral-8x7B-v0.1's published widths (mixtral_config), random bf16
   weights, after phase 10's memory is freed.  (a) 16 of its 32 layers
   (23.48B parameters, 46.97 GB: the 32 do not fit the card) served as
   phase 5 serves LLAMA3_8B, through graphs (router_impl 'dense', the
   serving formulation): every request returns 48 tokens; prints phase
   5's stats and the decode step's bound, the streamed bytes over 3.35
   TB/s.  (c) LoRA-SFT of that frozen base once the batcher is released
   (rank 16, alpha 32, attn target, loss_chunk 512, 4 steps of 2 x 2048
   tokens): the base's checksum unchanged, every B moved; MFU counts
   (4 N_active + 2 N_adapted), N_active the attention, router and top 2
   experts a layer and the lm_head.  (b) Full-parameter training of a
   2-layer model at the same widths through train_moe.make_trainer
   (router_impl 'capacity', remat, 6 steps of 2 x 4096 tokens): finite
   losses and router aux losses; prints MFU = 6 N_active x tokens/s /
   989e12 with and without the lm_head.
12. HF checkpoints, each written by the script in HF's layout (names,
   (out, in) shapes, safetensors by hand, 5 GB shards with an index,
   random bf16 weights from a seed drawn on the card; it fails early,
   naming the bytes it needs, where the temp dir is short) and loaded by
   convert.load_hf_model onto the card.  (a) Gemma-7B's published
   config (google/gemma-7b's config.json: 28 layers, 16 heads of 256,
   ff 24576, vocab 256000, tied, norms stored as w - 1): 17.08 GB
   written, the port's tree 18.65 GB with the lm_head's copy; served as
   phase 5 serves LLAMA3_8B, through graphs; the directory deleted after
   (17.1 GB of disk at the peak).  (b) Qwen2.5-1.5B's (Qwen/Qwen2.5-1.5B:
   28 layers, 12 heads over 2 KV heads of 128, q/k/v biases, tied,
   max_position_embeddings 131072), served the same way, LoRA-SFT of the
   loaded base (rank 16 on attn, 3 steps of 2 x 2048), and `python -m
   skypilot_tpu_torch.train.train_sft --hf-model DIR --lora-rank 16
   --steps 3` as a child process.  Each load prints seconds, GB/s, the
   host's peak RSS growth (VmRSS sampled every 2 ms), which must stay
   below the model's bytes, and the device's peak;
   every leaf is held bitwise to the tensors drawn (drawn again), with
   each leaf's bit checksum.  The serves print phase 5's stats and the
   decode step against its bytes bound.  (c) Gemma-like (hd 256, gelu,
   the (1 + w) norm, tied) and Qwen2-like (biases, G 6, tied) configs
   at debug size in f32, each loaded on the host and on the card:
   bitwise equal leaves, allclose logits, identical greedy tokens on the
   host, the card eagerly and the card through graphs.
13. ResNet: (a) ResNet18Thin in f32 from one params_from_flax state on
   the host and on the card, one SGD-momentum step: loss, every
   gradient and update, running statistics held at RESNET_GRAD_REL /
   RESNET_ATOL, and the same step on the card with TF32 and with bf16
   convolutions, controls that must read past RESNET_GRAD_REL; (b)
   train_resnet's path, ResNet50 at batch 256 of
   224x224 in bf16 (2 warm-up, 10 timed steps: images/s, step ms, peak
   memory), then the entry point itself as a child process.
14. the prefix cache, the host KV tier and the prefill -> decode handoff
   on random LLAMA3_8B bf16 weights (phase 5's seed) at all 32 layers,
   pooled plane through graphs, prefill_chunk = prefix_block = 256.
   (a) bench_prefix_reuse's shape: 8 requests sharing a 1,024-token head
   with their own 64-token tails, 48 new tokens, batch 8, prefix_cache_mb
   2048; after a warm-up on a disjoint head, a cold batch, then a warm one
   with new tails: the warm tokens equal a batcher without a prefix
   cache, the warm hits make no install/extract copy and one host sync
   an admission (as the cold ones), the trie's bytes stay in budget;
   prints TTFT, prefill and decode tokens/s, hits, misses, tokens saved,
   evictions, pool shares.  (b) bench_tier_reuse's shape: 12 heads of
   1,024 tokens (1.61 GB of KV), a device budget of a tenth of that, a
   host tier of twice it in pinned memory; every head once, then each
   revisited after a prefetch_hint; tier off, then on: identical tokens,
   every prefetched node's arena bytes equal (SHA-256) those gathered at
   its spill; prints the tier's counts, spill and prefetch GB/s beside a
   plain pinned 1 GB copy each way, revisit TTFTs, the pinned
   allocation's seconds and RSS.  (c) a prefill batcher and a decode
   batcher over one parameter dict, in bf16 and int8 KV: 4 cold
   1,040-token prompts prefilled, exported, encoded, decoded, ingested
   and served 48 tokens, and a fifth whose image has a flipped byte
   (refused, served cold): all equal single-pool serving; drain_sessions
   mid-decode holds the uninterrupted tokens so far, and the specs run
   on the other batcher; prints image bytes, encode/decode ms and
   export-to-first-token seconds.  (d) LLAMA_DEBUG f32 on the host, the
   card eagerly and through graphs: the Generator's warm path (pooled and
   'paged'), the batcher's pooled plane with an evicting budget and the
   host tier, its 'paged' plane (install/extract, K7), and drain_sessions
   resumed on a second batcher: identical tokens, warm equal cold and the
   uninterrupted run, pooled arenas allclose.  Every phase prints its
   seconds, and the run its whole.

Every kernel of a main-path run must launch > 0 times in that run (the
counts are set to 0 just before it and read just after; a replayed graph
adds the launches its capture recorded, engine.ChunkGraphs); the window
kernel must launch from both verify and fused ticks, K7 (and never K1)
on every phase 7 path, and K2, K3, K5 and K6 from both train paths and
9a, and K2 with its lse, K3, K5 and K6 from 10a, 10b, 10c, 11b and 11c
(K1 from 10c's rollouts, K1, K2 and K3 from 11a, 12a and 12b, K2 with
its lse, K3, K5 and K6 from 12b's LoRA-SFT, K1 and K3 from 14a, 14b and
both 14c runs); K2, K5 and K6 only on their
tensor-core route on every path (bf16 at head_dim 128, and 12a's K2 at
256); K4 on phase 6's paths,
where it must also take its split route; K1 and K7 only on their split
route on every path of phases 5 to 7, 10c, 11a, 12a, 12b and 14 (B KV <= 128
< 2 x 132 SMs).  The last lines
of standard output are
the {"kernels": [...]} line, the nvidia-smi name/power-limit line, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
import zlib

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
HERE = os.path.dirname(os.path.abspath(__file__))


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

# K3 at the widths of the main paths: name -> (d, eps, seed).  Phases 5-11
# run LLAMA3_8B's and Mixtral's 4096 at eps 1e-5; 12a Gemma-7B's 3072 and
# 12b Qwen2.5-1.5B's 1536, both at eps 1e-6.
NORM_SHAPES = {'rms_norm': (4096, 1e-5, 3),
               'rms_norm[Gemma-7B]': (3072, 1e-6, 14),
               'rms_norm[Qwen2.5-1.5B]': (1536, 1e-6, 15)}


# K3's row counts: decode's 8 slots, verify's 8 x 13, the fused lane's
# 264 (all three replayed from graphs on the serving paths), a prefill
# chunk's 2048 (4 x 512) and two ragged ones; timed at the first four.
NORM_ROWS = (8, 104, 264, 2048, 1, 4097)
NORM_TIMED = (8, 104, 264, 2048)
NORM_GRAPH_ROWS = 264  # up to this many rows, timed as a replayed graph only


def check_rmsnorm(rmsnorm, name, ptxas):
    """K3 at NORM_SHAPES[name] against its plain version in f32 and bf16
    at every NORM_ROWS count; timed in bf16 at NORM_TIMED as a replayed
    graph (graph_ms: device time) and, above NORM_GRAPH_ROWS rows, also
    eagerly (time_ms, which counts the wrapper's host time where it
    outlasts the L2 flush), each beside F.rms_norm timed the same ways
    and its bound, with the launch policy's (threads a row, vectors a
    thread, blocks) and the ptxas registers and spill of the
    instantiation.  Returns its kernels line entry: the 2048-row numbers,
    and every count under `by_rows`."""
    from skypilot_tpu_torch.ops import _kernels
    d, eps, seed = NORM_SHAPES[name]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    sms = _kernels.sm_count(torch.device('cuda'))
    by_rows, err_max = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for rows in NORM_ROWS:
            x = torch.randn(rows, d, generator=gen, device='cuda').to(dtype)
            w = (1 + 0.1 * torch.randn(d, generator=gen, device='cuda')
                 ).to(dtype)
            want = rmsnorm._rms_norm_plain(x, w, eps)
            err = check_close(f'{name} {dtype} rows={rows}',
                              rmsnorm.rms_norm(x, w, eps), want,
                              row_tol(want))
            if dtype != torch.bfloat16 or rows not in NORM_TIMED:
                continue
            err_max = max(err_max, err)
            tpr, nv, grid = rmsnorm._norm_launch(rows, d, 2, sms)
            b_ms, by = bound(2 * x.numel() * 2 + d * 2, 4 * x.numel(),
                             BF16_FLOPS)

            def kernel(x=x, w=w):
                return rmsnorm.rms_norm(x, w, eps)

            def lib(x=x, w=w):
                return torch.nn.functional.rms_norm(x, (d,), w, eps)

            row = by_rows[rows] = {
                'graph_ms': graph_ms(kernel),
                'library_graph_ms': graph_ms(lib),
                'bound_ms': b_ms,
                'launch': {'threads_a_row': tpr, 'vectors_a_thread': nv,
                           'blocks': grid},
                **_ptxas_of(ptxas, rf'rmsnorm_kernelI13__nv_bfloat16Li{nv}E'),
                'max_abs_err': err}
            row['bound_share'] = b_ms / row['graph_ms']
            if rows > NORM_GRAPH_ROWS:
                row.update(ms=time_ms(kernel), library_ms=time_ms(lib))
            log(f'  {name} bf16 ({rows}, {d}) [{tpr} x {nv}, {grid} blocks]: '
                f'graph {row["graph_ms"]:.4f} ms, F.rms_norm '
                f'{row["library_graph_ms"]:.4f}; eager '
                f'{row.get("ms", float("nan")):.4f}, F.rms_norm '
                f'{row.get("library_ms", float("nan")):.4f}; bound '
                f'{b_ms:.4f} ({b_ms / row["graph_ms"]:.0%} in the graph)')
    x = torch.randn(2048, d, generator=gen, device='cuda').bfloat16()
    w = (1 + 0.1 * torch.randn(d, generator=gen, device='cuda')).bfloat16()
    main = by_rows[2048]
    return {
        'name': name, 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/rmsnorm.cu',
        'replaces': 'skypilot_tpu/ops/rmsnorm.py:31',
        'shape': f'x (2048, {d}) bf16 eps {eps:g}',
        'max_abs_err': err_max, 'ms': main['ms'],
        'graph_ms': main['graph_ms'],
        'plain_ms': time_ms(lambda: rmsnorm._rms_norm_plain(x, w, eps)),
        'bound_ms': main['bound_ms'], 'bound_by': 'bytes',
        'library_ms': main['library_ms'],
        'library_graph_ms': main['library_graph_ms'],
        'design': K3_DESIGN, 'by_rows': by_rows,
    }


K3_DESIGN = ('rows in registers (16-byte vectors, one read of x), w in '
             'registers once a block, a warp a row at 2048 rows, more '
             'threads a row at few rows (ops/rmsnorm.py _norm_launch)')


def _ptxas_of(ptxas, pattern):
    """The ptxas registers and spill of the one instantiation whose
    mangled name matches `pattern` (a regular expression); fails where
    the report names none or several."""
    found = [i for n, i in ptxas.items() if re.search(pattern, n)]
    if len(found) != 1:
        raise AssertionError(f'ptxas report has {len(found)} {pattern}')
    return {'ptxas_registers': found[0]['registers'],
            'ptxas_spill_bytes': found[0]['spill_bytes']}


def _tc_entry(ptxas, stem, design=None):
    """The design of a kernel (TC_DESIGN, the flash kernels', by default)
    and the ptxas registers and spill of its instantiation `stem` (a
    mangled-name fragment)."""
    return {'design': design or TC_DESIGN, **_ptxas_of(ptxas, stem)}


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


# K2 at the prefill shapes of phase 12 (phase 5's prefill chunk of 512
# rows over 4 requests), name -> ((B, S, H, KV, head_dim), the (H, KV) of
# its ragged checks, seed).  Gemma-7B: 16 heads of 256, MHA, on the
# tensor-core route that bf16 at head_dim 256 takes (one m16 tile a warp,
# 32-key tiles).  Qwen2.5-1.5B: 12 query heads over 2 KV heads of 128
# (G 6).
FLASH_SHAPES = {
    'flash_attention[Gemma-7B hd256]': ((4, 512, 16, 16, 256), (4, 2), 11),
    'flash_attention[Qwen2.5-1.5B G6 prefill]': ((4, 512, 12, 2, 128),
                                                 (12, 2), 16),
}
TC_DESIGN_HD256 = ('mma.sync m16n8k16 bf16 -> f32, ldmatrix, cp.async x2; '
                   'one m16 tile a warp, 64-row q-tiles, 32-key tiles, two '
                   'blocks an SM')


def check_flash_at(attention, ptxas, name):
    """K2 at FLASH_SHAPES[name]: against its plain versions in f32 and
    bf16 at a ragged S, with and without the lse, then at the shape
    itself in bf16, checked, timed without and with its lse (eagerly and
    as a replayed graph: device time without the wrapper's host work)
    beside its bound and SDPA's; fails unless every bf16 launch at the
    shape takes the tensor-core route.  Returns its kernels line entry, with the
    design and the ptxas registers and spill of the instantiation."""
    at = attention
    (batch, seq, heads, kv, hd), ragged, seed = FLASH_SHAPES[name]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, causal in ((1, 700, True), (2, 65, False)):
            q, k, v = _attn_operands(gen, b, s, *ragged, hd, dtype)[:3]
            for need_lse in (False, True):
                _check_fwd(at, q, k, v, causal,
                           f'{dtype} B={b} S={s} H={ragged[0]}/{ragged[1]} '
                           f'hd={hd} causal={causal} lse={need_lse}',
                           need_lse)
    q, k, v = _attn_operands(gen, batch, seq, heads, kv, hd,
                             torch.bfloat16)[:3]
    tc0 = at.flash_attention.launches_tc
    err, _, _ = _check_fwd(at, q, k, v, True, f'bf16 {name}')
    err_lse, _, _ = _check_fwd(at, q, k, v, True, f'bf16 {name} lse', True)
    tc = at.flash_attention.launches_tc - tc0
    if tc != 2:
        raise AssertionError(f'{name}: {tc} tensor-core launches of 2')
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    flops = 4 * hd * batch * heads * seq * (seq + 1) // 2
    b_ms, by = bound(nbytes, flops, BF16_FLOPS)
    lse_b_ms, _ = bound(nbytes + batch * heads * seq * 4, flops, BF16_FLOPS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        return at.flash_attention(q, k, v)

    def with_lse():
        return at.flash_attention_fwd(q, k, v, True, True)

    def lib():
        return sdpa(qt, kt, vt, is_causal=True)

    ms, lse_ms = time_ms(kernel), time_ms(with_lse)
    entry = {
        'name': name, 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
        'replaces': 'skypilot_tpu/ops/attention.py:120',
        'shape': f'q ({batch}, {seq}, {heads}, {hd}) kv {kv} causal bf16',
        'max_abs_err': err, 'ms': ms, 'graph_ms': graph_ms(kernel),
        'plain_ms': time_ms(lambda: at._flash_fwd_plain(q, k, v)),
        'bound_ms': b_ms, 'bound_by': by,
        'library_ms': time_ms(lib), 'library_graph_ms': graph_ms(lib),
        'tflops': flops / ms / 1e9,
        'lse': {'ms': lse_ms, 'graph_ms': graph_ms(with_lse),
                'bound_ms': lse_b_ms, 'max_abs_err': err_lse},
        **_tc_entry(ptxas, f'flash_fwd_mma_kernelILi{hd}E',
                    TC_DESIGN_HD256 if hd == 256 else None),
    }
    entry['graph_tflops'] = flops / entry['graph_ms'] / 1e9
    log(f'  {name}: {ms:.4f} ms, graph {entry["graph_ms"]:.4f} ms '
        f'({entry["graph_tflops"]:.1f} TFLOP/s); with lse {lse_ms:.4f}, '
        f'graph {entry["lse"]["graph_ms"]:.4f}; bound {b_ms:.4f} by {by}, '
        f'plain {entry["plain_ms"]:.3f}, SDPA {entry["library_ms"]:.4f}, '
        f'graph {entry["library_graph_ms"]:.4f}; ptxas '
        f'{entry["ptxas_registers"]} registers, '
        f'{entry["ptxas_spill_bytes"]} bytes spilled')
    return entry


# Attention shapes of the train paths: (B, S, H, KV, head_dim), and the
# suffix of their kernels line names: LLAMA_1B, the 8B trunk, and 12b's
# LoRA-SFT of Qwen2.5-1.5B (12 query heads over 2 KV heads, G 6).
TRAIN_SHAPES = {'1b': (8, 1024, 16, 8, 128), '8b': (2, 4096, 32, 8, 128),
                'qwen': (2, 2048, 12, 2, 128)}
TRAIN_SUFFIX = {'1b': '', '8b': '[8B trunk]', 'qwen': '[Qwen2.5-1.5B G6]'}


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
    and bf16 at the LLAMA_1B shape, a ragged S and a ragged S at G 6;
    then, in bf16 and causal at every TRAIN_SHAPES shape, checked again
    and timed.  Returns the
    kernels line entries by (kernel, shape), each with the error measured
    at its own shape, its TFLOP/s, the design and the ptxas registers and
    spill of the instantiation timed."""
    at = attention
    gen = torch.Generator(device='cuda').manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, heads, kv, causal in (
                (8, 1024, 16, 8, True), (2, 700, 16, 8, True),
                (2, 700, 16, 8, False), (2, 700, 12, 2, True)):
            q, k, v, do = _attn_operands(gen, batch, seq, heads, kv, 128,
                                         dtype)
            _check_train_kernels(at, q, k, v, do, causal,
                                 f'{dtype} B={batch} S={seq} H={heads}/{kv} '
                                 f'causal={causal}')
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
                'name': name + TRAIN_SUFFIX[key],
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


def _arena(gen, dtype, n_blocks, int8, kv_heads=KV_HEADS, head_dim=HEAD_DIM):
    """A 2-layer (L, NB, BS, KV, hd) K/V arena, int8 with f32 scales when
    int8 (quantized from `dtype` values)."""
    from skypilot_tpu_torch.infer import llama_infer
    shape = (2, n_blocks, BS, kv_heads, head_dim)
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
    scales for an int8 arena); k is (..., KV, hd)."""
    kv_heads, head_dim = k.shape[-2:]
    per_row = kv_heads * head_dim * k.element_size()
    if k.dtype == torch.int8:
        per_row += kv_heads * 4
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


def _split_of(da, batch, capacity, kv_heads=KV_HEADS):
    """(splits, split_len) of a K1/K7 launch."""
    from skypilot_tpu_torch.ops import _kernels
    return da._decode_splits(batch, kv_heads, capacity, da._DECODE_CHUNK,
                             _kernels.sm_count(torch.device('cuda')))


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
            **_ptxas_of(ptxas, DECODE_KERNELS['pooled', label]),
        }
    results['bf16']['long_context'] = check_decode_long(da)
    return results


def _check_combine(da, q, k, v, tables, layer, positions, capacity, out,
                   ptxas, name='decode_combine'):
    """The combine kernel alone on the partials that K1's bf16 launch
    left in its scratch, against _combine_splits_plain (per row: both sum
    the same f32 terms in f32) and bitwise against the launch's own
    output; returns its kernels line entry, named `name`."""
    batch, kv_heads, group, head_dim = q.shape
    _, scratch, split_len = da._decode_attention_cuda(
        q, k, v, tables, layer, positions, None, None)
    if scratch is None:
        raise AssertionError(f'decode_attention_pooled: {name}\'s shape '
                             f'did not take the split route')
    acc, ml = da._split_partials(q, scratch)
    live = da._live_splits(positions, capacity, split_len)

    def kernel():
        return da._decode_combine_cuda(acc, ml, positions, capacity,
                                       split_len, q.dtype)

    def plain():
        return da._combine_splits_plain(ml[..., 0], ml[..., 1], acc,
                                        live).to(q.dtype)

    got, want = kernel(), plain()
    err = check_close(f'{name} bf16', got, want, row_tol(want))
    if not torch.equal(got, out):
        raise AssertionError(f'{name}: not the split launch\'s output')
    parts = int(live.sum()) * kv_heads * group
    nbytes = parts * (head_dim + 2) * 4 + got.numel() * 2 + batch * 4
    b_ms, by = bound(nbytes, parts * head_dim * 2, BF16_FLOPS)
    return {
        'name': name, 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
        'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
        'shape': f'partials of K1 bf16: {acc.shape[2]} splits of '
                 f'{split_len} keys, {int(live.sum())} live over {batch} '
                 f'slots, KV {kv_heads}, G {group}, hd {head_dim}',
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel), 'plain_ms': time_ms(plain),
        'bound_ms': b_ms, 'bound_by': by, 'library_ms': None,
        **_ptxas_of(ptxas, DECODE_KERNELS['combine']),
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


# K1 at the decode shapes of the serving and rollout paths beyond phase
# 5's: name -> (KV heads, group, head_dim, table width, positions).
#   G2: phase 10c's GRPO rollouts, LLAMA_1B (16 query heads over 8 KV
#     heads), the Generator's 8 slots over an arena of 128 rows (prompt
#     64 + 32 new tokens + 1, to a power of two): the rollouts' positions
#     (2..35), a full 64-token prompt's (64..97), block edges, the end.
#   Gemma-7B (12a): 16 KV heads of 256 (MHA, G 1), 8 slots of 2,048 rows;
#   Qwen2.5-1.5B (12b): 12 query heads over 2 KV heads of 128 (G 6).
# The positions of 12a/12b are those of phase 5's requests mid-decode.
SERVE_POSITIONS = [17 + 20, 60 + 20, 128 + 20, 250 + 20, 300 + 20,
                   450 + 20, 600 + 20, 700 + 20]
DECODE_SHAPES = {
    'G2': (8, 2, 128, 2, [2, 35, BS - 1, BS, BS + 2, 80, 97, 2 * BS - 1]),
    'Gemma-7B': (16, 1, 256, 32, SERVE_POSITIONS),
    'Qwen2.5-1.5B': (2, 6, 128, 32, SERVE_POSITIONS),
}


def check_decode_at(da, ptxas, label, seed):
    """K1 bf16 at DECODE_SHAPES[label] against its plain version, twice
    bitwise, on a poisoned arena, timed with its bound and SDPA's (eager
    and as a replayed graph).  Returns its kernels line entry (the
    ptxas registers and spill of the instantiation: NG 4 rows a block
    for G <= 4, 8 above) and the combine's entry on that launch's
    partials (`decode_combine[<label>]`)."""
    kv_heads, group, head_dim, t_width, last = DECODE_SHAPES[label]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    batch, layer = 8, 1
    n_blocks = 1 + batch * t_width
    capacity = t_width * BS
    positions = torch.tensor(last, dtype=torch.int32, device='cuda')
    tables = _tables(last, n_blocks, seed, t_width)
    splits, split_len = _split_of(da, batch, capacity, kv_heads)
    q = torch.randn(batch, kv_heads, group, head_dim, generator=gen,
                    device='cuda').to(torch.bfloat16)
    k, v, _, _ = _arena(gen, torch.bfloat16, n_blocks, False, kv_heads,
                        head_dim)

    def kernel(k=k, v=v):
        return da.decode_attention_pooled(q, k, v, tables, layer, positions)

    def plain():
        return da._decode_attention_plain(q, k, v, tables, layer, positions)

    out = kernel()
    err = check_close(f'decode_attention_pooled bf16 {label}', out, plain())
    if not torch.equal(kernel(), out):
        raise AssertionError(f'decode_attention_pooled {label}: two calls '
                             f'differ')
    k2, v2 = _poison(k, v, tables, last, layer)
    if not torch.equal(kernel(k2, v2), out):
        raise AssertionError(f'decode_attention_pooled {label} read keys '
                             f'past a position or outside its table')
    del k2, v2
    combine = _check_combine(da, q, k, v, tables, layer, positions,
                             capacity, out, ptxas,
                             name=f'decode_combine[{label}]')
    live_keys = int(torch.clamp_max(positions.long() + 1, capacity).sum())
    nbytes = (2 * q.numel() * 2 + _kv_bytes(live_keys, k)
              + tables.numel() * 4 + batch * 4)
    b_ms, by = bound(nbytes, 4 * head_dim * kv_heads * group * live_keys,
                     BF16_FLOPS)
    kt, vt = _gathered(k, v, None, None, tables, layer, torch.bfloat16)
    qs = q.reshape(batch, kv_heads * group, 1, head_dim)
    mask = (torch.arange(kt.shape[2], device='cuda')[None, :]
            <= positions.long()[:, None])[:, None, None, :]
    ng = 8 if group > 4 else 4
    entry = {
        'name': f'decode_attention_pooled[{label}]', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
        'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
        'shape': f'q ({batch}, {kv_heads}, {group}, {head_dim}) bf16, '
                 f'bf16 arena, BS {BS} T {t_width}, positions {last}, '
                 f'live keys {live_keys}',
        'splits': splits, 'split_len': split_len,
        'max_abs_err': err, 'ms': time_ms(kernel),
        'graph_ms': graph_ms(kernel),
        'plain_ms': time_ms(plain), 'bound_ms': b_ms, 'bound_by': by,
        'library_ms': time_ms(lambda: sdpa(qs, kt, vt, attn_mask=mask)),
        'library_graph_ms': graph_ms(
            lambda: sdpa(qs, kt, vt, attn_mask=mask)),
        **_ptxas_of(ptxas, rf'decode_kernelI13__nv_bfloat16S\w*?_Li'
                           rf'{head_dim}ELi{ng}E\w*PooledRows'),
    }
    log(f'  {entry["name"]}: {entry["ms"]:.4f} ms (graph '
        f'{entry["graph_ms"]:.4f}), bound {b_ms:.4f} by {by}, plain '
        f'{entry["plain_ms"]:.4f}, SDPA {entry["library_ms"]:.4f}')
    return entry, combine


# K1 at phase 14a's warm decode: 8 slots whose tables share the 16 blocks
# of one 1,024-token head (the prefix cache's splice), each with its own
# blocks for a 64-token tail and the tokens decoded so far.
SHARED_HEAD_BLOCKS = 1024 // BS
SHARED_POSITIONS = [1088 + d for d in (0, 6, 13, 19, 26, 32, 39, 47)]


def check_decode_shared(da, ptxas):
    """K1 in bf16 and over an int8 arena on tables in which every slot
    points at the same physical head blocks, against its plain version,
    twice bitwise, on a poisoned arena, timed with its bound (each
    shared byte counted once) and SDPA's over the gathered rows (eager
    and as a replayed graph).  Returns the kernels line entries
    'paged_decode[shared blocks]' and 'paged_decode[int8 shared
    blocks]'."""
    gen = torch.Generator(device='cuda').manual_seed(14)
    batch, layer = 8, 1
    last = SHARED_POSITIONS
    own = T_WIDTH - SHARED_HEAD_BLOCKS
    n_blocks = 1 + SHARED_HEAD_BLOCKS + batch * own
    perm = np.random.RandomState(14).permutation(np.arange(1, n_blocks))
    tables = np.zeros((batch, T_WIDTH), np.int32)
    for b, pos in enumerate(last):
        live = pos // BS + 1
        tables[b, :SHARED_HEAD_BLOCKS] = perm[:SHARED_HEAD_BLOCKS]
        lo = SHARED_HEAD_BLOCKS + b * own
        tables[b, SHARED_HEAD_BLOCKS:live] = perm[
            lo:lo + live - SHARED_HEAD_BLOCKS]
    tables = torch.as_tensor(tables, device='cuda')
    positions = torch.tensor(last, dtype=torch.int32, device='cuda')
    capacity = T_WIDTH * BS
    splits, split_len = _split_of(da, batch, capacity)
    live_keys = sum(p + 1 for p in last)
    unique_keys = SHARED_HEAD_BLOCKS * BS + sum(
        p + 1 - SHARED_HEAD_BLOCKS * BS for p in last)
    out_entries = {}
    for label, int8 in (('bf16', False), ('int8', True)):
        q = torch.randn(batch, KV_HEADS, GROUP, HEAD_DIM, generator=gen,
                        device='cuda').to(torch.bfloat16)
        k, v, ks, vs = _arena(gen, torch.bfloat16, n_blocks, int8)

        def kernel(k=k, v=v):
            return da.decode_attention_pooled(q, k, v, tables, layer,
                                              positions, ks, vs)

        def plain():
            return da._decode_attention_plain(q, k, v, tables, layer,
                                              positions, ks, vs)

        name = ('paged_decode[shared blocks]' if not int8
                else 'paged_decode[int8 shared blocks]')
        out = kernel()
        err = check_close(name, out, plain())
        if not torch.equal(kernel(), out):
            raise AssertionError(f'{name}: two calls differ')
        k2, v2 = _poison(k, v, tables, last, layer)
        if not torch.equal(kernel(k2, v2), out):
            raise AssertionError(f'{name} read keys past a position or '
                                 f'outside its table')
        del k2, v2
        nbytes = (2 * q.numel() * 2 + _kv_bytes(unique_keys, k)
                  + tables.numel() * 4 + batch * 4)
        b_ms, by = bound(nbytes, 4 * HEAD_DIM * KV_HEADS * GROUP * live_keys,
                         BF16_FLOPS)
        kt, vt = _gathered(k, v, ks, vs, tables, layer, torch.bfloat16)
        qs = q.reshape(batch, KV_HEADS * GROUP, 1, HEAD_DIM)
        mask = (torch.arange(kt.shape[2], device='cuda')[None, :]
                <= positions.long()[:, None])[:, None, None, :]
        entry = {
            'name': name, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
            'replaces': 'skypilot_tpu/ops/decode_attention.py:356',
            'shape': f'q ({batch}, {KV_HEADS}, {GROUP}, {HEAD_DIM}) bf16, '
                     f'{"int8" if int8 else "bf16"} arena, BS {BS} '
                     f'T {T_WIDTH}, the {SHARED_HEAD_BLOCKS} head blocks '
                     f'shared by all {batch} slots, positions {last}, '
                     f'live keys {live_keys} ({unique_keys} distinct)',
            'splits': splits, 'split_len': split_len,
            'max_abs_err': err, 'ms': time_ms(kernel),
            'graph_ms': graph_ms(kernel),
            'plain_ms': time_ms(plain), 'bound_ms': b_ms, 'bound_by': by,
            'library_ms': time_ms(lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            'library_graph_ms': graph_ms(
                lambda: sdpa(qs, kt, vt, attn_mask=mask)),
            **_ptxas_of(ptxas, DECODE_KERNELS['pooled', label]),
        }
        log(f'  {name}: {entry["ms"]:.4f} ms (graph '
            f'{entry["graph_ms"]:.4f}), bound {b_ms:.4f} by {by}, plain '
            f'{entry["plain_ms"]:.4f}, SDPA {entry["library_ms"]:.4f}')
        out_entries[label] = entry
        del k, v, ks, vs, kt, vt
    torch.cuda.empty_cache()
    return out_entries


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
    from skypilot_tpu_torch.ops import _kernels
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
            da._WINDOW_CHUNK, _kernels.sm_count(torch.device('cuda')))
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
            **_ptxas_of(ptxas, DECODE_KERNELS['contig', label]),
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


def _debug_requests(vocab_size):
    """Phase 4's four requests: prompts of 5, 40, 100 and 17 tokens from
    seed 1, and their budgets of new tokens."""
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, vocab_size, size=n)]
               for n in (5, 40, 100, 17)]
    return prompts, [12, 9, 7, 10]


def slice_parity():
    from skypilot_tpu_torch.infer import block_pool, engine, llama_infer
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA_DEBUG
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   'cpu')
    params = {'cpu': params_cpu, 'cuda': _to_device(params_cpu, 'cuda')}
    prompts, budgets = _debug_requests(cfg.vocab_size)

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


def _grads_on(loss_fn, params, tokens, dev):
    """First-step gradients of loss_fn(params, {'tokens'}) on `dev`, from
    a copy of the params there; returned on the host."""
    from skypilot_tpu_torch.train import trainer
    p = trainer.tree_map(lambda t: t.requires_grad_(), _clone_to(params, dev))
    loss = loss_fn(p, {'tokens': torch.from_numpy(tokens).to(dev)})
    return [g.cpu() for g in torch.autograd.grad(loss,
                                                 trainer.tree_leaves(p))]


def _grads_close(label, got, want):
    """Card vs host gradients, leaf by leaf, within rtol 1e-4 and atol
    1e-4 x the leaf's largest element; none all zero.  Returns the
    largest error over that scale."""
    err = 0.0
    for g, w in zip(got, want):
        if not float(g.abs().max()) > 0:
            raise AssertionError(f'{label}: a zero gradient')
        scale = float(w.abs().max())
        err = max(err, float((g - w).abs().max()) / scale)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)
    return err


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
            grads[policy or remat, dev] = _grads_on(
                lambda p, b: llama.loss_fn(p, b, c), params, tokens, dev)
    for key in (False, True, 'dots'):
        err = _grads_close(f'remat={key}', grads[key, 'cuda'],
                           grads[key, 'cpu'])
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


def post_train_parity():
    """LoRA-SFT and LoRA-DPO on LLAMA_DEBUG f32, on the card (kernels) and
    the host (plain versions) from the same base and adapters (B drawn
    non-zero): first-step adapter gradients at train_parity's bound."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import dpo, lora, sft, trainer

    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
    lcfg = lora.LoraConfig(rank=4, alpha=8.0, targets='attn')
    gen = torch.Generator().manual_seed(2)
    adapters = trainer.tree_map(
        lambda t: t if t.any() else 0.02 * torch.randn(
            t.shape, generator=gen),
        lora.init_lora(params, lcfg, torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (6, 64), dtype=np.int32)
    mask = (rng.random((6, 63)) > 0.3).astype(np.float32)
    batches = {
        'sft': {'tokens': tokens[:4], 'loss_mask': mask[:4]},
        'dpo': {'tokens_chosen': tokens[:2], 'mask_chosen': mask[:2],
                'tokens_rejected': tokens[2:4], 'mask_rejected': mask[2:4]},
    }
    losses = {
        'sft': lambda base, ad, b: lora.wrap_loss(
            lambda p, bb: sft.sft_loss_fn(p, bb, cfg), base, lcfg)(ad, b),
        'dpo': lambda base, ad, b: dpo.dpo_loss_fn(
            lora.apply_lora(base, ad, lcfg), base, b, cfg),
    }
    for name, loss_fn in losses.items():
        grads = {}
        for dev in ('cpu', 'cuda'):
            ad = trainer.tree_map(lambda t: t.requires_grad_(),
                                  _clone_to(adapters, dev))
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batches[name].items()}
            loss = loss_fn(_clone_to(params, dev), ad, batch)
            grads[dev] = [g.cpu() for g in torch.autograd.grad(
                loss, trainer.tree_leaves(ad))]
        err = _grads_close(f'LoRA-{name}', grads['cuda'], grads['cpu'])
        log(f'  LoRA-{name} first-step adapter gradients ({len(grads["cpu"])}'
            f' leaves): card vs host max err/max|grad| {err:.2e} '
            f'(tolerance 1e-4)')


# A MoE config at LLAMA_DEBUG's attention widths (2 heads of 128 over one
# KV head: the card's kernels take head_dim 64, 128 or 256, MOE_DEBUG's is
# 32): 4 experts, top 2, f32, 2 layers.
def moe_debug_config():
    from skypilot_tpu_torch.models import moe
    return dataclasses.replace(moe.MOE_DEBUG, d_model=256, n_heads=2,
                               n_kv_heads=1, d_ff=512)


def moe_parity():
    """The MoE expert bank on the card (kernels, cuBLAS) and the host
    (plain versions) from the same f32 weights: identical greedy tokens
    on the host, the card eager and the card through graphs (the pooled
    plane, plain and spec_k=3: the bank inside every captured decode and
    verify chunk), and first-step gradients of moe.loss_fn card vs host
    under router_impl 'capacity' and 'dense' at train_parity's bound."""
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.train import trainer

    cfg = moe_debug_config()
    params_cpu = moe.init_params(cfg, torch.Generator().manual_seed(0),
                                 'cpu')
    params = {'cpu': params_cpu, 'cuda': _to_device(params_cpu, 'cuda')}
    prompts, budgets = _debug_requests(cfg.vocab_size)
    for label, extra in (('MoE plain', {}), ('MoE spec_k=3',
                                             dict(spec_k=3))):
        three = _card_and_host(label, _serve_debug, params, cfg, prompts,
                               budgets, extra)
        if extra and not three['card graphs'][0].spec_proposed:
            raise AssertionError(f'{label}: no verify chunk')
    tokens = next(trainer.synthetic_batches(4, 63, cfg.vocab_size))['tokens']
    for impl in ('capacity', 'dense'):
        c = dataclasses.replace(cfg, router_impl=impl)
        grads = {dev: _grads_on(lambda p, b: moe.loss_fn(p, b, c),
                                params_cpu, tokens, dev)
                 for dev in ('cpu', 'cuda')}
        err = _grads_close(f'MoE {impl}', grads['cuda'], grads['cpu'])
        log(f'  MoE first-step gradients router_impl={impl!r} '
            f'({len(grads["cpu"])} leaves): card vs host max err/max|grad| '
            f'{err:.2e} (tolerance 1e-4)')


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


def serve_path(label, params, gen_config, counters, graphs=None, cfg=None,
               model='llama3-8b'):
    """Serve the 8 requests (one burst, _burst) through the HTTP replica
    with every launch count set to 0 just before and read just after;
    returns (the counts, the migrations, each request's tokens, the
    printed stats).  Fails unless every request returns 48 in-range
    tokens and the pool comes back empty (on a legacy plane: every slot
    comes back free and frozen, and one short request afterwards shrinks
    the slot cache to its smallest bucket).  graphs: the batcher's
    argument (None: graphs on the card); cfg, model: the model's config
    (LLAMA3_8B by default) and the name the replica gives it."""
    from skypilot_tpu_torch.infer import engine, replica
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    cfg = cfg or llama.LLAMA3_8B
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
    server, thread = replica.serve(batcher, '127.0.0.1', 0, model)
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
    return launches, migrations, [r['output_ids'] for r in responses], stats


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
    return launches, stats


# ---- phase 9: checkpointing -------------------------------------------------

def _state_gb(cfg, mu_bytes=2):
    """GB of one checkpoint of `cfg` in bf16: params, mu, nu."""
    return cfg.num_params() * (2 + mu_bytes + 2) / 1e9


def _flat_state(tr):
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    named, _ = ckpt_format.flatten_with_keys(tr._state_dict())
    return named


def _sample(name, **labels):
    from skypilot_tpu_torch.telemetry import metrics
    return metrics.REGISTRY.get_sample_value(name, labels) or 0.0


def _grads_twice(tr, batch):
    """Is one forward and backward of the train step bitwise
    repeatable?  Two of them from the trainer's state on one batch."""
    tokens = {'tokens': tr._to_device(batch['tokens'])}
    runs = []
    for _ in range(2):
        loss = tr._loss_fn(tr.params, tokens)
        grads = torch.autograd.grad(loss, tr._leaves)
        runs.append((loss.detach(), grads))
    (l1, g1), (l2, g2) = runs
    same = [torch.equal(a, b) for a, b in zip(g1, g2)]
    spread = max(float((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp_min(1e-30))
                 for a, b in zip(g1, g2))
    return torch.equal(l1, l2) and all(same), spread


def checkpoint_path(cfg, train_config, counters, root, step_8a_s):
    """9a: Trainer A takes 8 steps of 8 x 1024 with async interval
    saves (every 4, keep_last 2); Trainer B from another seed restores
    the latest step, which must equal A's state leaf by leaf; then both
    take 3 more steps on the same batches.  Launch counts are taken over
    the whole run."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer

    def make(seed):
        params = llama.init_params(
            cfg, torch.Generator(device='cuda').manual_seed(seed), 'cuda')
        return trainer.Trainer(lambda p, b: llama.loss_fn(p, b, cfg), params,
                               train_config, device='cuda')

    batches = trainer.synthetic_batches(8, 1024, cfg.vocab_size)
    tr_a = make(0)
    manager = tr_a.enable_checkpointing(root, save_interval_steps=4,
                                        keep_last=2, emergency_save=False)
    snap0 = (_sample('skytpu_ckpt_save_duration_seconds_count',
                     phase='snapshot'),
             _sample('skytpu_ckpt_save_duration_seconds_sum',
                     phase='snapshot'))
    write0 = (_sample('skytpu_ckpt_save_duration_seconds_count',
                      phase='write'),
              _sample('skytpu_ckpt_save_duration_seconds_sum',
                      phase='write'))
    bytes0 = _sample('skytpu_ckpt_bytes_written_total')
    _zero(counters)
    step_s = []
    t0 = time.perf_counter()
    for _ in range(8):
        start = time.perf_counter()
        out = tr_a.run_step(next(batches))
        float(out['loss'])
        step_s.append(time.perf_counter() - start)
    loop_s = time.perf_counter() - t0
    start = time.perf_counter()
    tr_a.wait_for_checkpoints()
    drain_s = time.perf_counter() - start
    saves = (_sample('skytpu_ckpt_save_duration_seconds_count',
                     phase='write') - write0[0])
    write_s = (_sample('skytpu_ckpt_save_duration_seconds_sum',
                       phase='write') - write0[1])
    snap_s = (_sample('skytpu_ckpt_save_duration_seconds_sum',
                      phase='snapshot') - snap0[1])
    written = _sample('skytpu_ckpt_bytes_written_total') - bytes0
    if manager.all_steps() != [4, 8] or saves != 2:
        raise AssertionError(f'9a: committed {manager.all_steps()} after '
                             f'{saves} saves, expected [4, 8]')

    tr_b = make(1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    restored = tr_b.restore_latest(root)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - start
    if restored != 8 or tr_b.step != 8 or tr_b.opt_state['count'] != 8:
        raise AssertionError(f'9a: restored step {restored}, step '
                             f'{tr_b.step}, count {tr_b.opt_state["count"]}')
    leaves = 0
    for (key, a), (_, b) in zip(_flat_state(tr_a), _flat_state(tr_b)):
        if not torch.equal(a, b):
            raise AssertionError(f'9a: restored leaf {key} differs')
        leaves += 1
    batch = next(batches)
    deterministic, spread = _grads_twice(tr_b, batch)
    if not deterministic:
        raise AssertionError(
            f'9a: one forward and backward run twice from one state is '
            f'not bitwise repeatable (largest gradient difference '
            f'{spread} of the leaf max): a resume can no longer be held '
            f'to the uninterrupted run bitwise')
    continued = []
    for i in range(3):
        got_a, got_b = tr_a.run_step(batch), tr_b.run_step(batch)
        pair = [(float(got_a[k]), float(got_b[k]))
                for k in ('loss', 'grad_norm')]
        continued.append(pair)
        if any(x != y or not np.isfinite(x) for x, y in pair):
            raise AssertionError(f'9a: continued step {i + 1} differs '
                                 f'after the restore: {pair}')
        batch = next(batches)
    launches = _counts(counters)
    for (key, a), (_, b) in zip(_flat_state(tr_a), _flat_state(tr_b)):
        if not torch.equal(a, b):
            raise AssertionError(f'9a: leaf {key} differs 3 steps after '
                                 f'the restore')
    stats = {
        'card': CARD['line'], 'checkpoint_gb': written / saves / 1e9,
        'leaves': leaves, 'saves': saves,
        'snapshot_s_per_save': snap_s / saves,
        'write_commit_s_per_save': write_s / saves,
        'write_gb_per_s': written / write_s / 1e9,
        'drain_wait_s': drain_s, 'loop_s_8_steps': loop_s,
        'step_s': step_s,
        'step_s_save_in_flight': statistics.median(step_s[4:7]),
        'step_s_8a': step_8a_s,
        'restore_s': restore_s,
        'restore_gb_per_s': written / saves / restore_s / 1e9,
        'step_bitwise_repeatable': deterministic,
        'continued_loss_grad_norm_a_b': continued,
    }
    log('  9a async saves, restore, continue: ' + json.dumps(stats))
    tr_a.close()
    tr_b.close()
    del tr_a, tr_b
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def recovery_path(root):
    """9b: a managed job's recovery through the entry point.  The first
    child trains 16 steps in chunks of 4 and is sent SIGTERM once it has
    committed step 8 and started staging the next save; the relaunch
    with --resume auto must resume from the newest committed step and
    finish."""
    import signal as signal_module
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.train_llama',
           '--model-size', '1b', '--seq-len', '1024', '--batch-size', '8',
           '--steps', '16', '--checkpoint-every', '4',
           '--checkpoint-dir', root]
    lines = []

    def run(args, watch):
        err = open(os.path.join(root, f'stderr{len(args)}.txt'), 'w+')
        start = time.perf_counter()
        proc = subprocess.Popen(cmd + args, stdout=subprocess.PIPE,
                                stderr=err, text=True, cwd=HERE)
        seen = {}
        try:
            for line in proc.stdout:
                line = line.rstrip('\n')
                lines.append(line)
                seen.setdefault(line, time.perf_counter() - start)
                if watch(line, proc):
                    break
            proc.stdout.close()
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        return rc, seen, err.read()

    def stop_after_step_8(line, proc):
        if line != 'saved step 8':
            return False
        staging = ckpt_format.tmp_dir(root, 12)
        deadline = time.perf_counter() + 30
        while not os.path.isdir(staging) and time.perf_counter() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)                  # inside the save of step 12
        proc.send_signal(signal_module.SIGTERM)
        return True

    rc1, seen1, err1 = run([], stop_after_step_8)
    committed = ckpt_format.latest_step(root)
    torn = [n for n in os.listdir(root) if n.startswith('.tmp.')]
    if rc1 != -signal_module.SIGTERM or committed is None or committed < 8:
        raise AssertionError(f'9b: first run rc {rc1}, newest committed '
                             f'step {committed}:\n' + '\n'.join(lines)
                             + err1[-3000:])
    rc2, seen2, err2 = run(['--resume', 'auto'], lambda line, proc: False)
    resumed = f'resumed from step {committed}'
    final = [line for line in seen2 if line.startswith('final: loss=')]
    if rc2 != 0 or resumed not in seen2 or 'saved step 16' not in seen2 \
            or not final or not np.isfinite(float(final[0].split()[1][5:])):
        raise AssertionError(f'9b: relaunch rc {rc2}, expected '
                             f'{resumed!r}:\n' + '\n'.join(lines)
                             + err2[-3000:])
    stats = {
        'card': CARD['line'], 'newest_committed_at_sigterm': committed,
        'torn_staging_left': torn,
        'first_run_s_to_saved_step_8': seen1['saved step 8'],
        'recovery_s_relaunch_to_resumed': seen2[resumed],
        'relaunch_s_to_final': seen2[final[0]], 'final': final[0],
    }
    log('  9b managed-job recovery: ' + json.dumps(stats))


# ---- phase 10: post-training ------------------------------------------------

def _checksum(tree):
    """Per leaf, the float64 sum and sum of squares of its elements
    (taken in slices of 2^26 elements, so a leaf is never copied whole
    in f64)."""
    from skypilot_tpu_torch.train.trainer import tree_leaves
    out = []
    for leaf in tree_leaves(tree):
        flat = leaf.detach().reshape(-1)
        acc = torch.zeros(2, dtype=torch.float64, device=leaf.device)
        for i in range(0, flat.numel(), 1 << 26):
            c = flat[i:i + (1 << 26)].double()
            acc += torch.stack([c.sum(), (c * c).sum()])
        out.append(tuple(acc.tolist()))
    return out


def _text(rng, n):
    letters = np.array(list('abcdefghijklmnopqrstuvwxyz   .,'))
    return ''.join(rng.choice(letters, n))


def _write_jsonl(path, rows):
    with open(path, 'w', encoding='utf-8') as f:
        for row in rows:
            f.write(json.dumps(row) + '\n')
    return path


def _post_train_data(root, seed=0):
    """{prompt, completion} and {prompt, chosen, rejected} JSONL files of
    random letters from a seed: SFT examples of ~2,300 bytes (a 2,048
    token row is full: 512 prompt bytes, the rest completion), DPO pairs
    of ~1,100 bytes, and short files for the debug-size entry points."""
    rng = np.random.default_rng(seed)
    sft = _write_jsonl(os.path.join(root, 'sft.jsonl'), [
        {'prompt': _text(rng, 512), 'completion': _text(rng, 1800)}
        for _ in range(16)])
    dpo = _write_jsonl(os.path.join(root, 'dpo.jsonl'), [
        {'prompt': _text(rng, 256), 'chosen': _text(rng, 900),
         'rejected': _text(rng, 900)} for _ in range(8)])
    small_sft = _write_jsonl(os.path.join(root, 'sft_small.jsonl'), [
        {'prompt': _text(rng, 40), 'completion': _text(rng, 80)}
        for _ in range(8)])
    small_dpo = _write_jsonl(os.path.join(root, 'dpo_small.jsonl'), [
        {'prompt': _text(rng, 30), 'chosen': _text(rng, 50),
         'rejected': _text(rng, 50)} for _ in range(8)])
    return sft, dpo, small_sft, small_dpo


def _encode(vocab_size):
    return lambda text: [b % vocab_size for b in text.encode('utf-8')]


def _adapted_elements(base, lcfg):
    from skypilot_tpu_torch.train import lora
    pattern = re.compile(lcfg.target_pattern)
    return sum(leaf.numel() for path, leaf in lora._flatten_with_paths(base)
               if pattern.search('/'.join(path)))


def lora_sft_path(base, cfg, data, counters, steps=6,
                  label='10a LoRA-SFT LLAMA3_8B', n=None,
                  n_note='no embedding'):
    """10a (and 11c): LoRA-SFT through Trainer.fit on the frozen bf16
    base: rank 16, alpha 32 on the attn target, 2 x 2048 tokens a step.
    The base never requires grad and its float64 checksum is unchanged
    after the steps; every B has moved from zero.  MFU counts (4N +
    2N_adapted) a token, N the parameters without the embedding unless
    `n` (described by `n_note`) is given.  Returns (launches, stats)."""
    from skypilot_tpu_torch.train import lora, sft, trainer
    tag = label.split()[0]
    lcfg = lora.LoraConfig(rank=16, alpha=32.0, targets='attn')
    leaves = trainer.tree_leaves(base)
    if any(t.requires_grad for t in leaves):
        raise AssertionError(f'{tag}: a base leaf requires grad')
    before = _checksum(base)
    adapters = lora.init_lora(base, lcfg,
                              torch.Generator(device='cuda').manual_seed(1))
    tr = trainer.Trainer(
        lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, cfg), base, lcfg),
        adapters, trainer.TrainConfig(learning_rate=1e-4, warmup_steps=2,
                                      total_steps=steps), device='cuda')
    masked = []

    def batches():
        for batch in sft.sft_batches(data, _encode(cfg.vocab_size), 2, 2048):
            masked.append(float(batch['loss_mask'].sum()))
            yield batch
    n = n or cfg.num_params() - cfg.vocab_size * cfg.d_model
    n_adapted = _adapted_elements(base, lcfg)
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    out = tr.fit(batches(), steps, log_every=0, tokens_per_batch=2 * 2048,
                 flops_per_token=4 * n + 2 * n_adapted,
                 peak_flops=BF16_FLOPS)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(t.requires_grad for t in leaves):
        raise AssertionError(f'{tag}: a base leaf requires grad after fit')
    if _checksum(base) != before:
        raise AssertionError(f'{tag}: the frozen base changed')
    unmoved = ['/'.join(p) for p, leaf in lora._flatten_with_paths(tr.params)
               if p[-1] == 'b' and not float(leaf.detach().abs().max()) > 0]
    if unmoved or not np.isfinite(out['loss']):
        raise AssertionError(f'{tag}: loss {out["loss"]}, B still zero: '
                             f'{unmoved}')
    share = sum(masked[:steps]) / (steps * 2 * 2048)
    stats = {
        'card': CARD['line'], 'layers': cfg.n_layers,
        'adapters': lora.split_shapes(tr.params),
        'tokens_per_step': 2 * 2048, 'steps': steps,
        'step_time_s': out['step_time_s'],
        'tokens_per_s': out['tokens_per_sec'],
        'completion_tokens_per_s': out['tokens_per_sec'] * share,
        'mfu': out['mfu'],
        'mfu_formula': f'(4N + 2N_adapted) x tokens/s / '
                       f'{BF16_FLOPS / 1e12:g}e12, '
                       f'N = {n} ({n_note}), N_adapted = {n_adapted}',
        'last_loss': out['loss'], 'grad_norm': out['grad_norm'],
        'fit_wall_s': wall, 'resident_gb_before_fit': resident_gb,
        'peak_memory_gb': peak_gb,
        'base_checksum_unchanged': True,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log(f'  {label}: ' + json.dumps(stats))
    del tr, adapters
    return launches, stats


def lora_dpo_path(base, cfg, data, counters, steps=4, beta=0.1):
    """10b: LoRA-DPO on the same base, 2 pairs x 1024 tokens a step: the
    reference is the base (its passes under no_grad: K2 without its
    lse).  B = 0 at step 0, so the policy is the reference and the loss
    must be log 2 to f32 rounding (2 ulps).  Returns (launches, stats)."""
    import math
    from skypilot_tpu_torch.train import dpo, lora, trainer
    lcfg = lora.LoraConfig(rank=16, alpha=32.0, targets='attn')
    adapters = lora.init_lora(base, lcfg,
                              torch.Generator(device='cuda').manual_seed(2))

    def loss(ad, batch):
        return dpo.dpo_loss_fn(lora.apply_lora(base, ad, lcfg), base, batch,
                               cfg, beta=beta)
    tr = trainer.Trainer(loss, adapters, trainer.TrainConfig(
        learning_rate=1e-4, warmup_steps=1, total_steps=steps,
        weight_decay=0.0), device='cuda')
    batches = dpo.dpo_batches(data, _encode(cfg.vocab_size), 2, 1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    losses = [float(tr.run_step(next(batches))['loss'])
              for _ in range(steps)]
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = {k: torch.as_tensor(v, device='cuda')
             for k, v in next(batches).items()}
    metrics = {k: float(v) for k, v in dpo.dpo_metrics(
        lora.apply_lora(base, tr.params, lcfg), base, batch, cfg,
        beta=beta).items()}
    log2 = float(np.float32(math.log(2)))
    if abs(losses[0] - log2) > 2 * 2 ** -24 or not np.all(
            np.isfinite(losses)):
        raise AssertionError(f'10b: step-0 loss {losses[0]!r} is not log 2 '
                             f'({log2!r}): the reference and the policy '
                             f'passes compute differently; losses {losses}')
    no_lse = launches['flash_attention'] - launches['flash_attention[lse]']
    if no_lse <= 0:
        raise AssertionError('10b: K2 never ran without its lse (the '
                             'reference passes)')
    stats = {'card': CARD['line'], 'pairs_per_step': 2, 'seq_len': 1024,
             'beta': beta, 'losses': losses, 'step0_minus_log2':
             losses[0] - log2, 'steps_wall_s': wall,
             'step_s': wall / steps, 'dpo_metrics': metrics,
             'peak_memory_gb': peak_gb, 'k2_no_lse_launches': no_lse,
             'launches_per_step': {k: v / steps for k, v in
                                   launches.items() if v}}
    log('  10b LoRA-DPO LLAMA3_8B: ' + json.dumps(stats))
    del tr, adapters
    return launches, stats


def grpo_path(counters, steps=3):
    """10c: GRPO on LLAMA_1B at full size (group 8, 2 prompts a step,
    max_prompt_len 64, 32 new tokens, temperature 1, kl_coef 0.05, the
    entry point's token-band reward, lr 1e-4 as train_rl's default).  A
    greedy Generator over the Trainer's live tensors, its graphs
    captured before the first step, must after the steps give the tokens
    of a fresh Generator over a clone of the Trainer's params.  Returns
    (launches, stats)."""
    from skypilot_tpu_torch.infer.engine import Generator, GeneratorConfig
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import rl
    from skypilot_tpu_torch.train.train_rl import make_rewards
    from skypilot_tpu_torch.train.trainer import tree_leaves, tree_map
    cfg = llama.LLAMA_1B
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    tr = rl.GrpoTrainer(
        params, cfg, make_rewards(cfg.vocab_size)['token-band'],
        group_size=8, max_new_tokens=32, max_prompt_len=64, temperature=1.0,
        learning_rate=1e-4, kl_coef=0.05, total_steps=steps, device='cuda')
    del params
    initial = [t.detach().clone() for t in tree_leaves(tr.trainer.params)]
    gen_config = GeneratorConfig(max_seq_len=tr._gen_config.max_seq_len,
                                 batch_size=8)
    live = Generator(tr.trainer.params, cfg, gen_config, device='cuda')
    probe = [[(7 * (i + 3)) % cfg.vocab_size, 17, 42 + i] for i in range(8)]
    with torch.no_grad():
        before = live.generate(probe, max_new_tokens=32)
    prompts = [[(11 * (i + 1)) % cfg.vocab_size,
                (13 * (i + 1)) % cfg.vocab_size] for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    history = [tr.step(prompts) for _ in range(steps)]
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(m['loss']) for m in history):
        raise AssertionError(f'10c: losses {history}')
    moved = sum(not torch.equal(a, b) for a, b in
                zip(initial, tree_leaves(tr.trainer.params)))
    if not moved:
        raise AssertionError('10c: the policy never changed')
    clone = tree_map(lambda t: t.detach().clone(), tr.trainer.params)
    with torch.no_grad():
        after = live.generate(probe, max_new_tokens=32)
        fresh = Generator(clone, cfg, gen_config,
                          device='cuda').generate(probe, max_new_tokens=32)
    _same_tokens('10c: the live Generator after the updates vs a fresh one '
                 'over a clone', after, fresh)
    stats = {
        'card': CARD['line'], 'group': 8, 'prompts_per_step': 2,
        'new_tokens': 32, 'kl_coef': 0.05, 'steps': steps,
        'rollout_s': [m['rollout_s'] for m in history],
        'update_s': [m['update_s'] for m in history],
        'reward_mean': [m['reward_mean'] for m in history],
        'loss': [m['loss'] for m in history],
        'leaves_moved': f'{moved} of {len(initial)}',
        'live_greedy_changed_by_the_updates': after != before,
        'live_generator_graph_replays': live.graphs.replays
        if live.graphs is not None else 0,
        'peak_memory_gb': peak_gb,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log('  10c GRPO LLAMA_1B: ' + json.dumps(stats))
    tr.close()
    del tr, live, clone, initial
    return launches, stats


def _losses(stdout, prefix):
    return [float(line.split('loss=')[1].split()[0])
            for line in stdout.splitlines() if line.startswith(prefix)]


def entry_points_path(root, small_sft, small_dpo):
    """10d: train_sft (LoRA, checkpoint, merge), train_dpo (LoRA) and
    train_rl at debug size as child processes, run side by side.  The
    merged file must equal, bitwise, merge_lora of the adapters restored
    from train_sft's checkpoint, and give the same greedy tokens through
    the Generator; all three must finish with finite losses."""
    from skypilot_tpu_torch.ckpt import format as ckpt_format
    from skypilot_tpu_torch.infer.engine import Generator, GeneratorConfig
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import lora, sft, trainer
    ckpt, merged = os.path.join(root, 'ckpt'), os.path.join(root, 'merge')
    mod = 'skypilot_tpu_torch.train.'
    cmds = {
        'sft': [mod + 'train_sft', '--data-file', small_sft, '--seq-len',
                '128', '--steps', '4', '--log-every', '1', '--lora-rank',
                '8', '--checkpoint-dir', ckpt, '--merge-save', merged],
        'dpo': [mod + 'train_dpo', '--data-file', small_dpo, '--seq-len',
                '96', '--steps', '3', '--log-every', '1', '--lora-rank',
                '8'],
        'rl': [mod + 'train_rl', '--model-size', 'debug', '--steps', '3'],
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, '-m'] + v, cwd=HERE,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in cmds.items()}
    outs = {}
    try:
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            outs[key] = (proc.returncode, out, err,
                         time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for key, (rc, out, err, _) in outs.items():
        prefix = 'rl step ' if key == 'rl' else 'step '
        losses = _losses(out, prefix)
        if rc != 0 or len(losses) != 3 + (key == 'sft') or not np.all(
                np.isfinite(losses)):
            raise AssertionError(f'10d {key}: rc {rc}\n{out}\n{err[-3000:]}')
    cfg = llama.LLAMA_DEBUG
    base = llama.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                             'cuda')
    lcfg = lora.LoraConfig(rank=8)
    tr = trainer.Trainer(
        lora.wrap_loss(lambda p, b: sft.sft_loss_fn(p, b, cfg), base, lcfg),
        lora.init_lora(base, lcfg,
                       torch.Generator(device='cuda').manual_seed(1)),
        device='cuda')
    if tr.restore_latest(ckpt) != 4:
        raise AssertionError('10d: train_sft did not commit step 4')
    want = lora.merge_lora(base, tr.params, lcfg)
    got = ckpt_format.restore_pytree(os.path.join(merged, 'merged'), 0,
                                     {'params': want})['params']
    got_leaves = trainer.tree_leaves(got)
    want_leaves = trainer.tree_leaves(want)
    if not all(torch.equal(g, w.cpu()) for g, w in
               zip(got_leaves, want_leaves)):
        raise AssertionError('10d: the merged file differs from merge_lora '
                             'of the restored adapters')
    gen_config = GeneratorConfig(max_seq_len=128, batch_size=2)
    prompts = [[5, 9, 11], [7, 3, 300, 2]]
    with torch.no_grad():
        tokens = [Generator(tree, cfg, gen_config, device='cuda').generate(
            prompts, max_new_tokens=16)
            for tree in (trainer.tree_map(lambda t: t.cuda(), got), want)]
    _same_tokens('10d: greedy tokens of the merged file vs the in-process '
                 'merge', tokens[0], tokens[1])
    stats = {'card': CARD['line'],
             'children_s': {k: v[3] for k, v in outs.items()},
             'sft_losses': _losses(outs['sft'][1], 'step '),
             'dpo_losses': _losses(outs['dpo'][1], 'step '),
             'rl_losses': _losses(outs['rl'][1], 'rl step '),
             'merged_bitwise': True, 'greedy_tokens': tokens[0]}
    log('  10d entry points: ' + json.dumps(stats))
    tr.close()


# ---- phase 11: Mixtral-8x7B widths -----------------------------------------

def mixtral_config(n_layers, **overrides):
    """Mixtral-8x7B-v0.1's published widths, from its config.json on the
    Hugging Face hub (mistralai/Mixtral-8x7B-v0.1): vocab 32000, hidden
    4096, intermediate 14336, 32 heads over 8 KV heads (head_dim 128), 8
    local experts and 2 a token, rope_theta 1e6, rms_norm_eps 1e-5,
    max_position_embeddings 32768, router_aux_loss_coef 0.02; and
    router_impl 'dense', as skypilot_tpu/models/convert.py sets it for a
    converted Mixtral.  bf16, remat.  The depth is the caller's: the
    published 32 layers are 46.70B parameters, 93.4 GB in bf16 (the
    expert banks alone 90.2 GB, which int8 weights leave in bf16), past
    the card's 80 GB."""
    from skypilot_tpu_torch.models import moe
    return dataclasses.replace(moe.MoeConfig(
        vocab_size=32000, d_model=4096, n_layers=n_layers, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=32768, rope_theta=1e6,
        norm_eps=1e-5, n_experts=8, top_k=2, router_aux_weight=0.02,
        router_impl='dense', dtype=torch.bfloat16, remat=True), **overrides)


def moe_active_params(cfg):
    """(The parameters a token runs through in the layers: attention,
    the router and top_k experts a layer; the lm_head's).  The embedding
    is a row gather.  The dense formulation's unchosen experts, the
    capacity slots' padding and the dispatch/combine products are
    overhead, not model FLOPs."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    layer = attn + d * cfg.n_experts + cfg.top_k * 3 * d * cfg.d_ff
    return cfg.n_layers * layer, d * cfg.vocab_size


def streamed_bytes(tree, key=''):
    """Bytes a decode step streams from the parameter tree: every leaf
    but the embedding table (a row gather)."""
    if isinstance(tree, dict):
        return sum(streamed_bytes(v, k) for k, v in tree.items())
    return 0 if key == 'embed' else tree.numel() * tree.element_size()


def bounded_serve_path(label, params, cfg, counters, model):
    """Phase 5's 8 requests (one burst, 48 new tokens each, greedy)
    through the replica and the ContinuousBatcher's CUDA graphs on the
    pooled plane, batch 8, max_seq_len 2048, prefill_chunk 256,
    decode_chunk 16 (11a, 12a, 12b).  Prints, beside serve_path's stats,
    the decode step's bound: a step streams every parameter but the
    embedding (a row gather), so it takes at least those bytes over 3.35
    TB/s (for 11a's dense formulation, every bank).  Returns (launches,
    stats)."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    gen_config = GeneratorConfig(max_seq_len=2048, batch_size=8,
                                 prefill_chunk=256)
    launches, _, _, stats = serve_path(label, params, gen_config, counters,
                                       cfg=cfg, model=model)
    nbytes = streamed_bytes(params)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # Decode steps of the run: every step runs 8 slots, live or not.
    steps = stats['decode_tokens'] / stats['live_slot_share'] / 8
    step_ms = (stats['decode_seconds'] - stats['graph_capture_s']) \
        / steps * 1e3
    bound = {'card': CARD['line'], 'streamed_gb_a_step': nbytes / 1e9,
             'step_bound_ms': bound_ms,
             'batch8_tokens_per_s_bound': 8 / bound_ms * 1e3,
             'decode_steps': steps, 'step_ms_without_capture': step_ms,
             'step_share_of_bound': bound_ms / step_ms}
    log(f'  {label.split()[0]} decode bound (bytes / 3.35 TB/s): '
        + json.dumps(bound))
    return launches, dict(stats, **bound)


def mixtral_train_path(counters, steps=6, batch=2, seq=4096):
    """11b: full-parameter Trainer.fit of moe.loss_fn through
    train_moe.make_trainer at Mixtral's widths, depth 2, router_impl
    'capacity', remat, 2 x 4096 tokens a step (bf16 params, grads, mu
    and nu: 8 bytes a parameter).  Fails unless the first and last
    losses and the router aux losses are finite.  Prints step time,
    tokens/s, MFU = 6 N_active x tokens/s / 989e12 with and without the
    lm_head, peak memory, launches a step, the first and last loss and
    the aux loss before and after.  Returns (launches, stats)."""
    from skypilot_tpu_torch.models import llama, moe
    from skypilot_tpu_torch.train import train_moe, trainer

    cfg = mixtral_config(2, router_impl='capacity')
    tr = train_moe.make_trainer(cfg, steps, 'cuda')
    first = torch.as_tensor(next(trainer.synthetic_batches(
        batch, seq, cfg.vocab_size))['tokens'], device='cuda')

    def loss_and_aux():
        with torch.no_grad():
            logits, aux = moe.forward(tr.params, first[:, :-1], cfg)
            ce = -llama.token_logprobs(logits, first[:, 1:]).mean()
            return float(ce + cfg.router_aux_weight * aux), float(aux)
    first_loss, first_aux = loss_and_aux()
    n_layers, n_head = moe_active_params(cfg)
    n_all = cfg.num_params()
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    out = tr.fit(trainer.synthetic_batches(batch, seq, cfg.vocab_size),
                 steps, log_every=0, tokens_per_batch=batch * seq,
                 flops_per_token=6 * (n_layers + n_head),
                 peak_flops=BF16_FLOPS)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last_aux = loss_and_aux()[1]
    if not all(np.isfinite([first_loss, out['loss'], first_aux, last_aux])):
        raise AssertionError(f'11b: loss {first_loss} -> {out["loss"]}, '
                             f'aux {first_aux} -> {last_aux}')
    stats = {
        'card': CARD['line'], 'layers': cfg.n_layers,
        'params_b': n_all / 1e9, 'state_gb': n_all * 8 / 1e9,
        'active_params_b': (n_layers + n_head) / 1e9,
        'tokens_per_step': batch * seq, 'steps': steps,
        'step_time_s': out['step_time_s'],
        'tokens_per_s': out['tokens_per_sec'],
        'mfu_6n_active': out['mfu'],
        'mfu_6n_active_without_lm_head': (6 * n_layers * out['tokens_per_sec']
                                          / BF16_FLOPS),
        'mfu_formula': f'6 N_active x tokens/s / {BF16_FLOPS / 1e12:g}e12, '
                       f'N_active = {n_layers} (attention, router, top_k = '
                       f'{cfg.top_k} experts a layer) + {n_head} (lm_head)',
        'first_loss': first_loss, 'last_loss': out['loss'],
        'router_aux_first': first_aux, 'router_aux_last': last_aux,
        'grad_norm': out['grad_norm'], 'fit_wall_s': wall,
        'resident_gb_before_fit': resident_gb, 'peak_memory_gb': peak_gb,
        'launches_per_step': {k: v / steps for k, v in launches.items()
                              if v},
    }
    log('  11b train Mixtral widths, 2 layers, capacity: '
        + json.dumps(stats))
    tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def mixtral_path(counters, paths):
    """Phase 11 on one 16-layer base: (a) served; (c) LoRA-SFT of it once
    the batcher and its graph pool are released (so the base is drawn and
    freed once); then (b), a 2-layer model of its own, trained."""
    from skypilot_tpu_torch.models import moe
    cfg = mixtral_config(16)
    t0 = time.perf_counter()
    base = moe.init_params(cfg, torch.Generator(device='cuda').manual_seed(0),
                           'cuda')
    torch.cuda.synchronize()
    log(f'  Mixtral widths bf16 random weights, {cfg.n_layers} of 32 layers: '
        f'{cfg.num_params() / 1e9:.2f}B params, '
        f'{torch.cuda.memory_allocated() / 1e9:.2f} GB, in '
        f'{time.perf_counter() - t0:.1f} s')
    sub = time.perf_counter()
    paths['11a'], _ = bounded_serve_path(
        '11a Mixtral widths, 16 layers', base, cfg, counters,
        'mixtral-8x7b-16-layers')
    log(f'  11a: {time.perf_counter() - sub:.1f} s')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_moe_')
    try:
        sft_data = _post_train_data(scratch)[0]
        sub = time.perf_counter()
        n_layers, n_head = moe_active_params(cfg)
        paths['11c'], _ = lora_sft_path(
            base, dataclasses.replace(cfg, loss_chunk=512), sft_data,
            counters, steps=4, label='11c LoRA-SFT Mixtral widths, 16 layers',
            n=n_layers + n_head,
            n_note=f'active: attention, router and top_k = {cfg.top_k} '
                   f'experts a layer, and the lm_head; the dense '
                   f'formulation runs E/top_k = '
                   f'{cfg.n_experts // cfg.top_k}x the expert FLOPs counted')
        log(f'  11c: {time.perf_counter() - sub:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    sub = time.perf_counter()
    paths['11b'], _ = mixtral_train_path(counters)
    log(f'  11b: {time.perf_counter() - sub:.1f} s')


# ---- phase 12: HF checkpoints ---------------------------------------------

# Published configs, typed from each model's config.json on the Hugging
# Face hub (google/gemma-7b and Qwen/Qwen2.5-1.5B); nothing is fetched.
GEMMA_7B = {
    'architectures': ['GemmaForCausalLM'], 'model_type': 'gemma',
    'vocab_size': 256000, 'hidden_size': 3072, 'intermediate_size': 24576,
    'num_hidden_layers': 28, 'num_attention_heads': 16,
    'num_key_value_heads': 16, 'head_dim': 256, 'hidden_act': 'gelu',
    'rms_norm_eps': 1e-6, 'rope_theta': 10000.0, 'rope_scaling': None,
    'max_position_embeddings': 8192, 'attention_bias': False,
    'tie_word_embeddings': True, 'bos_token_id': 2, 'eos_token_id': 1,
    'pad_token_id': 0, 'torch_dtype': 'bfloat16'}
QWEN25_1_5B = {
    'architectures': ['Qwen2ForCausalLM'], 'model_type': 'qwen2',
    'vocab_size': 151936, 'hidden_size': 1536, 'intermediate_size': 8960,
    'num_hidden_layers': 28, 'num_attention_heads': 12,
    'num_key_value_heads': 2, 'hidden_act': 'silu', 'rms_norm_eps': 1e-6,
    'rope_theta': 1000000.0, 'max_position_embeddings': 131072,
    'max_window_layers': 28, 'sliding_window': 131072,
    'use_sliding_window': False, 'use_mrope': False,
    'tie_word_embeddings': True, 'bos_token_id': 151643,
    'eos_token_id': 151643, 'torch_dtype': 'bfloat16'}

_ST_DTYPES = {torch.bfloat16: 'BF16', torch.float16: 'F16',
              torch.float32: 'F32'}


def hf_tensor_specs(hf_config):
    """[(name, shape)] of an HF checkpoint of the llama, mistral, gemma,
    qwen2 or mixtral family, in HF's layout ((out, in) linears), in the
    order HF's modules hold them; no lm_head.weight when the embeddings
    are tied."""
    c = hf_config
    d, ff, vocab = c['hidden_size'], c['intermediate_size'], c['vocab_size']
    hd = c.get('head_dim') or d // c['num_attention_heads']
    q, kv = c['num_attention_heads'] * hd, c['num_key_value_heads'] * hd
    specs = [('model.embed_tokens.weight', (vocab, d))]
    for i in range(c['num_hidden_layers']):
        p = f'model.layers.{i}.'
        specs += [(p + 'self_attn.q_proj.weight', (q, d)),
                  (p + 'self_attn.k_proj.weight', (kv, d)),
                  (p + 'self_attn.v_proj.weight', (kv, d)),
                  (p + 'self_attn.o_proj.weight', (d, q))]
        if c['model_type'] == 'qwen2':
            specs += [(p + 'self_attn.q_proj.bias', (q,)),
                      (p + 'self_attn.k_proj.bias', (kv,)),
                      (p + 'self_attn.v_proj.bias', (kv,))]
        if c['model_type'] == 'mixtral':
            m = p + 'block_sparse_moe.'
            specs.append((m + 'gate.weight', (c['num_local_experts'], d)))
            for e in range(c['num_local_experts']):
                specs += [(f'{m}experts.{e}.w1.weight', (ff, d)),
                          (f'{m}experts.{e}.w2.weight', (d, ff)),
                          (f'{m}experts.{e}.w3.weight', (ff, d))]
        else:
            specs += [(p + 'mlp.gate_proj.weight', (ff, d)),
                      (p + 'mlp.up_proj.weight', (ff, d)),
                      (p + 'mlp.down_proj.weight', (d, ff))]
        specs += [(p + 'input_layernorm.weight', (d,)),
                  (p + 'post_attention_layernorm.weight', (d,))]
    specs.append(('model.norm.weight', (d,)))
    if not c.get('tie_word_embeddings', False):
        specs.append(('lm_head.weight', (vocab, d)))
    return specs


def draw_hf_tensor(name, shape, seed, dtype, device, gemma=False):
    """One random tensor of a checkpoint, a function of (seed, name) on a
    given device: linears at fan_in^-0.5, the embedding at 0.02, biases
    at 0.02, norms 1 + N(0, 0.1), stored as w - 1 (N(0, 0.1)) for Gemma,
    whose runtime scale is 1 + w."""
    gen = torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + zlib.crc32(name.encode()))
    x = torch.randn(shape, generator=gen, device=device)
    if name.endswith('norm.weight'):
        x = x * 0.1 + (0.0 if gemma else 1.0)
    elif name.endswith('bias') or name.endswith('embed_tokens.weight'):
        x = x * 0.02
    else:
        x = x * shape[-1] ** -0.5
    return x.to(dtype)


def write_hf_checkpoint(directory, hf_config, make, dtype=torch.bfloat16,
                        shard_bytes=None):
    """Write a checkpoint directory in HF's layout: config.json, and the
    tensors of hf_tensor_specs(hf_config) in `dtype`, `make(name, shape)`
    drawing each as it is written (one tensor on the host at a time), as
    safetensors files: one, or shards of at most `shard_bytes` with a
    model.safetensors.index.json.  The format by hand: an 8-byte
    little-endian header length, the JSON header (padded with spaces to
    8 bytes) whose data_offsets count from its end, then the raw
    little-endian data.  Returns the bytes of tensor data written."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump(hf_config, f, indent=2)
    itemsize = torch.empty((), dtype=dtype).element_size()
    shards, size = [[]], 0
    for name, shape in hf_tensor_specs(hf_config):
        n = int(np.prod(shape)) * itemsize
        if shards[-1] and shard_bytes and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((name, shape, n))
        size += n
    weight_map, total = {}, 0
    for s, shard in enumerate(shards):
        fname = ('model.safetensors' if len(shards) == 1 else
                 f'model-{s + 1:05d}-of-{len(shards):05d}.safetensors')
        header, offset = {'__metadata__': {'format': 'pt'}}, 0
        for name, shape, n in shard:
            header[name] = {'dtype': _ST_DTYPES[dtype], 'shape': list(shape),
                            'data_offsets': [offset, offset + n]}
            offset += n
        raw = json.dumps(header).encode()
        raw += b' ' * (-len(raw) % 8)
        with open(os.path.join(directory, fname), 'wb') as f:
            f.write(struct.pack('<Q', len(raw)))
            f.write(raw)
            for name, shape, n in shard:
                t = make(name, shape).to('cpu', dtype).contiguous()
                if tuple(t.shape) != tuple(shape):
                    raise AssertionError(f'{name}: drew {tuple(t.shape)}')
                f.write(t.reshape(-1).view(torch.uint8).numpy())
                weight_map[name] = fname
                total += n
    if len(shards) > 1:
        with open(os.path.join(directory, 'model.safetensors.index.json'),
                  'w', encoding='utf-8') as f:
            json.dump({'metadata': {'total_size': total},
                       'weight_map': weight_map}, f, indent=2)
    return total


# HF name -> (tree path, transposed) of the leaf a tensor lands in; the
# groups of the pattern are the layer and, for an expert, the expert.
HF_TO_TREE = [
    (r'model\.embed_tokens\.weight', ('embed',), False),
    (r'model\.layers\.(\d+)\.input_layernorm\.weight', ('layers', 'ln1'),
     False),
    (r'model\.layers\.(\d+)\.post_attention_layernorm\.weight',
     ('layers', 'ln2'), False),
    (r'model\.layers\.(\d+)\.self_attn\.([qkvo])_proj\.weight',
     ('layers', 'attn', 'w{}'), True),
    (r'model\.layers\.(\d+)\.self_attn\.([qkv])_proj\.bias',
     ('layers', 'attn', 'b{}'), False),
    (r'model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight',
     ('layers', 'mlp', 'w_{}'), True),
    (r'model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight',
     ('layers', 'moe', 'router'), True),
    (r'model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w([123])'
     r'\.weight', ('layers', 'moe', None), True),
    (r'model\.norm\.weight', ('final_norm',), False),
    (r'lm_head\.weight', ('lm_head',), True),
]
_EXPERT_LEAF = {'1': 'w_gate', '3': 'w_up', '2': 'w_down'}


def _bits_sum(t):
    """A checksum of a tensor's bits: the int64 sum of its 16- or 32-bit
    words (transposes and stacking keep it), taken in slices of 2^26
    words so no int64 copy of a whole leaf is made."""
    words = torch.int16 if t.element_size() == 2 else torch.int32
    flat = t.contiguous().view(words).reshape(-1)
    return sum(int(flat[i:i + (1 << 26)].sum(dtype=torch.int64))
               for i in range(0, flat.numel(), 1 << 26))


def verify_hf_leaves(tree, hf_config, seed, dtype, device):
    """Every leaf of a converted tree against the tensors the writer drew
    (drawn again, one at a time, on `device`): each tensor's slice
    bitwise equal to its expected value (transposed for a linear, the
    norm offset 1 added in f32 and rounded once for Gemma), a tied
    lm_head bitwise the embedding's transpose, and each leaf's checksum
    equal to the sum of its expected tensors'.  Returns the checksums."""
    gemma = hf_config['model_type'] == 'gemma'
    want = {}
    for name, shape in hf_tensor_specs(hf_config):
        x = draw_hf_tensor(name, shape, seed, dtype, device, gemma)
        for pattern, path, transposed in HF_TO_TREE:
            m = re.fullmatch(pattern, name)
            if m:
                break
        else:
            raise AssertionError(f'{name}: no leaf for it')
        groups = m.groups()
        if path[-1] is None:
            path = path[:-1] + (_EXPERT_LEAF[groups[2]],)
            index = (int(groups[0]), int(groups[1]))
        else:
            if '{}' in path[-1]:
                path = path[:-1] + (path[-1].format(groups[1]),)
            index = (int(groups[0]),) if groups else ()
        if gemma and name.endswith('norm.weight'):
            x = (x.float() + 1.0).to(dtype)
        expected = x.T if transposed else x
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if not torch.equal(leaf[index], expected):
            raise AssertionError(f'{name}: its slice of {"/".join(path)} is '
                                 f'not bitwise the tensor drawn')
        key = '/'.join(path)
        want[key] = want.get(key, 0) + _bits_sum(expected)
        del x, expected
    if 'lm_head' not in want:     # tied: the transposed embedding
        if not torch.equal(tree['lm_head'], tree['embed'].T):
            raise AssertionError('tied lm_head is not the embedding^T')
        want['lm_head'] = want['embed']
    from skypilot_tpu_torch.train.trainer import tree_leaves
    got = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            else:
                got['/'.join(path + [k])] = _bits_sum(v)
    walk(tree, [])
    if got != want:
        raise AssertionError(f'leaf checksums differ: {got} vs {want}')
    if len(got) != len(tree_leaves(tree)):
        raise AssertionError('a leaf was not checked')
    return got


def _vm_rss():
    """The process's resident set in bytes (/proc/self/status VmRSS)."""
    with open('/proc/self/status', encoding='ascii') as f:
        for line in f:
            if line.startswith('VmRSS:'):
                return int(line.split()[1]) * 1024
    raise AssertionError('/proc/self/status reports no VmRSS')


class RssPeak:
    """The host's peak resident set during a block: VmRSS sampled every
    2 ms by a thread, against VmRSS at the start."""

    def __enter__(self):
        self.start = self.peak = _vm_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, _vm_rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _vm_rss())
        return False

    def stats(self):
        return {'host_rss_start_gb': self.start / 1e9,
                'host_peak_growth_gb_sampled': (self.peak - self.start) / 1e9}


def hf_load_path(label, hf_config, root, seed=0, dtype=torch.bfloat16,
                 shard_bytes=5 << 30):
    """Write a random checkpoint of `hf_config` in HF's layout under
    root (drawn on the card from `seed`; several shards with an index
    past `shard_bytes`), then load it with convert.load_hf_model onto the
    card.  Fails first if the disk under root is short, naming the bytes
    it needs.  Returns (params, config, directory, stats): seconds, GB,
    GB/s, the host's peak RSS growth, the device's peak, the leaf
    checksums (verify_hf_leaves)."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.train import trainer
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = sum(int(np.prod(s)) for _, s in
                 hf_tensor_specs(hf_config)) * itemsize
    need = nbytes + (1 << 30)
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f'{label} needs {need} bytes free under {root} '
                             f'for its checkpoint, {free} are free')
    directory = os.path.join(root, label.split()[0])
    gemma = hf_config['model_type'] == 'gemma'
    t0 = time.perf_counter()
    write_hf_checkpoint(
        directory, hf_config,
        lambda name, shape: draw_hf_tensor(name, shape, seed, dtype, 'cuda',
                                           gemma),
        dtype, shard_bytes)
    write_s = time.perf_counter() - t0
    files = sorted(os.listdir(directory))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dev0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t0 = time.perf_counter()
        params, cfg = convert.load_hf_model(directory, dtype=dtype,
                                            device='cuda')
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    device_peak = torch.cuda.max_memory_allocated()
    tree_bytes = sum(t.numel() * t.element_size()
                     for t in trainer.tree_leaves(params))
    t0 = time.perf_counter()
    checksums = verify_hf_leaves(params, hf_config, seed, dtype, 'cuda')
    stats = {
        'card': CARD['line'], 'files': files,
        'file_params_b': nbytes / itemsize / 1e9, 'file_gb': nbytes / 1e9,
        'tree_params_b': cfg.num_params() / 1e9, 'tree_gb': tree_bytes / 1e9,
        'write_s': write_s, 'load_s': load_s,
        'load_gb_per_s': nbytes / load_s / 1e9,
        **rss.stats(),
        'host_peak_growth_below_model': rss.peak - rss.start < nbytes,
        'device_gb_before': dev0 / 1e9,
        'device_peak_gb_during_load': device_peak / 1e9,
        'device_resident_gb_after': torch.cuda.memory_allocated() / 1e9,
        'leaves_bitwise': len(checksums), 'verify_s': time.perf_counter() - t0,
        'checksum_total': sum(checksums.values()),
    }
    if not stats['host_peak_growth_below_model']:
        raise AssertionError(f'{label}: the host grew by '
                             f'{(rss.peak - rss.start) / 1e9:.2f} GB during '
                             f'the load, the model is {nbytes / 1e9:.2f}')
    log(f'  {label} load: ' + json.dumps(stats))
    return params, cfg, directory, stats


def gemma_path(counters, paths, root):
    """12a: Gemma-7B's published widths at full depth from a checkpoint
    the script writes (17.08 GB, bf16, tied, norms stored as w - 1),
    loaded by convert.load_hf_model and served as phase 5 serves
    LLAMA3_8B; the directory is deleted when 12a ends."""
    try:
        params, cfg, _, load = hf_load_path('12a Gemma-7B', GEMMA_7B, root)
        paths['12a'], serve = bounded_serve_path('12a Gemma-7B', params, cfg,
                                                 counters, 'gemma-7b')
    finally:
        shutil.rmtree(os.path.join(root, '12a'), ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return load, serve


def qwen_path(counters, paths, root):
    """12b: Qwen2.5-1.5B's published widths at full depth (3.09 GB, bf16,
    q/k/v biases, G 6, tied) loaded and served as 12a; then LoRA-SFT of
    the loaded base in this process (lora_sft_path: rank 16 on attn, 3
    steps of 2 x 2048 tokens, loss_chunk 512), and the entry point
    train_sft --hf-model DIR --lora-rank 16 --steps 3 as a child
    process, which must print 3 finite losses."""
    params, cfg, directory, load = hf_load_path('12b Qwen2.5-1.5B',
                                                QWEN25_1_5B, root)
    paths['12b'], serve = bounded_serve_path('12b Qwen2.5-1.5B', params,
                                             cfg, counters, 'qwen2.5-1.5b')
    gc.collect()
    torch.cuda.empty_cache()
    sft_data = _post_train_data(root)[0]
    paths['12b-sft'], sft_stats = lora_sft_path(
        params, dataclasses.replace(cfg, loss_chunk=512, remat=True,
                                    remat_policy='dots'),
        sft_data, counters, steps=3, label='12b LoRA-SFT Qwen2.5-1.5B')
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.train_sft',
         '--hf-model', directory, '--data-file', sft_data, '--seq-len',
         '2048', '--steps', '3', '--log-every', '1', '--lora-rank', '16',
         '--loss-chunk', '512'], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    losses = _losses(proc.stdout, 'step ')
    if proc.returncode != 0 or len(losses) != 3 or not np.all(
            np.isfinite(losses)):
        raise AssertionError(f'12b train_sft --hf-model: rc '
                             f'{proc.returncode}\n{proc.stdout}\n'
                             f'{proc.stderr[-3000:]}')
    child = {'card': CARD['line'], 'seconds': time.perf_counter() - t0,
             'losses': losses, 'first_line': proc.stdout.splitlines()[0]}
    log('  12b train_sft --hf-model (child): ' + json.dumps(child))
    return load, serve, sft_stats, child


# 12c's debug-size configs: Gemma-like (head_dim 256 decoupled from
# hidden / heads, gelu, the (1 + w) norms, tied) and Qwen2-like (q/k/v
# biases, 6 query heads over 1 KV head, tied), f32.
HF_DEBUG = {
    'Gemma-like': dict(
        model_type='gemma', vocab_size=512, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, head_dim=256, hidden_act='gelu',
        rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=512,
        tie_word_embeddings=True),
    'Qwen2-like': dict(
        model_type='qwen2', vocab_size=512, hidden_size=768,
        intermediate_size=1024, num_hidden_layers=2, num_attention_heads=6,
        num_key_value_heads=1, rms_norm_eps=1e-6, rope_theta=1e6,
        max_position_embeddings=4096, use_sliding_window=False,
        tie_word_embeddings=True),
}


def hf_parity(root):
    """12c: each HF_DEBUG config written (f32, drawn on the host, sharded
    with an index) and loaded on the host and on the card: the same
    config, every leaf bitwise the same on both and against the draws;
    the first-step logits allclose (LOGITS_TOL), and phase 4's requests
    served with identical greedy tokens on the host, the card eagerly
    and the card through graphs."""
    from skypilot_tpu_torch.models import convert, llama
    from skypilot_tpu_torch.train import trainer
    for label, hf_config in HF_DEBUG.items():
        directory = os.path.join(root, label)
        gemma = hf_config['model_type'] == 'gemma'
        write_hf_checkpoint(
            directory, hf_config,
            lambda name, shape: draw_hf_tensor(name, shape, 1, torch.float32,
                                               'cpu', gemma),
            torch.float32, shard_bytes=4 << 20)
        host, cfg = convert.load_hf_model(directory, dtype=torch.float32,
                                          device='cpu')
        card, cfg_card = convert.load_hf_model(directory,
                                               dtype=torch.float32,
                                               device='cuda')
        if cfg_card != cfg:
            raise AssertionError(f'12c {label}: configs differ')
        verify_hf_leaves(host, hf_config, 1, torch.float32, 'cpu')
        if not all(torch.equal(a, b.cpu()) for a, b in zip(
                trainer.tree_leaves(host), trainer.tree_leaves(card))):
            raise AssertionError(f'12c {label}: card and host leaves differ')
        prompts, budgets = _debug_requests(cfg.vocab_size)
        tokens = torch.tensor([prompts[1][:40], prompts[3] + prompts[2][:23]])
        with torch.no_grad():
            want = llama.forward(host, tokens, cfg)
            got = llama.forward(card, tokens.cuda(), cfg)
        _logits_close(f'12c {label} forward logits card vs host', got, want)
        _card_and_host(f'12c {label}', _serve_debug,
                       {'cpu': host, 'cuda': card}, cfg, prompts, budgets, {})
        shutil.rmtree(directory)


# ---- phase 13: ResNet -------------------------------------------------------

# 13a's limits, f32 on both sides: each gradient and each parameter's
# update within RESNET_GRAD_REL of its leaf's largest element, the loss and
# the running statistics within RESNET_ATOL.  Both lie between the
# card-vs-host readings of the f32 step and those of its controls, the
# same step on the card with TF32 convolutions and with bf16 ones, which
# must read past RESNET_GRAD_REL.  On an H100: f32 3.2e-5 of a leaf's
# largest gradient, loss 2.6e-6, statistics 7.2e-7; TF32 0.44, 6.2e-4 and
# 1.6e-3; bf16 1.44, 1.6e-2 and 1.4e-2 (PERF.md, section 6).
RESNET_GRAD_REL, RESNET_ATOL = 2e-3, 1e-4


def _flax_shaped_state(model, seed):
    """A random {'params', 'batch_stats'} tree in flax's layout (HWIO
    kernels, the Dense kernel (in, out)) for `model`'s names, norms off
    their init (scale 1 + 0.2 N, bias and mean 0.1 N, var 1 + 0.5 |N|)."""
    rng = np.random.RandomState(seed)
    tree = {'params': {}, 'batch_stats': {}}
    for name, t in model.state_dict().items():
        *path, leaf = name.split('.')
        noise = rng.normal(size=tuple(t.shape)).astype(np.float32)
        if leaf == 'kernel':
            value = (noise * np.prod(t.shape[1:]) ** -0.5).transpose(
                2, 3, 1, 0)
        elif leaf == 'weight':
            leaf, value = 'kernel', (noise * t.shape[1] ** -0.5).T
        elif leaf == 'scale':
            value = 1 + 0.2 * noise
        elif leaf == 'var':
            value = 1 + 0.5 * np.abs(noise)
        else:
            value = 0.1 * noise
        node = tree['batch_stats' if leaf in ('mean', 'var') else 'params']
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _resnet_step(dev, state, x, y, dtype=torch.float32):
    """One train_resnet step of ResNet18Thin (convolutions in `dtype`)
    from `state` on `dev`: (loss, gradients, state after), on the host."""
    from skypilot_tpu_torch.models import resnet
    from skypilot_tpu_torch.train import train_resnet
    model = resnet.ResNet18Thin(dtype=dtype)
    model.load_state_dict(state)
    model.to(dev)
    step = train_resnet.make_step(model, train_resnet.sgd(model))
    loss = float(step(x.to(dev), y.to(dev)))
    return (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: t.cpu() for n, t in model.state_dict().items()})


def _resnet_distance(state, want, got):
    """The readings of `got` against `want` (two _resnet_step results
    from `state`): the loss's distance, the largest gradient and update
    distance of any leaf over that leaf's largest, the running
    statistics' largest distance."""
    (l_w, g_w, s_w), (l_g, g_g, s_g) = want, got
    grad = upd = 0.0
    for name in g_w:
        grad = max(grad, float((g_g[name] - g_w[name]).abs().max())
                   / float(g_w[name].abs().max()))
        step = s_w[name] - state[name]
        upd = max(upd, float((s_g[name] - s_w[name]).abs().max())
                  / float(step.abs().max()))
    stats = max(float((s_g[n] - s_w[n]).abs().max()) for n in s_w
                if n.endswith(('.mean', '.var')))
    return {'loss': abs(l_g - l_w), 'grad_rel': grad, 'update_rel': upd,
            'running_stats_abs': stats}


def resnet_parity():
    """13a: ResNet18Thin in f32 on the host and on the card from the same
    params_from_flax state: one step of train_resnet's step (SGD with
    momentum 0.9, lr 0.1) on 4 random 32x32 images; the loss, every
    gradient, every parameter's update and the running statistics held
    at RESNET_GRAD_REL / RESNET_ATOL.  Then the controls: the same step
    on the card with TF32 convolutions and with bf16 ones, each of which
    must read past RESNET_GRAD_REL (the limit sees a lower-precision
    convolution path)."""
    from skypilot_tpu_torch.models import resnet
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = torch.arange(4) % 10
    state = resnet.params_from_flax(
        _flax_shaped_state(resnet.ResNet18Thin(), 0))
    host = _resnet_step('cpu', state, x, y)
    card = _resnet_distance(state, host, _resnet_step('cuda', state, x, y))
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = _resnet_distance(state, host,
                                _resnet_step('cuda', state, x, y))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    bf16 = _resnet_distance(state, host, _resnet_step(
        'cuda', state, x, y, torch.bfloat16))
    log('  13a ResNet18Thin f32 one SGD step, card vs host: ' + json.dumps({
        'card': CARD['line'], 'loss': [host[0]], 'f32': card,
        'control_tf32_convs': tf32, 'control_bf16_convs': bf16,
        'limits': {'grad_update_rel': RESNET_GRAD_REL,
                   'loss_stats_abs': RESNET_ATOL}}))
    if max(card['loss'], card['running_stats_abs']) > RESNET_ATOL or max(
            card['grad_rel'], card['update_rel']) > RESNET_GRAD_REL:
        raise AssertionError(f'13a: the card\'s step is off the host\'s: '
                             f'{card}')
    for label, control in (('TF32', tf32), ('bf16', bf16)):
        if control['grad_rel'] <= RESNET_GRAD_REL:
            raise AssertionError(
                f'13a: the step with {label} convolutions reads within '
                f'RESNET_GRAD_REL ({control}): the limit does not see it')


def resnet_train_path(batch=256, size=224, warmup=2, steps=10):
    """13b: train_resnet's path on the card: ResNet50 (bf16 convolutions,
    channels_last, f32 parameters and norms), ones images and zero
    labels, SGD momentum 0.9; `warmup` steps, then `steps` timed; then
    the entry point itself as a child process at the same settings.
    Fails unless the losses are finite.  Prints images/s, step time and
    peak memory."""
    from skypilot_tpu_torch.models import resnet
    from skypilot_tpu_torch.train import train_resnet
    torch.manual_seed(0)
    model = resnet.ResNet50().cuda()
    step = train_resnet.make_step(model, train_resnet.sgd(model))
    images = torch.ones((batch, size, size, 3), dtype=torch.bfloat16,
                        device='cuda')
    labels = torch.zeros((batch,), dtype=torch.long, device='cuda')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(warmup):
        loss = step(images, labels)
    first = float(loss)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(images, labels)
    last = float(loss)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, step, images, labels
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.train_resnet',
         '--steps', str(steps), '--batch-size', str(batch), '--image-size',
         str(size)], cwd=HERE, capture_output=True, text=True, timeout=600)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ''
    if proc.returncode != 0 or not line.startswith('images/sec: '):
        raise AssertionError(f'13b train_resnet: rc {proc.returncode}\n'
                             f'{proc.stdout}\n{proc.stderr[-3000:]}')
    if not np.all(np.isfinite([first, last, float(line.split()[-1])])):
        raise AssertionError(f'13b: losses {first}, {last}; {line}')
    stats = {'card': CARD['line'], 'batch': batch, 'image_size': size,
             'warmup_steps': warmup, 'warmup_s': warm_s, 'steps': steps,
             'images_per_s': batch * steps / elapsed,
             'step_ms': elapsed / steps * 1e3, 'peak_memory_gb': peak,
             'loss_after_warmup': first, 'last_loss': last,
             'entry_point_line': line}
    log('  13b train_resnet ResNet50: ' + json.dumps(stats))
    return stats


# ---- phase 14: prefix cache, host tier, handoff ---------------------------

# prefix_block == prefill_chunk: a cold prompt longer than the chunk takes
# the same windows as a warm hit's suffix, so both write the same K/V.
PREFIX_BLOCK = 256


def _arena_sha(arena, ids):
    """SHA-256 over the arena blocks `ids` of every component (sorted),
    gathered as (L, n, ...) and read on the host, bf16 as its bits."""
    idx = torch.as_tensor(list(ids), dtype=torch.long,
                          device=arena['k'].device)
    h = hashlib.sha256()
    for comp in sorted(arena):
        t = arena[comp].index_select(1, idx).cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _trie_node(pc, key):
    """The trie node covering the token prefix `key` (None if absent)."""
    node = pc._root
    for b in range(len(key) // pc.block):
        node = node.children.get(tuple(key[b * pc.block:(b + 1) * pc.block]))
        if node is None:
            return None
    return node


def _run_requests(b, prompts, max_new):
    """Submit `prompts` at once and run the batcher idle; returns (each
    request's tokens, each one's TTFT, the wall seconds)."""
    t0 = time.perf_counter()
    rids = [b.submit(p, max_new_tokens=max_new) for p in prompts]
    b.run_until_idle()
    wall = time.perf_counter() - t0
    ttfts = [b.ttft(r) for r in rids]
    return [b.result(r) for r in rids], ttfts, wall


def prefix_reuse_path(params, counters, paths, cfg=None, device='cuda'):
    """14a, bench_prefix_reuse's shape at LLAMA3_8B: 8 requests share one
    1,024-token head, each with its own 64-token tail, 48 new tokens;
    a cold batch (first sight of the head), then a warm one with new
    tails.  Gates: the warm tokens equal a batcher without a prefix cache
    on the same prompts; the warm hits dispatch no install or extract
    copy and make one host sync an admission, as the cold batch does;
    the trie's bytes (and its gauge) never pass prefix_cache_mb.  cfg,
    device: LLAMA3_8B on the card by default (a rehearsal passes a tiny
    config and the CPU)."""
    from skypilot_tpu_torch.infer import engine, prefix_cache
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.telemetry import metrics

    cfg = cfg or llama.LLAMA3_8B
    slots, head_len, tail, max_new = 8, 1024, 64, 48
    base = dict(max_seq_len=2048, batch_size=slots,
                prefill_chunk=PREFIX_BLOCK)
    b = ContinuousBatcher(params, cfg, GeneratorConfig(
        **base, prefix_block=PREFIX_BLOCK, prefix_cache_mb=2048),
        decode_chunk=16, device=device)
    pc = b._prefix
    peak = {'bytes': 0, 'gauge': 0.0}
    step, decode_chunk, chunks = b.step, b._decode_chunk, [0]

    def checked_step():
        step()
        peak['bytes'] = max(peak['bytes'], pc.bytes)
        peak['gauge'] = max(peak['gauge'], metrics.REGISTRY.get_sample_value(
            'skytpu_infer_prefix_bytes'))

    def counted_chunk(*args, **kwargs):
        chunks[0] += 1
        return decode_chunk(*args, **kwargs)

    b.step, b._decode_chunk = checked_step, counted_chunk
    vocab = cfg.vocab_size
    rng = np.random.RandomState(14)

    def make(head, salt):
        return [list(head) + [(salt + 7 * (i + 1) + j) % vocab
                              for j in range(tail)] for i in range(slots)]

    def run(prompts):
        keys = ('hits', 'misses', 'tokens_saved', 'evictions')
        before = {k: getattr(pc, k) for k in keys}
        shares0, syncs0, chunks0 = (b.pool.prefix_shares,
                                    engine.host_fetch.calls, chunks[0])
        b.decode_tokens, b.decode_seconds = 0, 0.0
        out, ttfts, wall = _run_requests(b, prompts, max_new)
        if any(len(o) != max_new for o in out):
            raise AssertionError(f'14a: {[len(o) for o in out]} tokens')
        tokens = sum(len(p) for p in prompts)
        stats = {k: getattr(pc, k) - before[k] for k in keys}
        stats.update(
            ttft_s_median=statistics.median(ttfts), ttft_s_max=max(ttfts),
            wall_s=wall, prompt_tokens=tokens,
            # Prompt tokens over the time until the last first token.
            prefill_tokens_per_s=tokens / max(ttfts),
            decode_tokens_per_s=b.decode_tokens / b.decode_seconds,
            prefix_shares=b.pool.prefix_shares - shares0,
            decode_chunks=chunks[0] - chunks0,
            host_fetches=engine.host_fetch.calls - syncs0)
        # One sync for each admission's first token, one a decode chunk.
        stats['syncs_per_admission'] = (
            stats['host_fetches'] - stats['decode_chunks']) / len(prompts)
        return out, stats

    # Warm-up on a disjoint token range: the cold windows, the hit path
    # and the decode graphs; then count from zero.
    warm_head = [int(t) for t in rng.randint(1, vocab // 2, size=head_len)]
    head = [int(t) for t in rng.randint(vocab // 2, vocab, size=head_len)]
    run(make(warm_head, 1))
    run(make(warm_head, 2))
    _zero(counters)
    _, cold = run(make(head, 3))
    real = prefix_cache.install_prefix, prefix_cache.extract_block

    def no_copy(*args, **kwargs):
        raise AssertionError('14a: an install/extract copy on the pooled '
                             'warm path')

    prefix_cache.install_prefix = prefix_cache.extract_block = no_copy
    try:
        warm_out, warm = run(make(head, 4))
    finally:
        prefix_cache.install_prefix, prefix_cache.extract_block = real
    paths['14a'] = _counts(counters)
    b.pool.check_invariant()
    st = b.pool.stats()
    if st['reserved'] or st['blocks_live'] != pc.node_count * (
            PREFIX_BLOCK // b.block_size):
        raise AssertionError(f'14a: pool {st} against {pc.node_count} '
                             f'trie nodes')
    if warm['hits'] != slots or warm['misses'] or \
            warm['tokens_saved'] != slots * head_len:
        raise AssertionError(f'14a: warm batch {warm}')
    if cold['syncs_per_admission'] != 1 or warm['syncs_per_admission'] != 1:
        raise AssertionError(f'14a: host syncs an admission: cold {cold}, '
                             f'warm {warm}')
    if peak['bytes'] > pc.capacity_bytes or peak['gauge'] > pc.capacity_bytes:
        raise AssertionError(f'14a: the trie held {peak} bytes, over its '
                             f'{pc.capacity_bytes}')
    del b, pc
    gc.collect()
    torch.cuda.empty_cache()
    ref = ContinuousBatcher(params, cfg, GeneratorConfig(**base),
                            decode_chunk=16, device=device)
    ref_out, _, _ = _run_requests(ref, make(head, 4), max_new)
    _same_tokens('14a: warm hits vs a batcher without a prefix cache',
                 warm_out, ref_out)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    stats = {'card': CARD['line'], 'requests': slots,
             'shared_head_tokens': head_len, 'tail_tokens': tail,
             'prefix_block': PREFIX_BLOCK, 'new_tokens': max_new,
             'cold': cold, 'warm': warm,
             'ttft_median_warm_over_cold': (warm['ttft_s_median']
                                            / cold['ttft_s_median']),
             'peak_trie_bytes': peak['bytes'],
             'prefix_cache_bytes': 2048 * 1024 * 1024,
             'launches': paths['14a']}
    log('  14a prefix reuse: ' + json.dumps(stats))
    log('  14a: warm tokens identical to a batcher without a prefix cache; '
        'no install/extract copy; one host sync an admission')


def _copy_gbps(nbytes=1 << 30, reps=5):
    """One plain pinned copy_ of `nbytes` each way (the host link's
    yardstick): GB/s of the median of `reps`, timed with CUDA events."""
    t0 = time.perf_counter()
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pin_s = time.perf_counter() - t0
    dev = torch.empty(nbytes, dtype=torch.uint8, device='cuda')
    out = {'bytes': nbytes, 'pin_s': pin_s}
    for name, dst, src in (('h2d', dev, host), ('d2h', host, dev)):
        times = []
        for _ in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        out[f'{name}_gb_per_s'] = nbytes / statistics.median(times[1:]) / 1e9
    del host, dev
    torch.cuda.empty_cache()
    return out


def tier_path(params, counters, paths, cfg=None, device='cuda'):
    """14b, bench_tier_reuse's shape at LLAMA3_8B: 12 heads of 1,024
    tokens (48 trie nodes of 256 tokens, 1.61 GB of KV), a device prefix
    budget of a tenth of that working set by the reference's formula,
    a host tier of twice it; every head seen once, then revisited after
    churn with a prefetch_hint ahead of it; tier off, then on.  Gates:
    the two arms' tokens are identical; the first spilled node's arena
    bytes after its prefetch equal (SHA-256) those gathered at its
    spill.  Prints the tier's counts, spill and prefetch GB/s beside one
    plain pinned 1 GB copy each way, revisit TTFTs and the pinned
    allocation's seconds and host RSS.  cfg, device: as
    prefix_reuse_path's."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    cfg = cfg or llama.LLAMA3_8B
    heads, head_len, tail, max_new = 12, 1024, 32, 4
    nodes_per_head = head_len // PREFIX_BLOCK
    working = heads * nodes_per_head
    node_bytes = (2 * cfg.n_layers * PREFIX_BLOCK * cfg.n_kv_heads
                  * cfg.head_dim * torch.empty((), dtype=cfg.dtype)
                  .element_size())
    budget_nodes = max(nodes_per_head + 1, working // 10)
    prefix_mb = budget_nodes * node_bytes / 2 ** 20
    host_mb = 2.0 * working * node_bytes / 2 ** 20
    rng = np.random.RandomState(15)
    vocab = cfg.vocab_size
    head_toks = [[int(t) for t in rng.randint(1, vocab, size=head_len)]
                 for _ in range(heads)]

    def tails(salt):
        return [[(salt + 11 * (i + 1) + j) % vocab for j in range(tail)]
                for i in range(heads)]

    def arm(tier_mb):
        rss0, t0 = _vm_rss(), time.perf_counter()
        b = ContinuousBatcher(params, cfg, GeneratorConfig(
            max_seq_len=2048, batch_size=2, prefill_chunk=PREFIX_BLOCK,
            prefix_block=PREFIX_BLOCK, prefix_cache_mb=prefix_mb,
            host_tier_mb=tier_mb), decode_chunk=16, device=device)
        build = {'build_s': time.perf_counter() - t0,
                 'host_rss_growth_gb': (_vm_rss() - rss0) / 1e9}
        tier, pc = b._tier, b._prefix
        spilled, fetched = {}, []
        if tier is not None:
            accept, start = tier.accept_spill, tier.start_prefetch

            def recording_spill(key, ids):
                # The bytes gathered at the spill, read before the blocks
                # free (outside every timed request).
                sha = _arena_sha(b.pool.arena, ids)
                ok = accept(key, ids)
                if ok:
                    spilled[key] = sha
                return ok

            def recording_prefetch(entries, dev_ids, nodes):
                fetched.extend((e.key, n) for e, n in zip(entries, nodes))
                return start(entries, dev_ids, nodes)

            tier.accept_spill = recording_spill
            tier.start_prefetch = recording_prefetch
            _zero(counters)
        outs = []
        for h, t in zip(head_toks, tails(3)):
            o, _, _ = _run_requests(b, [h + t], max_new)
            outs += o
        b.tier_flush()
        h0, m0 = pc.hits, pc.misses
        ttfts, verified = [], 0
        for h, t in zip(head_toks, tails(4)):
            if tier is not None:
                b.prefetch_hint(h + t)
                b.tier_flush()
            o, ttft, _ = _run_requests(b, [h + t], max_new)
            outs += o
            ttfts += ttft
            # Every node prefetched for this request, still in the trie
            # as it landed: its arena bytes against those of its spill.
            while fetched:
                key, node = fetched.pop()
                if node.tier != 'device' or _trie_node(pc, key) is not node:
                    continue
                if _arena_sha(b.pool.arena, node.data) != spilled[key]:
                    raise AssertionError('14b: a prefetched node\'s bytes '
                                         'differ from those spilled')
                verified += 1
        b.tier_flush()
        stats = dict(build, warm_hits=pc.hits - h0,
                     warm_misses=pc.misses - m0,
                     revisit_ttft_s_median=statistics.median(ttfts),
                     revisit_ttft_s_max=max(ttfts))
        if tier is not None:
            if not verified:
                raise AssertionError('14b: no spilled node was prefetched')
            s = tier.stats()
            stats.update({k: s[k] for k in (
                'spills', 'spill_rejects', 'prefetches', 'host_hits',
                'device_hits', 'misses', 'prefetch_late', 'host_evictions',
                'spill_bytes', 'prefetch_bytes', 'spill_seconds',
                'prefetch_seconds', 'prefetch_staging_seconds',
                'prefetch_h2d_seconds', 'host_nbytes', 'pin_seconds')})
            stats['spill_gb_per_s'] = s['spill_bytes'] / s['spill_seconds'] / 1e9
            stats['prefetch_gb_per_s'] = (s['prefetch_bytes']
                                          / s['prefetch_seconds'] / 1e9)
            stats['prefetch_h2d_gb_per_s'] = (
                s['prefetch_bytes'] / s['prefetch_h2d_seconds'] / 1e9
                if s['prefetch_h2d_seconds'] else None)
            stats['prefetched_nodes_sha256_equal'] = verified
            paths['14b'] = _counts(counters)
        b.pool.check_invariant()
        b.close()
        del b, tier, pc
        gc.collect()
        torch.cuda.empty_cache()
        return outs, stats

    off_out, off = arm(None)
    on_out, on = arm(host_mb)
    _same_tokens('14b: tier on vs tier off', on_out, off_out)
    stats = {'card': CARD['line'], 'heads': heads,
             'shared_head_tokens': head_len, 'working_set_nodes': working,
             'working_set_gb': working * node_bytes / 1e9,
             'device_budget_nodes': budget_nodes,
             'host_tier_mb': host_mb, 'tier_off': off, 'tier_on': on,
             'pinned_copy_1gb': _copy_gbps() if device == 'cuda' else None,
             'launches': paths['14b']}
    log('  14b host tier: ' + json.dumps(stats))
    log(f'  14b: tier-on tokens identical to tier-off ({len(on_out)} '
        f'requests); {on["prefetched_nodes_sha256_equal"]} prefetched '
        f'nodes equal their spills (SHA-256)')


def handoff_path(params, counters, paths, kv, cfg=None, device='cuda'):
    """14c, prefill -> decode handoff in one process: a prefill batcher
    and a decode batcher, each with its own arena, prefix cache and host
    tier, over one parameter dict.  Four cold 1,040-token prompts are
    prefilled (max_new_tokens=1), exported, encoded, decoded, ingested
    and served 48 tokens on the decode batcher; a fifth's image has one
    byte flipped, is refused and the prompt prefills cold.  Gates: the
    tokens of all five equal single-pool serving; drain_sessions on the
    single pool mid-decode returns each request's tokens so far (a
    prefix of the uninterrupted run's) and its remaining budget, and the
    specs re-submitted on the prefill batcher run to that budget.  How
    many of the resumed tokens equal the uninterrupted run's is printed,
    not gated: the resumed request computes its generated tokens' K/V in
    a prefill window where the single pool wrote them in decode steps
    (other products, other bf16 and int8 roundings); 14d holds the
    continuation bitwise in f32.  cfg, device: as
    prefix_reuse_path's."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.serve import disagg

    cfg = cfg or llama.LLAMA3_8B
    label = f'14c-{kv or "bf16"}'
    n, plen, max_new = 4, 1040, 48
    # Room for twice the five prompts' heads, on the card and on the host.
    elem = 1 if kv else torch.empty((), dtype=cfg.dtype).element_size()
    head_mb = ((n + 1) * (plen // PREFIX_BLOCK) * 2 * cfg.n_layers
               * PREFIX_BLOCK * cfg.n_kv_heads * (cfg.head_dim * elem
                                                  + (4 if kv else 0))
               / 2 ** 20)
    base = dict(max_seq_len=2048, batch_size=8, prefill_chunk=PREFIX_BLOCK,
                prefix_block=PREFIX_BLOCK, prefix_cache_mb=2 * head_mb,
                kv_cache_dtype=kv)
    rng = np.random.RandomState(16 if kv is None else 17)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=plen)]
               for _ in range(n + 1)]
    single = ContinuousBatcher(params, cfg, GeneratorConfig(**base),
                               decode_chunk=16, device=device)
    want, _, _ = _run_requests(single, prompts, max_new)
    # A failover mid-decode: drained sessions (warm hits now).
    rids = [single.submit(p, max_new_tokens=max_new) for p in prompts[:n]]
    while min(len(single.partial(r)) for r in rids) < 17:
        single.step()
    specs = single.drain_sessions()
    if len(specs) != n or not all(
            0 < len(s['out']) < max_new and s['max_new_tokens'] == max_new
            and s['out'] == w[:len(s['out'])] and s['prompt'] == p
            for s, w, p in zip(specs, want, prompts)):
        raise AssertionError(f'14c: drained {[len(s["out"]) for s in specs]}'
                             f' tokens: not the uninterrupted run\'s')
    del single
    gc.collect()
    torch.cuda.empty_cache()
    pre = ContinuousBatcher(params, cfg, GeneratorConfig(
        **base, host_tier_mb=2 * head_mb), decode_chunk=16, device=device)
    dec = ContinuousBatcher(params, cfg, GeneratorConfig(
        **base, host_tier_mb=2 * head_mb), decode_chunk=16, device=device)
    _zero(counters)
    _run_requests(pre, prompts, 1)
    hits0 = dec._prefix.hits
    rids, export_to_first, image_bytes, enc_ms, dec_ms = [], [], [], [], []
    for i, p in enumerate(prompts):
        # One prompt's handoff, timed from its export to its first token
        # on the decode batcher (which decodes the earlier ones meanwhile).
        t0 = time.perf_counter()
        res = pre.export_handoff(p)
        if res is None or res['tokens'] != (plen - 1) // PREFIX_BLOCK \
                * PREFIX_BLOCK:
            raise AssertionError(f'14c: export of prompt {i}: {res}')
        t1 = time.perf_counter()
        data = disagg.encode_kv_image(p[:res['tokens']], PREFIX_BLOCK,
                                      res['payload'])
        t2 = time.perf_counter()
        if i == n:
            bad = bytearray(data)
            bad[len(bad) // 2] ^= 0x01
            try:
                disagg.decode_kv_image(bytes(bad))
            except disagg.CorruptImageError:
                # Refused: this prompt prefills cold.
                rids.append(dec.submit(p, max_new_tokens=max_new))
                continue
            raise AssertionError('14c: a flipped byte was not refused')
        img = disagg.decode_kv_image(data)
        t3 = time.perf_counter()
        if dec.ingest_handoff(p, img.payload) != img.nodes:
            raise AssertionError(f'14c: prompt {i} not adopted')
        dec.tier_flush()
        t4 = time.perf_counter()
        rids.append(dec.submit(p, max_new_tokens=max_new))
        while not dec.partial(rids[-1]):
            dec.step()
        # The first token reaches the host inside the tick's admission
        # (the tick's decode chunk comes after it).
        export_to_first.append(t4 - t0 + dec.ttft(rids[-1]))
        image_bytes.append(len(data))
        enc_ms.append((t2 - t1) * 1e3)
        dec_ms.append((t3 - t2) * 1e3)
    dec.run_until_idle()
    got = [dec.result(r) for r in rids]
    paths[label] = _counts(counters)
    _same_tokens(f'{label}: handoff (and the corrupt image\'s cold '
                 f'fallback) vs single-pool serving', got, want)
    if dec._prefix.hits - hits0 != n:
        raise AssertionError(f'14c: {dec._prefix.hits - hits0} warm hits')
    for b in (pre, dec):
        b.pool.check_invariant()
    # The drained sessions, re-submitted on the other batcher.
    resumed = [pre.submit(s['prompt'] + s['out'],
                          max_new_tokens=s['max_new_tokens'] - len(s['out']))
               for s in specs]
    pre.run_until_idle()
    continued = [s['out'] + pre.result(r) for s, r in zip(specs, resumed)]
    if any(len(c) != max_new for c in continued):
        raise AssertionError(f'14c: resumed {[len(c) for c in continued]}')
    same = [next((j for j, (a, w) in enumerate(zip(c, want[i]))
                  if a != w), max_new) - len(s['out'])
            for i, (c, s) in enumerate(zip(continued, specs))]
    stats = {'card': CARD['line'], 'kv_cache_dtype': kv, 'prompts': n,
             'prompt_tokens': plen, 'image_bytes': image_bytes,
             'encode_ms': enc_ms, 'decode_ms': dec_ms,
             'export_to_first_token_s': export_to_first,
             'decode_warm_hits': dec._prefix.hits - hits0,
             'adopted': dec._tier.adopted,
             'drained_out_tokens': [len(s['out']) for s in specs],
             # Resumed tokens equal to the uninterrupted run's before the
             # first that differs (of max_new - drained_out_tokens).
             'resumed_identical_tokens': same,
             'launches': paths[label]}
    log(f'  {label} handoff: ' + json.dumps(stats))
    log(f'  {label}: handoff tokens identical to single-pool serving; the '
        f'flipped image refused and its prompt served cold with the same '
        f'tokens; drained specs hold the uninterrupted prefix and resume')
    for b in (pre, dec):
        b.close()
    del pre, dec
    gc.collect()
    torch.cuda.empty_cache()


def _serve_debug_warm(params, cfg, dev, prompts, budgets, graphs=None,
                      **extra):
    """_serve_debug's batcher serving the requests twice, cold then warm
    (the trie filled by the first pass); the passes must agree.  Closes
    the batcher's tier."""
    b, cold = _serve_debug(params, cfg, dev, prompts, budgets, graphs,
                           **extra)
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    b.run_until_idle()
    warm = [b.result(r) for r in rids]
    if warm != cold:
        raise AssertionError(f'batcher {extra} on {dev}: warm tokens differ '
                             f'from cold')
    if not b._prefix.hits:
        raise AssertionError(f'batcher {extra} on {dev}: no prefix hit')
    if b._tier is not None:
        b.tier_flush()
        if not b._tier.spills or not b._tier.prefetches:
            raise AssertionError(f'batcher {extra} on {dev}: tier '
                                 f'{b._tier.stats()}')
    if b.pooled:
        b.pool.check_invariant()
    b.close()
    return b, warm


def _drain_resume_debug(params, cfg, dev, prompts, budgets, graphs=None,
                        **extra):
    """drain_sessions on a batcher after its first decode chunk, and the
    specs re-submitted (prompt + out, the budget left) on a second
    batcher: returns (the second batcher, each request's drained tokens
    followed by its resumed ones)."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    kw = dict(max_seq_len=256, batch_size=4, prompt_buckets=[16, 64, 128],
              prefill_chunk=64, kv_block_size=16, **extra)
    a, b = (ContinuousBatcher(params, cfg, GeneratorConfig(**kw),
                              decode_chunk=4, device=dev, graphs=graphs)
            for _ in range(2))
    for p, n in zip(prompts, budgets):
        a.submit(p, max_new_tokens=n)
    while a.num_queued or not a.num_active:
        a.step()
    specs = a.drain_sessions()
    if len(specs) != len(prompts) or a.num_active or a.num_queued:
        raise AssertionError(f'drain on {dev}: {len(specs)} specs')
    rids = [b.submit(s['prompt'] + s['out'],
                     max_new_tokens=s['max_new_tokens'] - len(s['out']))
            for s in specs]
    b.run_until_idle()
    out = [s['out'] + b.result(r) for s, r in zip(specs, rids)]
    for x in (a, b):
        x.pool.check_invariant()
        x.close()
    return b, out


def prefix_parity():
    """14d: a 2-layer LLAMA_DEBUG model in f32 on the host (plain
    versions), on the card eagerly and on the card through graphs: the
    Generator's warm path (pooled and 'paged': installs), the batcher's
    pooled plane with the host tier under an evicting budget and its
    'paged' plane (install/extract, K7): identical greedy tokens on all
    three, warm equal cold and equal to the plain engines' tokens, and
    the pooled arenas allclose card vs host (LOGITS_TOL); and
    drain_sessions after a decode chunk, resumed on a second batcher,
    continues with the uninterrupted run's tokens."""
    from skypilot_tpu_torch.models import llama

    cfg = llama.LLAMA_DEBUG
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   'cpu')
    params = {'cpu': params_cpu, 'cuda': _to_device(params_cpu, 'cuda')}
    rng = np.random.RandomState(3)
    head = [int(t) for t in rng.randint(1, cfg.vocab_size, size=32)]
    prompts = [head + [int(t) for t in rng.randint(1, cfg.vocab_size,
                                                   size=n)]
               for n in (3, 20, 60, 9)]
    budgets = [12, 9, 7, 10]
    prefix = dict(prefix_cache_mb=4, prefix_block=16)
    # One 16-row f32 block of LLAMA_DEBUG is 32 KiB: ~1.5 of them.
    tiered = dict(prefix_cache_mb=0.05, prefix_block=16, host_tier_mb=2)
    ref_gen = _generate_debug(params['cpu'], cfg, 'cpu', prompts, budgets)[1]
    ref_batch = _serve_debug(params['cpu'], cfg, 'cpu', prompts, budgets)[1]
    runs = (('Generator pooled, prefix', _generate_debug, prefix, ref_gen),
            ('Generator paged, prefix', _generate_debug,
             dict(prefix, decode_impl='paged'), ref_gen),
            ('batcher pooled, prefix + host tier', _serve_debug_warm,
             tiered, ref_batch),
            ('batcher paged, prefix', _serve_debug_warm,
             dict(prefix, decode_impl='paged'), ref_batch),
            ('drain_sessions, resumed on a second batcher',
             _drain_resume_debug, prefix, None))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        for label, run, extra, ref in runs:
            three = _card_and_host(label, run, params, cfg, prompts,
                                   budgets, extra)
            if ref is None:     # uninterrupted: the batcher's own tokens
                ref = _serve_debug(params['cpu'], cfg, 'cpu', prompts,
                                   budgets, **extra)[1]
            _same_tokens(f'14d {label}: vs the engine without a prefix '
                         f'cache', three['card graphs'][1], ref)
            host, card = three['host'][0], three['card graphs'][0]
            if getattr(card, 'pool', None) is not None:
                atol, rtol = LOGITS_TOL
                for comp, arr in card.pool.arena.items():
                    torch.testing.assert_close(
                        arr[:, 1:].cpu(), host.pool.arena[comp][:, 1:],
                        atol=atol, rtol=rtol)
                log(f'  14d {label}: arena allclose card vs host')
    log('  14d: warm equals cold and the engines without a prefix cache, '
        'on the host, the card eager and the card through graphs')


# Launch counts by route: '<name>[tc]' the tensor-core kernels of K2, K5
# and K6, '<name>[split]' the split-KV launches of K1 and K7, '<name>[lse]'
# K2's launches that wrote the lse.
ROUTES = {'tc': 'launches_tc', 'split': 'launches_split',
          'lse': 'launches_lse'}


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
    run_start = time.perf_counter()
    clock = {'start': run_start, 'name': None}

    def phase(msg):
        """Log the seconds of the phase that ends, then the next one."""
        now = time.perf_counter()
        if clock['name']:
            log(f'  phase {clock["name"]}: {now - clock["start"]:.1f} s')
        clock.update(start=now, name=msg[1:msg.index('/')])
        log(msg)

    def last_phase_done():
        log(f'  phase {clock["name"]}: '
            f'{time.perf_counter() - clock["start"]:.1f} s')

    phase(f'[1/14] device: {CARD["line"]} | torch {torch.__version__} '
        f'cuda {torch.version.cuda}')

    phase('[2/14] build')
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
        if 'rmsnorm_kernel' in name and info['spill_bytes']:
            raise AssertionError(f'rmsnorm kernel {name} spills (its rows '
                                 f'live in registers): {info}')
        if ('decode_kernel' in name or 'combine_kernel' in name) \
                and info['spill_bytes']:
            raise AssertionError(f'decode kernel {name} spills: {info}')

    phase('[3/14] kernels vs plain versions')
    t0 = time.perf_counter()
    decode = check_decode(decode_attention, ptxas)
    decode['g2'], decode['combine g2'] = check_decode_at(
        decode_attention, ptxas, 'G2', 10)
    decode['gemma'], decode['combine gemma'] = check_decode_at(
        decode_attention, ptxas, 'Gemma-7B', 12)
    decode['qwen'], decode['combine qwen'] = check_decode_at(
        decode_attention, ptxas, 'Qwen2.5-1.5B', 13)
    shared = check_decode_shared(decode_attention, ptxas)
    contig = check_contig_decode(decode_attention, ptxas)
    window = check_window(decode_attention, ptxas)
    flash = {'flash_attention': check_flash(attention, ptxas)}
    flash.update({name: check_flash_at(attention, ptxas, name)
                  for name in FLASH_SHAPES})
    norm = {name: check_rmsnorm(rmsnorm, name, ptxas)
            for name in NORM_SHAPES}
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

    phase('[4/14] slice parity, LLAMA_DEBUG and MoE f32, card vs host')
    slice_parity()
    train_parity()
    post_train_parity()
    moe_parity()

    phase('[5/14] main path, LLAMA3_8B bf16 behind the HTTP replica')
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
    eager5, _, eager_out, _ = serve_path('main path eager (graphs=False)',
                                      params, GeneratorConfig(**base),
                                      counters, graphs=False)
    paths['5'], _, graph_out, _ = serve_path('main path', params,
                                          GeneratorConfig(**base), counters)
    _same_tokens('phase 5: graphs vs eager', graph_out, eager_out)
    log(f'  phase 5: greedy tokens identical eager and through graphs '
        f'({sum(map(len, graph_out))} tokens)')
    for key, launches in (('5 eager', eager5), ('5', paths['5'])):
        _need(key, launches, [c.__name__ for c in (k1, k2, k3)])
        if launches[f'{k1.__name__}[split]'] != launches[k1.__name__]:
            raise AssertionError(f'{k1.__name__} missed the split route on '
                                 f'the {key} path')

    phase('[6/14] main path with spec_k 12 and fuse_budget 264: (a) bf16, '
        '(b) int8 KV and weights')
    spec = dict(base, spec_k=12, fuse_budget=264)
    paths['6a'], _, _, _ = serve_path('6a bf16 spec+fused', params,
                                   GeneratorConfig(**spec), counters)
    paths['6b'], _, _, _ = serve_path('6b int8 spec+fused', params,
                                   GeneratorConfig(
                                       **spec, kv_cache_dtype='int8',
                                       weights_dtype='int8'), counters)
    for key in ('6a', '6b'):
        _need(key, paths[key], [c.__name__ for c in (k1, k2, k3, k4v, k4f)]
              + [f'{c.__name__}[{r}]' for c in (k4v, k4f)
                 for r in ('tc', 'split')])

    phase("[7/14] legacy plane decode_impl='paged' (K7): (a) bf16 and (b) int8 "
        'KV behind the HTTP replica, (c) Generator.generate')
    legacy = dict(base, decode_impl='paged', decode_chunk=16)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        paths['7a'], mig_a, _, _ = serve_path('7a paged bf16', params,
                                           GeneratorConfig(**legacy),
                                           counters)
        paths['7b'], mig_b, _, _ = serve_path(
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

    phase('[8/14] train path: (a) LLAMA_1B at the bench settings, (b) '
        'LLAMA3_8B widths at depth 2')
    remat = dict(remat=True, remat_policy='dots')
    cfg_1b = dataclasses.replace(llama.LLAMA_1B, max_seq_len=2048,
                                 loss_chunk=256, **remat)
    paths['8a'], stats_8a = train_path(
        '8a LLAMA_1B 8x1024', cfg_1b, 8, 1024, 12,
        trainer.TrainConfig(warmup_steps=2, total_steps=12), counters)
    paths['8b'], _ = train_path(
        '8b LLAMA3_8B widths, 2 layers, 2x4096', dataclasses.replace(
            llama.LLAMA3_8B, n_layers=2, max_seq_len=4096, loss_chunk=512,
            **remat),
        2, 4096, 6, trainer.TrainConfig(warmup_steps=2, total_steps=6),
        counters)

    phase('[9/14] checkpoints: (a) LLAMA_1B async saves, restore, continue '
          '(phase 8a settings), (b) a managed job SIGTERMed and resumed '
          'through train_llama --resume auto')
    scratch = tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
    try:
        # 9a keeps 2 checkpoints and stages a third; 9b keeps all of 4
        # (steps 4, 8, 12, 16) and may leave a torn fifth.
        need_gb = 5 * _state_gb(cfg_1b) + 2
        free_gb = shutil.disk_usage(scratch).free / 1e9
        if free_gb < need_gb:
            raise AssertionError(
                f'phase 9 needs {need_gb:.1f} GB free under {scratch} for '
                f'LLAMA_1B checkpoints, {free_gb:.1f} GB are free')
        log(f'  {free_gb:.1f} GB free under {scratch}, {need_gb:.1f} needed')
        paths['9a'] = checkpoint_path(
            cfg_1b, trainer.TrainConfig(warmup_steps=2, total_steps=12),
            counters, os.path.join(scratch, '9a'), stats_8a['step_time_s'])
        shutil.rmtree(os.path.join(scratch, '9a'))
        os.makedirs(os.path.join(scratch, '9b'))
        recovery_path(os.path.join(scratch, '9b'))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase('[10/14] post-training: (a) LoRA-SFT and (b) LoRA-DPO of LLAMA3_8B '
          'at 32 layers, (c) GRPO on LLAMA_1B, (d) the entry points')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_post_')
    try:
        sft_data, dpo_data, small_sft, small_dpo = _post_train_data(scratch)
        cfg_8b = dataclasses.replace(llama.LLAMA3_8B, max_seq_len=2048,
                                     loss_chunk=512, **remat)
        t0 = time.perf_counter()
        base = llama.init_params(
            cfg_8b, torch.Generator(device='cuda').manual_seed(0), 'cuda')
        torch.cuda.synchronize()
        log(f'  LLAMA3_8B bf16 base, {cfg_8b.n_layers} layers: '
            f'{cfg_8b.num_params() / 1e9:.2f}B params in '
            f'{time.perf_counter() - t0:.1f} s')
        sub = time.perf_counter()
        paths['10a'], _ = lora_sft_path(base, cfg_8b, sft_data, counters)
        log(f'  10a: {time.perf_counter() - sub:.1f} s')
        sub = time.perf_counter()
        paths['10b'], _ = lora_dpo_path(base, cfg_8b, dpo_data, counters)
        log(f'  10b: {time.perf_counter() - sub:.1f} s')
        del base
        gc.collect()
        torch.cuda.empty_cache()
        sub = time.perf_counter()
        paths['10c'], _ = grpo_path(counters)
        log(f'  10c: {time.perf_counter() - sub:.1f} s')
        gc.collect()
        torch.cuda.empty_cache()
        sub = time.perf_counter()
        entry_points_path(scratch, small_sft, small_dpo)
        log(f'  10d: {time.perf_counter() - sub:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase('[11/14] Mixtral-8x7B widths, random bf16 weights: (a) 16 of 32 '
          'layers served, (c) LoRA-SFT of that base, (b) trained at depth 2')
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_path(counters, paths)

    phase('[12/14] HF checkpoints written in HF\'s layout and loaded by '
          'convert.load_hf_model: (a) Gemma-7B and (b) Qwen2.5-1.5B at '
          'their published widths served, 12b LoRA-SFT in process and '
          'through train_sft --hf-model, (c) debug-size parity card vs host')
    gc.collect()
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix='chip_smoke_hf_')
    try:
        sub = time.perf_counter()
        gemma_path(counters, paths, scratch)
        log(f'  12a: {time.perf_counter() - sub:.1f} s')
        sub = time.perf_counter()
        qwen_path(counters, paths, scratch)
        log(f'  12b: {time.perf_counter() - sub:.1f} s')
        sub = time.perf_counter()
        hf_parity(scratch)
        log(f'  12c: {time.perf_counter() - sub:.1f} s')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase('[13/14] ResNet: (a) ResNet18Thin one SGD step card vs host, (b) '
          'train_resnet\'s path, ResNet50 at batch 256 of 224x224')
    gc.collect()
    torch.cuda.empty_cache()
    resnet_parity()
    resnet_train_path()

    phase('[14/14] prefix cache, host tier and handoff at LLAMA3_8B bf16, '
          '32 layers: (a) prefix reuse, (b) the host tier, (c) the '
          'prefill -> decode handoff in bf16 and int8 KV, (d) debug-size '
          'parity card vs host')
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # Phase 5's weights, drawn again from its seed.
    params = llama.init_params(
        cfg, torch.Generator(device='cuda').manual_seed(0), 'cuda')
    torch.cuda.synchronize()
    log(f'  LLAMA3_8B bf16 random weights (phase 5\'s seed) in '
        f'{time.perf_counter() - t0:.1f} s')
    for sub, run in (('14a', lambda: prefix_reuse_path(params, counters,
                                                       paths)),
                     ('14b', lambda: tier_path(params, counters, paths)),
                     ('14c', lambda: [handoff_path(params, counters, paths,
                                                   kv)
                                      for kv in (None, 'int8')])):
        t0 = time.perf_counter()
        run()
        log(f'  {sub}: {time.perf_counter() - t0:.1f} s')
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prefix_parity()
    log(f'  14d: {time.perf_counter() - t0:.1f} s')
    last_phase_done()
    log(f'  whole run: {time.perf_counter() - run_start:.1f} s')
    for key in ('8a', '8b', '9a', '10a', '10b', '10c', '11b', '11c'):
        _need(key, paths[key], [c.__name__ for c in (k2, k3, k5, k6)]
              + [f'{k2.__name__}[lse]'])
    _need('10c', paths['10c'], [k1.__name__])
    for key in ('11a', '12a', '12b'):
        _need(key, paths[key], [c.__name__ for c in (k1, k2, k3)])
    _need('12b-sft', paths['12b-sft'], [c.__name__ for c in (k2, k3, k5, k6)]
          + [f'{k2.__name__}[lse]'])
    phase14 = ('14a', '14b', '14c-bf16', '14c-int8')
    for key in phase14:
        _need(key, paths[key], [c.__name__ for c in (k1, k3)])
    for key, launches in paths.items():
        # Every path runs bf16 at head_dim 128 (12a's K2 at 256): the
        # tensor-core route only; and B KV (8 slots x 16, 8 or 2 KV heads)
        # < 2 blocks an SM: the split route only.
        route = [(c, 'tc') for c in (k2, k5, k6)]
        route += [(c, 'split') for c in (k1, k7)
                  if key[0] in '567' or key in ('10c', '11a', '12a', '12b')
                  or key in phase14]
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

    # K2 and K3 on every path; phase 12's widths have their own entries
    # (12b-sft's K2 launches all write the lse: its entry is the train
    # one at TRAIN_SHAPES['qwen']).
    hf = ('12a', '12b', '12b-sft')
    rest = tuple(k for k in paths if k not in hf)
    kernels = [
        entry(decode['bf16'], k1, ('5', '6a', '11a')),
        entry(decode['g2'], k1, ('10c',)),
        entry(decode['gemma'], k1, ('12a',)),
        entry(decode['qwen'], k1, ('12b',)),
        entry(decode['int8'], k1, ('6b',)),
        # Phase 14's K1 launches decode slots whose tables share blocks.
        entry(shared['bf16'], k1, ('14a', '14b', '14c-bf16')),
        entry(shared['int8'], k1, ('14c-int8',)),
        entry(flash['flash_attention'], k2, rest),
        entry(flash['flash_attention[Gemma-7B hd256]'], k2, ('12a',)),
        entry(flash['flash_attention[Qwen2.5-1.5B G6 prefill]'], k2,
              ('12b',)),
        entry(norm['rms_norm'], k3, rest),
        entry(norm['rms_norm[Gemma-7B]'], k3, ('12a',)),
        entry(norm['rms_norm[Qwen2.5-1.5B]'], k3, ('12b', '12b-sft')),
        entry(window['verify', 'bf16'], k4v, ('6a',)),
        entry(window['fused', 'bf16'], k4f, ('6a',)),
        entry(window['verify', 'int8'], k4v, ('6b',)),
        entry(window['fused', 'int8'], k4f, ('6b',)),
        entry(contig['bf16'], k7, ('7a', '7c')),
        entry(contig['int8'], k7, ('7b',)),
    ]
    # The combine runs inside every split launch of K1 and K7.
    split_paths = {k: paths[k][f'{c.__name__}[split]']
                   for c, keys in ((k1, ('5', '6a', '6b', '11a') + phase14),
                                   (k7, ('7a', '7b', '7c'))) for k in keys}
    kernels.append(dict(decode['combine'],
                        launches=sum(split_paths.values()),
                        launches_by_path=split_paths))
    for key, path in (('combine g2', '10c'), ('combine gemma', '12a'),
                      ('combine qwen', '12b')):
        n = paths[path][f'{k1.__name__}[split]']
        kernels.append(dict(decode[key], launches=n,
                            launches_by_path={path: n}))
    # K4's combine runs inside every split launch of K4.
    window_split = {k: sum(paths[k][f'{c.__name__}[split]']
                           for c in (k4v, k4f)) for k in ('6a', '6b')}
    kernels.append(dict(window['combine'],
                        launches=sum(window_split.values()),
                        launches_by_path=window_split))
    kernels += [entry(train[name, key], counter, keys)
                for name, counter in (('lse', k2), ('dq', k5), ('dkv', k6))
                for key, keys in (('1b', ('8a', '9a', '10c')),
                                  ('8b', ('8b', '10a', '10b', '11b',
                                          '11c')),
                                  ('qwen', ('12b-sft',)))]
    log(json.dumps({'kernels': kernels}))
    log(CARD['line'])
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': CARD['kind'],
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
