"""The system's own measurements on the card: Llama train-step throughput
and MFU, the 8B extrapolation, decode tokens/s against its HBM roofline,
prefix and tier reuse, speculation, the serving-fleet benches, checkpoint
and resume cost, and the mesh collectives.

Counterpart of the JAX package's ``bench.py``: the same function names,
sub-bench shapes, output lines and JSON keys, so each number has one
counterpart and ``scripts/bench_compare.py`` diffs two runs of either.
Run as::

    python -m skypilot_tpu_torch.bench            # on the CUDA card
    python -m skypilot_tpu_torch.bench --device cpu   # debug shapes

Without a card and without ``--device cpu`` it exits non-zero at once.
On the CPU every sub-bench takes the reference's debug shapes and
constants; on the card the shapes of its accelerator branch, with one
H100's peaks (989e12 dense bf16 FLOP/s, 3.35e12 HBM bytes/s).  Times
come from ``torch.cuda.synchronize()`` and CUDA events on the card.

Output: one JSON line ``{"metric", "value", "unit", "vs_baseline",
"extra"}``, then the tail-safe summary lines (TELEMETRY, CKPT, RESUME,
AUDIT, POOL, PREFIX, TIER, SERVE, FUSE, DISAGG, CHAOS, SPEC, MESH, TRACE,
ACCT) and ``BENCH_HEADLINE`` last.  A sub-bench that raises is recorded
as ``{'error': ...}`` and the headline still prints, but the process
then exits 1.  There is no tokens/s target for the card, so
``vs_baseline`` is null (``extra.method_notes`` says why).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Callable, List, Optional

import torch

# One H100 SXM's peaks (NVIDIA data sheet): dense tensor-core bf16, HBM,
# and f32 FMAs outside the tensor cores.  The CPU branch keeps the
# reference's nominal values so its numbers compare with the reference's.
CARD_PEAK_FLOPS = 989e12
CARD_HBM_BYTES_PER_S = 3.35e12
CARD_F32_FLOPS = 67e12
CPU_PEAK_FLOPS = 1e12
CPU_HBM_BYTES_PER_S = 50e9

# No tokens/s target is derived for the card: vs_baseline is null.
TARGET_TOKENS_PER_SEC_PER_CHIP: Optional[float] = None

# Ranks of the mesh bench when this process is not in a process group.
MESH_RANKS_ENV = 'SKYTPU_MESH_RANKS'
MESH_CHILD_PREFIX = 'MESH_CHILD_RESULT '
MESH_CHILD_ERROR_PREFIX = 'MESH_CHILD_ERROR '


# ---- device, timing, parameters -------------------------------------------

def _on_card(device) -> bool:
    return torch.device(device).type == 'cuda'


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def _now(device) -> float:
    """Host seconds after the device's queued work has finished."""
    _sync(device)
    return time.perf_counter()


def card_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    of the first card, or None where there is none."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def _time_chained(run_fn: Callable[[Any], torch.Tensor], init_carry: Any,
                  iters: int, device, repeats: int = 3) -> float:
    """Seconds per iteration of run_fn(carry), which runs `iters` steps
    that each consume the previous step's update (so no step can be
    skipped) and returns one scalar over the final carry.  One untimed
    run warms the caches; then the best of `repeats` runs, each timed
    from its first launch to its last with CUDA events on the card (one
    synchronize), or on the host clock on the CPU.  Best-of-k is the
    noise floor: the 8B per-layer slope is a difference of two of these
    times and amplifies per-run noise."""
    float(run_fn(init_carry))
    best = float('inf')
    for _ in range(repeats):
        if _on_card(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            _sync(device)
            start.record()
            out = run_fn(init_carry)
            end.record()
            end.synchronize()
            float(out)
            elapsed = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            float(run_fn(init_carry))
            elapsed = time.perf_counter() - t0
        best = min(best, elapsed)
    return max(best / iters, 1e-9)


def _init_params(config, device, seed: int = 0):
    """Random parameters of `config` on `device`, from a torch.Generator
    seeded as the reference seeds its PRNG key."""
    from skypilot_tpu_torch.models import llama
    gen = torch.Generator(device=device).manual_seed(seed)
    return llama.init_params(config, gen, device)


def _tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


def _release(device) -> None:
    gc.collect()
    if _on_card(device):
        torch.cuda.empty_cache()


# ---- the 8B extrapolation ---------------------------------------------------

def bench_8b_extrapolated(device) -> dict:
    """Llama-3-8B tokens/s a card, extrapolated from true-shape pieces.

    Measures a full SGD train step of a one-layer and a two-layer model
    at the 8B's widths (d_model 4096, 32 q / 8 kv heads, d_ff 14336, seq
    4096, remat) and of the 128256-vocab embed+head alone, and
    extrapolates step time = 32 x (t_2layer - t_1layer) + t_head; the
    one-layer point cross-checks the linear model.  Reported as
    'extrapolated'.

    Timing: N chained steps (_time_chained); the SGD update is carried
    from step to step, so no step can be skipped."""
    import dataclasses

    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import losses as losses_ops

    device = torch.device(device)
    if _on_card(device):
        # loss_chunk: blockwise CE; the full (4096, 128256) f32 logits
        # never exist.  batch 2: the per-card batch of an fsdp run.
        cfg = llama.LlamaConfig(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq_len=4096,
            dtype=torch.bfloat16, remat=True, remat_policy='dots',
            loss_chunk=512)
        batch, seq, iters = 2, 4096, 8
    else:
        cfg = llama.LLAMA_DEBUG
        batch, seq, iters = 1, 64, 2

    tokens = torch.zeros((batch, seq + 1), dtype=torch.int32, device=device)

    def _sgd_loop(loss_fn, iters):
        def run(p):
            leaves = _tree_leaves(p)
            for _ in range(iters):
                grads = torch.autograd.grad(loss_fn(p, tokens), leaves)
                with torch.no_grad():
                    for leaf, g in zip(leaves, grads):
                        leaf.sub_(g.to(leaf.dtype), alpha=1e-30)
            # Scalar over every leaf: no step's update is dead.
            with torch.no_grad():
                return sum(leaf[..., :1].float().sum() for leaf in leaves)
        return run

    def _time_k_layers(k: int, keep_head: bool = False):
        k_cfg = dataclasses.replace(cfg, n_layers=k)
        k_params = _init_params(k_cfg, device)
        for leaf in _tree_leaves(k_params):
            leaf.requires_grad_(True)

        def loss(p, t):
            return llama.loss_fn(p, {'tokens': t}, k_cfg)

        t = _time_chained(_sgd_loop(loss, iters), k_params, iters, device)
        # Hand back embed+lm_head so the head timing below does not pay
        # a third true-shape init.
        head = ({'embed': k_params['embed'],
                 'lm_head': k_params['lm_head']} if keep_head else None)
        del k_params
        _release(device)
        return t, head

    # k=2 first (the largest working set) so nothing else is resident
    # during it; its embed/lm_head are reused for the head run.  The
    # (1, 2)-layer pair gives a per-layer slope free of fixed overhead,
    # and the 1-layer point cross-checks the linear-in-depth model.
    t_2layer_model, head_params = _time_k_layers(2, keep_head=True)
    t_1layer_model, _ = _time_k_layers(1)

    def head_loss(p, t):
        # The head path the model's loss_fn runs (blockwise when
        # cfg.loss_chunk is set).
        h = p['embed'][t[:, :-1].long()]
        labels = t[:, 1:]
        if cfg.loss_chunk:
            return losses_ops.chunked_softmax_xent(
                h, p['lm_head'], labels, chunk_size=cfg.loss_chunk)
        return -torch.mean(losses_ops.token_logprobs_from_hidden(
            h, p['lm_head'], labels))

    t_head = _time_chained(
        _sgd_loop(head_loss, iters), head_params, iters, device)
    del head_params
    _release(device)

    t_layer = max(t_2layer_model - t_1layer_model, 1e-9)
    predicted_t1 = t_layer + t_head
    extrapolation_err = abs(predicted_t1 - t_1layer_model) / t_1layer_model
    t_step = cfg.n_layers * t_layer + t_head
    tok_s = batch * seq / t_step
    n_params = cfg.num_params()
    # MFU convention: the embedding is a gather, no matmul FLOPs, so
    # mfu_pct counts matmul params only (lm_head is a matmul and stays);
    # mfu_all_params_pct is the 6N_total figure.
    n_matmul = n_params - cfg.vocab_size * cfg.d_model
    peak = CARD_PEAK_FLOPS if _on_card(device) else CPU_PEAK_FLOPS
    mfu = tok_s * 6 * n_matmul / peak
    mfu_all = tok_s * 6 * n_params / peak
    out = {
        'tok_s_chip_extrapolated': round(tok_s, 1),
        'params_b': round(n_params / 1e9, 2),
        'mfu_pct': round(100 * mfu, 1),
        'mfu_all_params_pct': round(100 * mfu_all, 1),
        't_layer_ms': round(t_layer * 1e3, 2),
        't_head_ms': round(t_head * 1e3, 2),
        'extrapolation_check_pct': round(100 * extrapolation_err, 1),
        'method': f'{cfg.n_layers}x true-shape per-layer slope from '
                  f'(1,2)-layer runs + head (chained SGD steps, best of '
                  f'3, CUDA events), bs={batch}x{seq}; check = 1-layer '
                  f'point vs linear model; mfu counts matmul params only '
                  f'(embed gather excluded)',
    }
    # A clamped slope (noise made t_2 <= t_1) or a failed cross-check
    # means the linear model did not hold on this run: flag the number.
    if t_layer <= 2e-9 or extrapolation_err > 0.25:
        out['suspect'] = ('slope degenerate or cross-check failed '
                          '(>25%) — extrapolation invalid on this run')
    return out


# ---- the mesh collectives and sharded decode --------------------------------

def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_bench(device, kind: str) -> dict:
    """algbw/busbw of `kind` ('allreduce' or 'allgather') over every rank
    of the process group, chained: each iteration's input is the last
    one's output (all-reduce / n; all-gather then this rank's block
    back), timed as _time_chained does."""
    import torch.distributed as dist

    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    device = torch.device(device)
    n = _world()
    payload_mb = 256 if _on_card(device) else 8
    n_elem = payload_mb * (1 << 20) // 4
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(dp=n))
    group = mesh.group('dp')
    rank = mesh.axis_index('dp')
    x = torch.ones((n_elem // n,) if kind == 'allgather' else (n_elem,),
                   dtype=torch.float32, device=device)
    iters = 20

    def run(v):
        for _ in range(iters):
            if kind == 'allreduce':
                dist.all_reduce(v, group=group)
                v.div_(n)
            else:
                full = torch.empty((n * v.numel(),), dtype=v.dtype,
                                   device=device)
                dist.all_gather_into_tensor(full, v, group=group)
                v.copy_(full[rank * v.numel():(rank + 1) * v.numel()])
        return v[:1].sum()

    dt = _time_chained(run, x, iters, device)
    bytes_total = n_elem * 4
    algbw = bytes_total / dt / 1e9
    busbw = algbw * ((2 * (n - 1) / n) if kind == 'allreduce'
                     else ((n - 1) / n))
    out = {'ranks': n, 'payload_mb': payload_mb,
           'algbw_gbps': round(algbw, 2), 'busbw_gbps': round(busbw, 2),
           'time_ms': round(dt * 1e3, 3), 'backend': mesh.backend}
    # Physics guard: nothing here moves >10 TB/s of payload.
    if algbw > 10_000:
        out['suspect'] = ('exceeds physical bandwidth — loop likely '
                          'folded; do not trust')
    return out


def bench_allreduce(device) -> dict:
    """All-reduce algbw/busbw over the process group's ranks.  One rank
    has no collective to measure and reports `skipped`."""
    if _world() < 2:
        return {'ranks': 1,
                'skipped': 'single rank: an all-reduce needs >1 rank '
                           '(bench_mesh runs the ranks)'}
    return _collective_bench(device, 'allreduce')


def bench_allgather(device) -> dict:
    """All-gather algbw/busbw over the same ranks as bench_allreduce;
    busbw uses the ring all-gather model, (n-1)/n of algbw."""
    if _world() < 2:
        return {'ranks': 1, 'skipped': 'single rank: all-gather needs >1 '
                                       'rank'}
    return _collective_bench(device, 'allgather')


def _mesh_bench_payload(device) -> dict:
    """Mesh numbers of THIS process group (every rank calls it; rank 0's
    dict is the result): all-reduce and all-gather, then sharded pooled
    decode tokens/s a rank on a tp mesh over every rank, synchronous and
    with the overlapped combines (their greedy tokens must be identical
    before a rate is reported), against the one-device pooled baseline
    that rank 0 runs alone."""
    import dataclasses

    import torch.distributed as dist

    from skypilot_tpu_torch.infer import tp as tp_lib
    from skypilot_tpu_torch.infer.engine import (GeneratorConfig,
                                                 resolve_overlap)
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics

    device = torch.device(device)
    n = _world()
    rank = dist.get_rank() if dist.is_initialized() else 0
    allreduce = bench_allreduce(device)
    allgather = bench_allgather(device)

    # The CPU config keeps every partitioned dim divisible by tp degrees
    # up to 8 (d_model 256, n_heads 8, n_kv_heads 4 + tpq overshard), and
    # gives the products enough work that schedules differ.
    if _on_card(device):
        config = llama.LLAMA_1B
        slots, prompt_len, max_new, chunk = 8, 32, 64, 32
    else:
        config = llama.LlamaConfig(
            vocab_size=512, d_model=256, n_layers=2, n_heads=8,
            n_kv_heads=4, d_ff=1024, max_seq_len=256, dtype=torch.float32)
        slots, prompt_len, max_new, chunk = 8, 8, 48, 8
    gen_cfg = GeneratorConfig(max_seq_len=prompt_len + max_new + 1,
                              batch_size=slots, temperature=0.0,
                              prompt_buckets=[prompt_len])
    prompts = [[(7 * (i + 1)) % config.vocab_size] * prompt_len
               for i in range(slots)]

    def run_batch(batcher):
        rids = [batcher.submit(p, max_new_tokens=max_new) for p in prompts]
        batcher.run_until_idle()
        return [batcher.result(r) for r in rids]

    def measure(params, gc, mesh):
        """(tok/s, elapsed_s, outputs) of the best of 3 batches after
        two discarded ones; outputs from the timed run."""
        batcher = ContinuousBatcher(params, config, gc, decode_chunk=chunk,
                                    mesh=mesh, device=device)
        try:
            run_batch(batcher)
            run_batch(batcher)
            best_rate, best_dt, outs = 0.0, 0.0, None
            for _ in range(3):
                t0 = _now(device)
                o = run_batch(batcher)
                dt = _now(device) - t0
                rate = sum(len(x) for x in o) / dt
                if rate > best_rate:
                    best_rate, best_dt, outs = rate, dt, o
            return best_rate, best_dt, outs
        finally:
            batcher.close()

    mesh = tp_lib.make_tp_mesh(n, n_kv_heads=config.n_kv_heads)
    gen = torch.Generator(device=device).manual_seed(0)
    shards = tp_lib.init_sharded_params(config, gen, mesh, device)
    cfg_sync = dataclasses.replace(gen_cfg, overlap_collectives=False)
    cfg_ovl = dataclasses.replace(gen_cfg, overlap_collectives=True)
    chunks = resolve_overlap(shards, config, cfg_ovl, mesh)
    sync_rate, sync_dt, sync_out = measure(shards, cfg_sync, mesh)
    ovl_rate, ovl_dt, ovl_out = measure(shards, cfg_ovl, mesh)
    del shards
    # Token-exactness gate before any number is reported, where the
    # design gives it: in f32.  The overlapped projections round their
    # f32 span products otherwise than the synchronous ones
    # (llama_infer._combine_then_project), which bf16 can turn into
    # another greedy token at a near tie: there the agreement is
    # reported as measured.
    parity = ('bit-exact' if sync_out == ovl_out else
              {'agreeing_prefix_share': _agreeing_prefix_share(ovl_out,
                                                               sync_out)})
    if parity != 'bit-exact' and config.dtype == torch.float32:
        raise AssertionError(
            'overlapped sharded decode diverged from the sync path '
            f'(chunks={chunks}); refusing to report throughput')
    # The one-device baseline: rank 0 alone, the others held at the
    # barrier, so ranks sharing a card do not contend for it.
    single = None
    if rank == 0:
        params = _init_params(config, device)
        single, _, _ = measure(params, gen_cfg, None)
        del params
    if dist.is_initialized():
        dist.barrier()
    # Collective/partition overhead share: perfect scaling over p
    # devices would cut the batch's wall clock by p, so 1 - sharded /
    # (p x single) estimates the time spent in collectives.  p counts
    # the devices the ranks really have: the cards they run on (ranks
    # sharing one card have p = 1), or the host's cores on the CPU.
    virtual = mesh.backend == 'gloo'
    if _on_card(device):
        p = min(n, torch.cuda.device_count())
    else:
        p = max(1, min(n, os.cpu_count() or n))

    def share_of(rate):
        return (max(0.0, min(1.0, 1.0 - rate / (p * single)))
                if single else None)

    share_sync = share_of(sync_rate)
    share = share_of(ovl_rate)     # serving default = overlapped path
    hidden = None
    if share is not None:
        telemetry_metrics.INFER_MESH_COLLECTIVE_TIME_SHARE.set(share)
        telemetry_metrics.INFER_MESH_COLLECTIVE_SECONDS.labels(
            mode='overlapped').inc(share * ovl_dt)
        telemetry_metrics.INFER_MESH_COLLECTIVE_SECONDS.labels(
            mode='sync').inc(share_sync * sync_dt)
        if share_sync:
            hidden = max(0.0, min(1.0, 1.0 - share / share_sync))
            telemetry_metrics.INFER_MESH_OVERLAP_RATIO.set(hidden)

    out = {
        'ranks': n,
        'dtype': str(config.dtype).split('.')[-1],
        'mesh_axes': dict(mesh.shape),
        'allreduce': allreduce,
        'allgather': allgather,
        'sharded_decode_tok_s_chip': round(ovl_rate / n, 1),
        'single_device_decode_tok_s': (None if single is None
                                       else round(single, 1)),
        'collective_time_share_est':
            None if share is None else round(share, 3),
        'overlap': {
            'chunks': chunks,
            'sharded_decode_tok_s_chip_sync': round(sync_rate / n, 1),
            'sharded_decode_tok_s_chip_overlapped': round(ovl_rate / n, 1),
            'collective_time_share_sync':
                None if share_sync is None else round(share_sync, 3),
            'collective_time_share_overlapped':
                None if share is None else round(share, 3),
            'hidden_comm_ratio':
                None if hidden is None else round(hidden, 3),
            'parity': parity,
        },
    }
    if virtual:
        # gloo through the host: ranks sharing a card or the CPU.  The
        # rates exercise the schedule, not a fabric; ideal_parallelism
        # records the p the share was normalized against (bench_compare
        # compares only equal p).
        out['virtual_devices'] = True
        out['ideal_parallelism'] = p
    return out


def _mesh_rank(local_rank: int, world: int, device_arg: Optional[str]
               ) -> None:
    """One rank of the mesh bench's child: rank 0 prints the result."""
    import traceback

    from skypilot_tpu_torch.train import mesh_run
    device, info = mesh_run.join(device_arg, local_rank, world)
    try:
        out = _mesh_bench_payload(device)
        if info['rank'] == 0:
            print(MESH_CHILD_PREFIX + json.dumps(out), flush=True)
    except Exception:
        # The parent reads stdout only: say which rank failed and why.
        print(MESH_CHILD_ERROR_PREFIX + f'rank {info["rank"]}: '
              + traceback.format_exc()[-600:].replace('\n', ' | '),
              flush=True)
        raise
    finally:
        mesh_run.leave()


def bench_mesh(device) -> dict:
    """Mesh bench.  In a process group of >= 2 ranks it runs in process.
    Otherwise it starts a child (``--mesh-child``) that spawns
    SKYTPU_MESH_RANKS (default 4) gloo rank processes of this host on
    the same device (ranks sharing one card, as the tensor-parallel
    tests run), so one card or the CPU still gives a number, marked
    ``virtual_devices``."""
    device = torch.device(device)
    if _world() >= 2:
        return _mesh_bench_payload(device)
    n_child = int(os.environ.get(MESH_RANKS_ENV, '0') or 0) or 4
    env = dict(os.environ)
    env[MESH_RANKS_ENV] = str(n_child)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env['PYTHONPATH'] = os.pathsep.join(
        [root] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.bench',
           '--mesh-child', '--device', device.type]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=1800, check=False)
    for line in (proc.stdout or '').splitlines():
        if line.startswith(MESH_CHILD_PREFIX):
            out = json.loads(line[len(MESH_CHILD_PREFIX):])
            out['via'] = (f'child process with {n_child} gloo ranks on '
                          f'{device.type} ({MESH_RANKS_ENV} knob)')
            return out
    errors = [line[len(MESH_CHILD_ERROR_PREFIX):]
              for line in (proc.stdout or '').splitlines()
              if line.startswith(MESH_CHILD_ERROR_PREFIX)]
    tail = errors[0] if errors else (
        (proc.stderr or '') + (proc.stdout or ''))[-300:]
    return {'error': f'mesh child produced no result: {tail}'}


# ---- serving: decode, prefix, tier, speculation -----------------------------

def bench_decode(device) -> dict:
    """Serving decode throughput: continuous-batching tokens/s on the 1B
    model, with:

    - roofline_pct: measured tok/s vs the HBM-bandwidth bound at this
      batch: (weights + avg KV read) / HBM rate a step x slots, each
      byte charged once;
    - per-token latency p50/p99 across pure decode chunks (chunk wall
      time / steps: what a streaming client sees between tokens);
    - the int8 KV arena and the int8 weights + KV variants beside bf16;
    - the spans-on/off arm and the legacy bucketed-vs-fixed comparison."""
    import numpy as np

    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    device = torch.device(device)
    on_card = _on_card(device)
    if on_card:
        config = llama.LLAMA_1B
        slots, prompt_len, max_new, chunk = 16, 64, 256, 128
    else:
        config = llama.LLAMA_DEBUG
        slots, prompt_len, max_new, chunk = 2, 8, 16, 8
    params = _init_params(config, device)

    hbm_bw = CARD_HBM_BYTES_PER_S if on_card else CPU_HBM_BYTES_PER_S
    dtype_bytes = 2 if on_card else 4
    avg_ctx = prompt_len + max_new / 2

    n_embed = config.vocab_size * config.d_model
    n_matmul = config.num_params() - n_embed

    def roofline_tok_s(kv_bytes_per_elem, ctx, weights_dtype,
                       int8_scales=False):
        """HBM bound at a given per-step KV context read.  ctx=avg_ctx
        is the ideal bound (cache reads tracking live context exactly);
        ctx=<streamed rows> the bound the engine can reach: pooled
        decode streams each slot's block-table span."""
        if weights_dtype == 'int8':
            # int8 matmul weights (+ f32 per-out-channel scales, <0.1%,
            # folded in); the embed table stays in the model's dtype.
            weight_bytes = n_matmul + n_embed * dtype_bytes
        else:
            weight_bytes = config.num_params() * dtype_bytes
        kv_elems = (config.n_layers * slots * ctx * config.n_kv_heads
                    * config.head_dim * 2)
        kv_bytes = kv_elems * kv_bytes_per_elem
        if int8_scales:
            # Per-token f32 absmax scales for quantized K and V.
            kv_bytes += (config.n_layers * slots * ctx
                         * config.n_kv_heads * 2 * 4)
        return hbm_bw / (weight_bytes + kv_bytes) * slots

    def measure(kv_cache_dtype, weights_dtype=None):
        batcher = ContinuousBatcher(
            params, config,
            GeneratorConfig(max_seq_len=prompt_len + max_new + 1,
                            batch_size=slots, temperature=0.0,
                            prompt_buckets=[prompt_len],
                            kv_cache_dtype=kv_cache_dtype,
                            weights_dtype=weights_dtype),
            decode_chunk=chunk, device=device)
        chunk_times = []
        orig_step = batcher.step

        def timed_step():
            # Only pure decode ticks count as inter-token latency: a
            # tick with queued requests runs the grouped prefill first.
            pure_decode = batcher.num_queued == 0
            t0 = _now(device)
            orig_step()
            if pure_decode:
                chunk_times.append(_now(device) - t0)

        def run_batch(record=False):
            batcher.step = timed_step if record else orig_step
            prompts = [[(7 * (i + 1)) % config.vocab_size] * prompt_len
                       for i in range(slots)]
            rids = [batcher.submit(p, max_new_tokens=max_new)
                    for p in prompts]
            batcher.run_until_idle()
            return sum(len(batcher.result(r)) for r in rids)

        try:
            run_batch()                      # capture warmup (discarded)
            gc.collect()                     # see steady_tok_s
            t0 = _now(device)
            generated = run_batch(record=True)
            generated += run_batch(record=True)   # more latency samples
            dt = _now(device) - t0
            pool_stats = batcher.pool.stats() if batcher.pooled else None
            pooled = batcher.pooled
            streamed_rows = (batcher.table_width * batcher.block_size
                             if pooled else prompt_len + max_new + 1)
        finally:
            batcher.close()
        per_token_ms = sorted(1e3 * t / chunk for t in chunk_times)
        # Steady-state decode: slots x chunk tokens over the median pure
        # decode chunk, what a saturated server sustains between
        # admissions (the figure the HBM roofline bounds); decode_tok_s
        # also pays prefill, admission and host bookkeeping.
        steady = (slots * chunk / np.median(chunk_times)
                  ) if chunk_times else None
        kv_b = 1 if kv_cache_dtype == 'int8' else dtype_bytes
        scales = kv_cache_dtype == 'int8'
        bound = roofline_tok_s(kv_b, avg_ctx, weights_dtype, scales)
        stream_bound = roofline_tok_s(kv_b, streamed_rows, weights_dtype,
                                      scales)
        tok_s = generated / dt
        result = {
            'decode_tok_s': round(tok_s, 1),
            'steady_decode_tok_s': (round(steady, 1)
                                    if steady else None),
            'roofline_tok_s': round(bound, 1),
            'roofline_streamed_tok_s': round(stream_bound, 1),
            'roofline_pct': round(100 * tok_s / bound, 1),
            'steady_roofline_pct': (round(100 * steady / bound, 1)
                                    if steady else None),
            'steady_streamed_roofline_pct': (
                round(100 * steady / stream_bound, 1)
                if steady else None),
            'latency_per_token_ms_p50': round(np.percentile(
                per_token_ms, 50), 3) if per_token_ms else None,
            'latency_per_token_ms_p99': round(np.percentile(
                per_token_ms, 99), 3) if per_token_ms else None,
        }
        if pooled:
            result['pool'] = pool_stats
        return result

    def steady_tok_s(gen_cfg, d_chunk, n_prompt, n_new):
        """Median pure-decode steady tok/s of one batcher config (the
        timed-step machinery of measure(), without its rooflines)."""
        batcher = ContinuousBatcher(params, config, gen_cfg,
                                    decode_chunk=d_chunk, device=device)
        prompts = [[(7 * (i + 1)) % config.vocab_size] * n_prompt
                   for i in range(slots)]

        def run_batch():
            rids = [batcher.submit(p, max_new_tokens=n_new)
                    for p in prompts]
            batcher.run_until_idle()
            for r in rids:
                batcher.result(r)

        try:
            run_batch()     # capture warmup (visits every cache bucket)
            times = []
            orig_step = batcher.step

            def timed_step():
                pure_decode = batcher.num_queued == 0
                t0 = _now(device)
                orig_step()
                if pure_decode:
                    times.append(_now(device) - t0)

            batcher.step = timed_step
            # The timed batch starts from a collected heap: its median
            # rests on one or two chunks, and a full collection inside
            # one (0.35 s on the card, PERF.md) would be charged to it.
            gc.collect()
            run_batch()
        finally:
            batcher.close()
        return (slots * d_chunk / np.median(times)) if times else None

    def measure_bucket_win():
        """Legacy comparison (both arms pin decode_impl='inplace'):
        steady decode tok/s of length-bucketed slot caches vs the
        fixed-max_len cache when the average context is far below
        max_seq_len, with the pooled default on the same workload."""
        if on_card:
            w_max, w_prompt, w_new, w_chunk = 2048, 128, 256, 64
        else:
            w_max, w_prompt, w_new, w_chunk = 128, 8, 16, 8
        base = dict(max_seq_len=w_max, batch_size=slots,
                    temperature=0.0, prompt_buckets=[w_prompt])
        pooled = steady_tok_s(GeneratorConfig(**base), w_chunk,
                              w_prompt, w_new)
        bucketed = steady_tok_s(
            GeneratorConfig(**base, decode_impl='inplace'), w_chunk,
            w_prompt, w_new)
        fixed = steady_tok_s(
            GeneratorConfig(**base, decode_impl='inplace',
                            cache_buckets=[w_max]), w_chunk,
            w_prompt, w_new)
        return {
            'max_seq_len': w_max,
            'avg_context': w_prompt + w_new // 2,
            'pooled_steady_tok_s': (round(pooled, 1)
                                    if pooled else None),
            'bucketed_steady_tok_s': (round(bucketed, 1)
                                      if bucketed else None),
            'fixed_steady_tok_s': round(fixed, 1) if fixed else None,
            'speedup': (round(bucketed / fixed, 2)
                        if bucketed and fixed else None),
            'pooled_vs_fixed_speedup': (round(pooled / fixed, 2)
                                        if pooled and fixed else None),
        }

    def _migrations_total():
        from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics
        total = 0.0
        for family in telemetry_metrics.INFER_CACHE_MIGRATIONS.collect():
            for sample in family.samples:
                if sample.name.endswith('_total'):
                    total += sample.value
        return total

    # The migration counter's delta across the pooled variants must be
    # 0: bucket migration does not exist on the block-pool plane.  The
    # snapshot keeps the legacy arms below (which migrate) out of it.
    mig0 = _migrations_total()
    variants = {
        'bf16': measure(None),
        'int8_kv': measure('int8'),
        # Weight-only int8 + int8 KV: the full quantized serving config.
        'int8_w_kv': measure('int8', 'int8'),
    }
    pooled_migrations = _migrations_total() - mig0

    def measure_span_overhead():
        """Span-emission cost on the steady decode arm: the same
        workload with the module gate forced off, then on (spans land in
        the default in-process buffer; no trace file I/O)."""
        from skypilot_tpu_torch.telemetry import spans as spans_lib
        base = GeneratorConfig(max_seq_len=prompt_len + max_new + 1,
                               batch_size=slots, temperature=0.0,
                               prompt_buckets=[prompt_len])
        spans_lib.set_enabled(False)
        try:
            off = steady_tok_s(base, chunk, prompt_len, max_new)
            spans_lib.set_enabled(True)
            on = steady_tok_s(base, chunk, prompt_len, max_new)
        finally:
            spans_lib.set_enabled(None)
            spans_lib.default_buffer().clear()
        return {
            'spans_off_tok_s': round(off, 1) if off else None,
            'spans_on_tok_s': round(on, 1) if on else None,
            'span_overhead_pct': (round(100.0 * (off - on) / off, 2)
                                  if off and on else None),
        }

    out = {
        'slots': slots, 'max_new_tokens': max_new,
        'params_b': round(config.num_params() / 1e9, 2),
        **variants,
        'pooled_path_cache_migrations': pooled_migrations,
        'span_overhead': measure_span_overhead(),
        'bucketed_vs_fixed': measure_bucket_win(),
        'method': f'continuous batching, {slots} slots x {max_new} '
                  f'tokens, chunk {chunk}, greedy over 2 steady '
                  f'batches, decode_impl=pooled (paged attention over one '
                  f'block-pool KV arena a layer through per-slot block '
                  f'tables; on the card each decode chunk replays a CUDA '
                  f'graph); roofline = HBM bound on (weights + KV read) '
                  f'a step x slots at {hbm_bw / 1e9:.0f} GB/s: '
                  f'roofline_tok_s charges the ideal avg-context KV '
                  f'read, roofline_streamed_tok_s the rows the plane '
                  f'streams (table_width x block_size); latency = '
                  f'pure-decode chunk time / steps, synchronized '
                  f'(admission ticks excluded); int8_w_kv adds '
                  f'weight-only int8 on top of the int8 KV arena; '
                  f'steady_decode_tok_s = slots x chunk / median '
                  f'pure-decode chunk time; per-variant `pool` is the '
                  f'arena free-list stats at the end; bucketed_vs_fixed '
                  f'keeps the legacy inplace comparison with the pooled '
                  f'default on the same workload',
    }
    out['decode_tok_s'] = out['bf16']['decode_tok_s']
    return out


def bench_prefix_reuse(device) -> dict:
    """Radix prefix-cache win: a batch of requests sharing a long system
    prompt, cold (every prompt prefills from token 0) vs warm (the
    matched blocks splice into the slot's block table by refcount and
    only the tail prefills).  max_new_tokens=1 makes each run pure
    prefill + first token, so the batch's time is its TTFT;
    prefill_chunk == prefix_block isolates the skipped-token win."""
    import numpy as np

    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    device = torch.device(device)
    if _on_card(device):
        config = llama.LLAMA_1B
        slots, shared_len, tail, block = 8, 512, 64, 128
        max_seq, bucket = 1024, 1024
    else:
        config = llama.LLAMA_DEBUG
        slots, shared_len, tail, block = 2, 96, 8, 16
        max_seq, bucket = 256, 128
    params = _init_params(config, device)
    batcher = ContinuousBatcher(
        params, config,
        GeneratorConfig(max_seq_len=max_seq, batch_size=slots,
                        temperature=0.0, prompt_buckets=[bucket],
                        prefill_chunk=block, prefix_cache_mb=64,
                        prefix_block=block), device=device)
    vocab = config.vocab_size
    rng = np.random.RandomState(0)

    def make_batch(head, salt):
        # Distinct per-request tails: only the head is reusable.
        return [list(head) + [(salt + 7 * (i + 1) + j) % vocab
                              for j in range(tail)]
                for i in range(slots)]

    def run_batch(prompts):
        t0 = _now(device)
        rids = [batcher.submit(p, max_new_tokens=1) for p in prompts]
        batcher.run_until_idle()
        dt = _now(device) - t0
        assert all(len(batcher.result(r)) == 1 for r in rids)
        total = sum(len(p) for p in prompts)
        return {'prefill_tok_s': round(total / dt, 1),
                'ttft_s': round(dt, 4)}

    try:
        # Warmup on a disjoint token range: the first pass warms the
        # cold window path, the second the hit path; neither can match
        # the measured head below.
        warm_head = [int(t) for t in rng.randint(1, vocab // 2,
                                                 size=shared_len)]
        run_batch(make_batch(warm_head, 1))
        run_batch(make_batch(warm_head, 2))

        head = [int(t) for t in rng.randint(vocab // 2, vocab,
                                            size=shared_len)]
        pc = batcher._prefix
        saved0, hits0, miss0 = pc.tokens_saved, pc.hits, pc.misses
        cold = run_batch(make_batch(head, 3))
        cold_saved = pc.tokens_saved - saved0
        warm = run_batch(make_batch(head, 4))
        counts = (pc.tokens_saved - saved0 - cold_saved, pc.hits - hits0,
                  pc.misses - miss0)
    finally:
        batcher.close()
    return {
        'requests': slots,
        'shared_prefix_tokens': shared_len,
        'tail_tokens': tail,
        'prefix_block': block,
        'cold': cold,
        'warm': warm,
        'prefill_speedup': round(
            warm['prefill_tok_s'] / cold['prefill_tok_s'], 2),
        'ttft_speedup': round(cold['ttft_s'] / warm['ttft_s'], 2),
        'cold_tokens_saved': cold_saved,
        'warm_tokens_saved': counts[0],
        'hits': counts[1],
        'misses': counts[2],
        'method': f'{slots} requests sharing a {shared_len}-token '
                  f'system prompt + {tail}-token distinct tails, '
                  f'max_new=1 (pure prefill+first-token), '
                  f'prefill_chunk=prefix_block={block}; cold = first '
                  f'sight of the head (chunked-window prefill from 0, '
                  f'inserts blocks), warm = next batch with the same '
                  f'head (cached blocks splice into the slot block table '
                  f'by refcount, no KV copy, and only the tail '
                  f'prefills); ttft_s = submit-all to all first tokens, '
                  f'synchronized; warmup ran on a disjoint token range',
    }


def bench_tier_reuse(device) -> dict:
    """Tiered KV-cache win: a working set of shared heads ~10x the device
    prefix budget, revisited after churn.  Tier off, the LRU evicted
    almost every head before its revisit; tier on, the evictions spill
    to host memory and a routing hint ahead of each revisit prefetches
    the head back into pool blocks.  Greedy outputs must be identical
    between the arms before any ratio is reported."""
    import numpy as np

    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama

    device = torch.device(device)
    if _on_card(device):
        config = llama.LLAMA_1B
        heads, head_len, tail, block = 12, 512, 32, 128
        max_seq, bucket, max_new = 1024, 1024, 4
    else:
        config = llama.LLAMA_DEBUG
        heads, head_len, tail, block = 12, 96, 8, 16
        max_seq, bucket, max_new = 256, 128, 4
    blocks_per_head = head_len // block
    working_blocks = heads * blocks_per_head
    # Device prefix budget = working set / 10 in the trie's own unit
    # (pool-block bytes), so "10x over budget" holds by construction.
    head_dim = config.d_model // config.n_heads
    itemsize = torch.empty((), dtype=config.dtype).element_size()
    block_bytes = (2 * config.n_layers * block * config.n_kv_heads
                   * head_dim * itemsize)
    budget_blocks = max(blocks_per_head + 1, working_blocks // 10)
    prefix_mb = budget_blocks * block_bytes / 2**20
    host_mb = 2.0 * working_blocks * block_bytes / 2**20
    params = _init_params(config, device)
    rng = np.random.RandomState(0)
    vocab = config.vocab_size
    head_toks = [[int(t) for t in rng.randint(1, vocab, size=head_len)]
                 for _ in range(heads)]

    def tails(salt):
        return [[(salt + 11 * (i + 1) + j) % vocab for j in range(tail)]
                for i in range(heads)]

    def run_arm(tier_mb):
        batcher = ContinuousBatcher(
            params, config,
            GeneratorConfig(max_seq_len=max_seq, batch_size=2,
                            temperature=0.0, prompt_buckets=[bucket],
                            prefill_chunk=block, prefix_cache_mb=prefix_mb,
                            prefix_block=block, host_tier_mb=tier_mb),
            device=device)
        try:
            tier = batcher._tier
            outs = []
            # Populate: every head seen once; the device budget holds
            # ~1/10 of them, so most evict (and spill, tier on).
            t1 = tails(3)
            for i, h in enumerate(head_toks):
                rid = batcher.submit(h + t1[i], max_new_tokens=max_new)
                batcher.run_until_idle()
                outs.append(batcher.result(rid))
            if tier is not None:
                batcher.tier_flush()
            pc = batcher._prefix
            h0, m0 = pc.hits, pc.misses
            # Revisit in population order (LRU-hostile for the
            # device-only arm) with a routing hint ahead of each request.
            t2 = tails(4)
            for i, h in enumerate(head_toks):
                prompt = h + t2[i]
                if tier is not None:
                    batcher.prefetch_hint(prompt)
                    batcher.tier_flush()
                rid = batcher.submit(prompt, max_new_tokens=max_new)
                batcher.run_until_idle()
                outs.append(batcher.result(rid))
            if tier is not None:
                batcher.tier_flush()
            warm_hits = pc.hits - h0
            arm = {'warm_hit_ratio': round(warm_hits / heads, 3),
                   'warm_hits': warm_hits,
                   'warm_misses': pc.misses - m0}
            if tier is not None:
                s = tier.stats()
                arm.update({
                    'spills': s['spills'],
                    'prefetches': s['prefetches'],
                    'spill_gbps': round(
                        s['spill_bytes'] / s['spill_seconds'] / 1e9, 3)
                        if s['spill_seconds'] else None,
                    'prefetch_gbps': round(
                        s['prefetch_bytes'] / s['prefetch_seconds'] / 1e9,
                        3) if s['prefetch_seconds'] else None,
                    'host_hit_ratio': round(
                        s['host_hits'] / s['lookups'], 3)
                        if s['lookups'] else None,
                    'device_hit_ratio': round(
                        s['device_hits'] / s['lookups'], 3)
                        if s['lookups'] else None,
                    'prefetch_late_rate': round(
                        s['prefetch_late'] / s['lookups'], 3)
                        if s['lookups'] else None,
                    'host_resident_blocks': s['host_resident'],
                })
            batcher.pool.check_invariant()
        finally:
            batcher.close()
        return arm, outs

    no_tier, outs_off = run_arm(None)
    tiered, outs_on = run_arm(host_mb)
    assert outs_on == outs_off, (
        'tiered greedy outputs diverged from the no-tier arm — a '
        'spilled-then-prefetched block is not byte-exact')
    return {
        'heads': heads,
        'shared_head_tokens': head_len,
        'working_set_blocks': working_blocks,
        'device_budget_blocks': budget_blocks,
        'working_set_x_budget': round(working_blocks / budget_blocks, 1),
        'host_tier_mb': round(host_mb, 2),
        'no_tier': no_tier,
        'tier': tiered,
        'parity_ok': True,
        'method': f'{heads} heads x {head_len} shared tokens '
                  f'(+{tail}-token distinct tails), device prefix '
                  f'budget {budget_blocks} blocks vs a '
                  f'{working_blocks}-block working set; populate once, '
                  f'revisit in population order with a prefetch hint + '
                  f'flush ahead of each tiered request; warm_hit_ratio '
                  f'= prefix-cache hits over the revisit pass; greedy '
                  f'outputs asserted identical between arms',
    }


def bench_spec(device) -> dict:
    """Speculative-decoding win: greedy decode tokens/s and host syncs a
    token, spec on vs off, through the same pooled engine on two
    workloads: high_acceptance (the radix trie already holds each
    prompt's greedy continuation, so the drafter replays it) and
    adversarial (fresh random prompts, a cold drafter: the SpecPolicy
    gate must fall back to sequential chunks).  Every graph is captured
    before any timed region.  greedy_parity says whether spec-on greedy
    output equals spec-off's token for token, and agreeing_prefix_share
    how much of it does before each request's first difference: on the
    card bf16 rounds a verify row otherwise than a decode step."""
    import numpy as np

    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer.engine import Generator, GeneratorConfig
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.telemetry.metrics import REGISTRY

    device = torch.device(device)
    if _on_card(device):
        config = llama.LLAMA_1B
        slots, prompt_len, max_new, spec_k = 8, 32, 128, 12
        max_seq = 512
    else:
        config = llama.LLAMA_DEBUG
        slots, prompt_len, max_new, spec_k = 4, 16, 96, 12
        max_seq = 256
    params = _init_params(config, device)
    rng = np.random.RandomState(0)
    # The trie must hold every prompt's full continuation for the
    # high-acceptance arm to replay it: 4 MB at the debug shapes, and
    # as many 16-token blocks as the continuations take where 4 MB is
    # less (LLAMA_1B's 16-token block alone is 1 MiB).
    prefix_block = 16
    block_bytes = (2 * config.n_layers * prefix_block * config.n_kv_heads
                   * config.head_dim
                   * torch.empty((), dtype=config.dtype).element_size())
    continuation_blocks = slots * math.ceil((prompt_len + max_new + 1)
                                            / prefix_block)
    prefix_mb = max(4, continuation_blocks * block_bytes / 2**20)

    def prompts_batch():
        return [[int(t) for t in rng.randint(1, config.vocab_size,
                                             prompt_len)]
                for _ in range(slots)]

    def make_gen(spec):
        return Generator(params, config, GeneratorConfig(
            max_seq_len=max_seq, batch_size=slots, temperature=0.0,
            decode_impl='pooled', decode_chunk=8, spec_k=spec,
            prefix_cache_mb=prefix_mb, prefix_block=prefix_block),
            device=device)

    # Every device->host transfer of the decode path goes through
    # engine.host_fetch, whose own counter gives the timed region's syncs.
    fetch = engine_lib.host_fetch

    def timed(gen, ps_fn, reps=3):
        best, outs = None, None
        for _ in range(reps):
            ps = ps_fn()
            calls0 = fetch.calls
            t0 = _now(device)
            outs = gen.generate(ps, max_new_tokens=max_new)
            dt = _now(device) - t0
            total = sum(len(o) for o in outs)
            m = {'decode_tok_s': round(total / dt, 1),
                 'host_syncs_per_token': round(
                     (fetch.calls - calls0) / total, 4)}
            if best is None or m['decode_tok_s'] > best['decode_tok_s']:
                best = m
        return outs, best

    def _spec_counters():
        return (REGISTRY.get_sample_value(
                    'skytpu_infer_spec_proposed_tokens_total') or 0.0,
                REGISTRY.get_sample_value(
                    'skytpu_infer_spec_accepted_tokens_total') or 0.0)

    prompts = prompts_batch()

    g0 = make_gen(0)
    g0.generate(prompts, max_new_tokens=max_new)        # capture warmup
    ref, off = timed(g0, lambda: prompts)
    _, off_adv = timed(g0, prompts_batch)  # fresh prompts (full prefill)
    del g0
    _release(device)

    g1 = make_gen(spec_k)
    # Seed the trie with prompt+continuation: admission's cached
    # continuation hands the drafter its golden future.
    g1.generate([p + o for p, o in zip(prompts, ref)], max_new_tokens=1)
    g1.generate(prompts, max_new_tokens=max_new)        # warm verify
    g1.generate(prompts_batch(), max_new_tokens=max_new)  # warm seq path
    g1._spec_policy.ema = 1.0      # measured phase starts optimistic
    p0, a0 = _spec_counters()
    out, on_high = timed(g1, lambda: prompts)
    p1, a1 = _spec_counters()
    parity = out == ref
    agreeing = _agreeing_prefix_share(out, ref)
    on_high['accept_rate'] = round((a1 - a0) / max(p1 - p0, 1), 3)
    # Sustained-adversarial steady state: one untimed cold-drafter run
    # puts the EMA gate at its low-acceptance point; each rep draws
    # fresh prompts (the same prompts would fill the trie with their
    # continuations and turn the arm into a replay).
    g1.generate(prompts_batch(), max_new_tokens=max_new)
    pa0, aa0 = _spec_counters()
    _, on_adv = timed(g1, prompts_batch)
    pa1, aa1 = _spec_counters()
    on_adv['accept_rate'] = round((aa1 - aa0) / max(pa1 - pa0, 1), 3)
    del g1
    _release(device)
    return {
        'spec_k': spec_k,
        'slots': slots,
        'max_new_tokens': max_new,
        'greedy_parity': parity,
        'agreeing_prefix_share': agreeing,
        'prefix_cache_mb': round(prefix_mb, 2),
        'spec_off': off,
        'spec_off_adversarial': off_adv,
        'high_acceptance': on_high,
        'adversarial': on_adv,
        'speedup_high_acceptance': round(
            on_high['decode_tok_s'] / off['decode_tok_s'], 2),
        'adversarial_vs_off': round(
            on_adv['decode_tok_s'] / off_adv['decode_tok_s'], 2),
        'method': f'{slots} greedy slots, {max_new} new tokens, '
                  f'spec_k={spec_k}, decode_chunk=8, pooled plane, '
                  f'{str(config.dtype).split(".")[-1]} weights, '
                  f'prefix budget {prefix_mb:.0f} MB (the continuations '
                  f'fit); high_acceptance = trie pre-seeded with each '
                  f'prompt\'s own greedy continuation (drafter golden '
                  f'future), adversarial = fresh random prompts per '
                  f'rep (cold drafter, EMA gate falls back to '
                  f'sequential); best of 3 reps per arm; every graph '
                  f'captured before timing; syncs counted by '
                  f'engine.host_fetch.calls; greedy_parity = spec-on '
                  f'tokens equal to spec-off\'s, agreeing_prefix_share '
                  f'= the share before each request\'s first difference',
    }


def _agreeing_prefix_share(got, want) -> float:
    """The share of `want`'s tokens that `got` matches before each
    request's first difference: 1.0 is greedy parity."""
    same = total = 0
    for g, w in zip(got, want):
        n = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        same, total = same + n, total + len(w)
    return round(same / max(total, 1), 4)


# ---- the serving fleet (virtual time, debug shapes everywhere) -------------

def _fleet(sim_cfg, traffic, chaos=None, *, device):
    """A FleetSimulator of the port's batchers on `device` (LLAMA_DEBUG,
    its parameters from sim_cfg.model_seed)."""
    from skypilot_tpu_torch.serve.traffic import simulator as sim_lib
    return sim_lib.FleetSimulator(sim_cfg, traffic, chaos, device=device)


def _serve_trace_info(sim) -> dict:
    """Export one arm's merged Perfetto trace (sim plane pid 0 + every
    replica) and verify the request-lifecycle span chain: at least one
    traced request must show LB select -> queue -> admission -> prefill
    -> delivery end to end.  The trace lands in a temp file whose path
    is published."""
    import tempfile
    fd, path = tempfile.mkstemp(prefix='skytpu-serve-trace-',
                                suffix='.json')
    os.close(fd)
    os.unlink(path)     # export() must see a fresh path: its output is
    # byte-deterministic only when there is nothing to merge.
    events = sim.export_trace(path)
    with open(path, encoding='utf-8') as f:
        trace_events = json.load(f)['traceEvents']
    chains = {}
    for ev in trace_events:
        tid = (ev.get('args') or {}).get('trace_id')
        if tid:
            chains.setdefault(tid, set()).add(ev['name'])
    required = {'lb.select', 'queue_wait', 'admit', 'delivery'}
    full = sum(1 for names in chains.values()
               if required <= names
               and names & {'prefill_chunk', 'fused_tick'})
    return {
        'path': path,
        'events': events,
        'spans_captured': sim.span_count(),
        'decode_chunks': sum(1 for ev in trace_events
                             if ev['name'] == 'decode_chunk'),
        'requests_traced': len(chains),
        'full_chain_requests': full,
        'chain_ok': full >= 1,
    }


def bench_serve(device) -> dict:
    """Serving-fabric benchmark: `prefix_affinity` vs `least_load` on the
    same seeded open-loop trace, real ContinuousBatcher replicas,
    virtual-time cost model (the summary is deterministic for the seed
    on any machine).  Each replica's prefix budget holds half the head
    set: scattered routing thrashes every cache, affinity partitions the
    heads.  A two-tenant arm checks the cost ledger."""
    import dataclasses

    from skypilot_tpu_torch.serve.traffic.generator import TrafficConfig
    from skypilot_tpu_torch.serve.traffic.simulator import SimConfig

    traffic = TrafficConfig(seed=7, duration_s=24.0, base_rps=8.0,
                            burst_rate_mult=3.0, burst_every_s=8.0,
                            num_sessions=16, num_heads=8, head_tokens=64)

    def run(policy, trf=traffic):
        sim = _fleet(
            SimConfig(policy=policy, num_replicas=4, slo_ttft_s=1.0,
                      prefill_cost_per_token_s=4e-3,
                      decode_cost_per_token_s=2e-3,
                      batch_size=4, decode_chunk=4,
                      # ~4 head blocks: half the head set.
                      prefix_cache_mb=0.5),
            trf, device=device)
        return sim, sim.run()

    least_sim, least = run('least_load')
    least_sim.close()
    affinity_sim, affinity = run('prefix_affinity')
    try:
        trace_info = _serve_trace_info(affinity_sim)
    finally:
        affinity_sim.close()

    # Two-tenant arm: the same affinity config with sessions split 2:1
    # across tenants; the arrival trace is byte-equal to the affinity
    # arm's.
    tenant_sim, tenant_arm = run('prefix_affinity', dataclasses.replace(
        traffic, tenants=('default', 'default', 'heavy')))
    tenant_sim.close()
    acct = dict(tenant_arm.get('acct') or {})
    if acct:
        tokens = {t: (bill.get('prefill_tokens', 0)
                      + bill.get('decode_tokens', 0))
                  for t, bill in (acct.get('tenants') or {}).items()
                  if t != '_fleet'}
        tok_total = sum(tokens.values())
        acct['tenant_token_share'] = (
            {t: round(n / tok_total, 4)
             for t, n in sorted(tokens.items())} if tok_total else {})
        heavy_dev = (acct.get('attributed_share') or {}).get('heavy')
        heavy_tok = acct['tenant_token_share'].get('heavy')
        acct['heavy_share_gap_pct'] = (
            round(100.0 * abs(heavy_dev - heavy_tok), 2)
            if heavy_dev is not None and heavy_tok is not None else None)
        tds = acct.get('tenant_device_seconds') or {}
        total_ds = sum(tds.values())
        acct['fleet_overhead_share'] = (
            round(tds.get('_fleet', 0.0) / total_ds, 4)
            if total_ds else None)
    else:
        acct = {'error': 'two-tenant arm produced no acct block'}

    def _gain(key):
        base, new = least.get(key), affinity.get(key)
        if not base or new is None:
            return None
        return round(new / base, 3)

    return {
        # The reference's literal names 'trace' twice; its second value
        # (the exported trace) holds the first one's place.
        'trace': trace_info,
        'least_load': least,
        'prefix_affinity': affinity,
        'goodput_gain': _gain('goodput_rps'),
        'prefix_hit_gain': _gain('prefix_hit_ratio'),
        'acct': acct,
        'method': 'open-loop Poisson+burst trace (seeded) replayed '
                  'against 4 real ContinuousBatcher replicas per '
                  'policy; time is VIRTUAL (token-cost model: prefill '
                  '4ms/tok, decode 2ms/tok, 5ms/step), so TTFT/goodput '
                  'are deterministic for the seed; goodput counts '
                  'completions whose TTFT met the 1s SLO; per-replica '
                  'prefix cache holds ~4 of the 8 shared heads',
    }


def bench_fuse(device) -> dict:
    """Chunked-prefill piggyback benchmark: the same seeded mixed-length
    trace run with dedicated prefill windows (fuse_budget=None) vs fused
    prefill+decode steps, whose piggybacked tokens are charged at the
    fused rate: p99 TTFT should fall with decode TPOT held."""
    from skypilot_tpu_torch.serve.traffic.generator import TrafficConfig
    from skypilot_tpu_torch.serve.traffic.simulator import SimConfig

    # A quarter of the trace is long cold singletons through the
    # incremental chunked-prefill lane; the rest short session turns.
    # Both arms drain the trace.
    traffic = TrafficConfig(seed=7, duration_s=20.0, base_rps=1.5,
                            num_sessions=8, num_heads=4, head_tokens=48,
                            singleton_median=96, singleton_sigma=0.4,
                            max_prompt_tokens=180, out_median=16)

    def run(fuse_budget, fused_cost):
        sim = _fleet(
            SimConfig(policy='least_load', num_replicas=2,
                      slo_ttft_s=1.0,
                      prefill_cost_per_token_s=4e-3,
                      decode_cost_per_token_s=2e-3,
                      batch_size=4, decode_chunk=4, max_seq_len=256,
                      prefix_cache_mb=0.5,
                      prefill_chunk=16,
                      fuse_budget=fuse_budget,
                      fused_prefill_cost_per_token_s=fused_cost),
            traffic, device=device)
        try:
            summary = sim.run()
            fused_steps = piggybacked = 0
            for rep in sim.replicas + sim.retired:
                policy = rep.batcher._fuse_policy
                if policy is not None:
                    fused_steps += policy.stats.steps
                    piggybacked += policy.stats.prefill_tokens
        finally:
            sim.close()
        return summary, fused_steps, piggybacked

    dedicated, _, _ = run(None, None)
    # fuse_budget covers the full batch (4 slots) plus a 20-token chunk.
    fused, fused_steps, piggybacked = run(24, 1e-3)

    def _delta_pct(key):
        base, new = dedicated.get(key), fused.get(key)
        if not base or new is None:
            return None
        return round(100.0 * (new - base) / base, 2)

    return {
        'trace': {'seed': traffic.seed,
                  'duration_s': traffic.duration_s,
                  'base_rps': traffic.base_rps,
                  'singleton_median': traffic.singleton_median,
                  'requests': dedicated['requests']},
        'dedicated': dedicated,
        'fused': fused,
        'ttft_p99_delta_pct': _delta_pct('ttft_p99_ms'),
        'ttft_p50_delta_pct': _delta_pct('ttft_p50_ms'),
        'tpot_regression_pct': _delta_pct('tpot_ms'),
        'fused_steps': fused_steps,
        'piggybacked_tokens': piggybacked,
        'method': 'one seeded mixed-length trace (~25% long cold '
                  'singletons via the incremental chunked-prefill '
                  'lane, the rest short session turns) replayed '
                  'against 2 '
                  'real ContinuousBatcher replicas per arm; virtual '
                  'time: prefill 4ms/tok dedicated vs 1ms/tok fused '
                  '(piggybacked tokens fill the decode step\'s idle '
                  'compute), decode 2ms/tok, 5ms/step; '
                  'fuse_budget=24 over batch_size=4, '
                  'prefill_chunk=16, decode_chunk=4',
    }


def bench_disagg(device) -> dict:
    """Disaggregated prefill/decode benchmark: the same seeded mixed
    trace run as the fused single pool, as 1 prefill + 2 decode replicas
    with KV block handoff, and as that split on the burst-free trace
    (the TPOT yardstick), with greedy parity of the split against a
    single-pool run of the same config."""
    import dataclasses as _dc

    from skypilot_tpu_torch.serve.traffic.generator import TrafficConfig
    from skypilot_tpu_torch.serve.traffic.simulator import SimConfig

    traffic = TrafficConfig(seed=13, duration_s=12.0, base_rps=6.0,
                            burst_rate_mult=2.5, burst_every_s=5.0,
                            burst_scale_s=0.15,
                            session_share=0.85, burst_session_share=0.1,
                            num_sessions=8, num_heads=4, head_tokens=40,
                            tail_median=6, tail_sigma=0.5,
                            singleton_median=96, singleton_sigma=0.2,
                            max_prompt_tokens=128, out_median=64,
                            out_sigma=0.25, max_out_tokens=80,
                            min_out_tokens=24)

    def run(trf=traffic, outputs=False, **sim_kwargs):
        sim = _fleet(
            SimConfig(policy='least_load', num_replicas=3,
                      slo_ttft_s=1.0,
                      step_overhead_s=0.02,
                      prefill_cost_per_token_s=1e-3,
                      decode_cost_per_token_s=2e-4,
                      batch_size=8, decode_chunk=1, max_seq_len=256,
                      prefix_cache_mb=2.0, prefill_chunk=16,
                      host_tier_mb=4.0, **sim_kwargs),
            trf, device=device)
        try:
            summary = sim.run()
            return (sim.session_outputs() if outputs else None), summary
        finally:
            sim.close()

    # Fused single-pool baseline.
    _, fused = run(fuse_budget=6, fused_prefill_cost_per_token_s=2.5e-4)
    disagg_kwargs = dict(prefill_replicas=1,
                         disagg_cold_prompt_tokens=65)
    disagg_out, disagg = run(outputs=True, **disagg_kwargs)
    # Greedy parity witness: identical config minus the pool split.
    single_out, _ = run(outputs=True)
    parity_ok = disagg_out == single_out
    # TPOT yardstick: same fleet, no bursts.
    _, burst_free = run(trf=_dc.replace(traffic, burst_rate_mult=1.0),
                        **disagg_kwargs)

    d_tpot = (disagg.get('disagg') or {}).get('decode_tpot_p99_ms')
    b_tpot = (burst_free.get('disagg') or {}).get('decode_tpot_p99_ms')
    tpot_ratio = (round(d_tpot / b_tpot, 3)
                  if d_tpot and b_tpot else None)
    ttft_fused = fused.get('ttft_p99_ms')
    ttft_disagg = disagg.get('ttft_p99_ms')
    ttft_delta_pct = (round(100.0 * (ttft_disagg - ttft_fused)
                            / ttft_fused, 2)
                      if ttft_fused and ttft_disagg is not None
                      else None)
    return {
        'trace': {'seed': traffic.seed,
                  'duration_s': traffic.duration_s,
                  'base_rps': traffic.base_rps,
                  'burst_rate_mult': traffic.burst_rate_mult,
                  'burst_session_share': traffic.burst_session_share,
                  'singleton_median': traffic.singleton_median,
                  'requests': fused['requests']},
        'fused': fused,
        'disagg': disagg,
        'burst_free': burst_free,
        'ttft_p99_delta_pct': ttft_delta_pct,
        'ttft_win_ok': (ttft_disagg < ttft_fused
                        if ttft_fused and ttft_disagg is not None
                        else None),
        'decode_tpot_p99_ratio': tpot_ratio,
        'tpot_guard_ok': (tpot_ratio <= 1.05
                          if tpot_ratio is not None else None),
        'parity_ok': parity_ok,
        'method': 'one seeded mixed trace (steady long-decoding '
                  'session turns at 85% share keep decode batches '
                  'occupied; burst episodes at 2.5x rate carry ~90% '
                  'long cold singletons, median 96 tokens) replayed '
                  'against 3 replicas per arm; virtual time: 20ms '
                  'step overhead (HBM-bound decode), prefill 1ms/tok, '
                  'decode 0.2ms/tok, handoff images priced at the '
                  'tier links; disagg = 1 prefill + 2 decode '
                  'replicas, cold threshold 65 tokens (one whole 64-token trie node, the handoff unit); fused baseline '
                  '= single pool with fuse_budget=6 (chunk lane gets '
                  'budget minus active slots per step, so occupied '
                  'batches throttle cold prefill); decode_tpot_p99 '
                  'covers non-cold sessions only; parity_ok diffs '
                  'greedy outputs disagg vs single-pool',
    }


def bench_chaos(device) -> dict:
    """Chaos-tolerance benchmark: the same seeded trace run fault-free
    and with 1 of 4 replicas killed mid-burst and another preempted with
    notice; the delivered tokens must equal the fault-free arm's bit for
    bit (exactly once: none lost, none duplicated).  Failover latency
    and the TTFT tail show the guarantee's cost."""
    from skypilot_tpu_torch.serve.traffic.generator import TrafficConfig
    from skypilot_tpu_torch.serve.traffic.simulator import (ChaosConfig,
                                                            FaultEvent,
                                                            SimConfig)

    traffic = TrafficConfig(seed=23, duration_s=16.0, base_rps=8.0,
                            burst_rate_mult=3.0, burst_every_s=8.0,
                            num_sessions=12, num_heads=6, head_tokens=64,
                            session_share=0.85)
    # Fixed fractions of the trace: the kill lands inside the second
    # burst window.
    events = [
        FaultEvent(t=0.35 * traffic.duration_s, kind='kill', replica=0),
        FaultEvent(t=0.55 * traffic.duration_s, kind='preempt', replica=1),
    ]

    def run(chaos_cfg):
        sim = _fleet(
            SimConfig(policy='least_load', num_replicas=4, slo_ttft_s=1.5,
                      prefill_cost_per_token_s=4e-3,
                      decode_cost_per_token_s=2e-3,
                      batch_size=4, decode_chunk=4,
                      prefix_cache_mb=0.5),
            traffic, chaos_cfg, device=device)
        try:
            summary = sim.run()
            return sim.session_outputs(), summary
        finally:
            sim.close()

    base_out, base = run(None)
    chaos_out, chaos = run(ChaosConfig(events=events))

    tokens_lost = sum(
        max(0, len(ref) - len(chaos_out.get(sid, [])))
        for sid, ref in base_out.items())
    tokens_duplicated = sum(
        max(0, len(chaos_out.get(sid, [])) - len(ref))
        for sid, ref in base_out.items())
    bit_exact = chaos_out == base_out

    cz = chaos.get('chaos', {})

    def _inflation(key):
        b, c = base.get(key), chaos.get(key)
        if not b or c is None:
            return None
        return round(c / b, 3)

    return {
        'trace': {'seed': traffic.seed,
                  'duration_s': traffic.duration_s,
                  'base_rps': traffic.base_rps,
                  'sessions': len(base_out),
                  'requests': base['requests']},
        'faults': [{'t': e.t, 'kind': e.kind, 'replica': e.replica}
                   for e in events],
        'fault_free': base,
        'chaos': chaos,
        'sessions_total': len(base_out),
        'sessions_recovered': cz.get('sessions_recovered'),
        'sessions_handed_off': cz.get('sessions_handed_off'),
        'sessions_lost': cz.get('sessions_lost'),
        'tokens_lost': tokens_lost,
        'tokens_duplicated': tokens_duplicated,
        'bit_exact': bit_exact,
        'replayed_tokens': cz.get('replayed_tokens'),
        'circuit_opens': cz.get('circuit_opens'),
        'failover_p99_added_latency_ms': cz.get('failover_p99_ms'),
        'failover_p50_added_latency_ms': cz.get('failover_p50_ms'),
        'ttft_p99_inflation': _inflation('ttft_p99_ms'),
        'invariant_checks': cz.get('invariant_checks'),
        'method': 'one seeded open-loop trace replayed twice against 4 '
                  'real ContinuousBatcher replicas (virtual time): '
                  'fault-free arm, then kill replica 0 at 35% and '
                  'preempt replica 1 (with notice) at 55% of the trace; '
                  'delivered per-session token streams are diffed bit '
                  'for bit (exactly-once witness); failover latency = '
                  'detection through first replayed-commit on the '
                  'survivor; BlockPool.check_invariant() runs on every '
                  'survivor after each failover',
    }


# ---- checkpoints -------------------------------------------------------------

def bench_ckpt(trainer) -> dict:
    """Checkpoint cost on the train state the run just measured: stall_s
    is what the step loop pays for an async save (the device->host
    snapshot; save returns before any byte reaches disk), total_s the
    snapshot plus the background hash/write/commit."""
    import shutil
    import tempfile

    from skypilot_tpu_torch.ckpt import format as ckpt_format
    root = tempfile.mkdtemp(prefix='skytpu-bench-ckpt-')
    try:
        t0 = time.perf_counter()
        trainer.save_checkpoint(root, blocking=False)
        stall = time.perf_counter() - t0
        trainer.wait_for_checkpoints(root)
        total = time.perf_counter() - t0
        manifest = ckpt_format.load_manifest(root, trainer.step)
        nbytes = int(manifest['bytes'])
    finally:
        manager = trainer._ckpt_managers.pop(root, None)
        if manager is not None:
            manager.close()
        shutil.rmtree(root, ignore_errors=True)
    return {
        'bytes': nbytes,
        'gb': round(nbytes / 1e9, 3),
        'stall_s': round(stall, 4),
        'total_s': round(total, 4),
        'hidden_s': round(total - stall, 4),
        'write_gbps': round(nbytes / 1e9 / max(total - stall, 1e-9), 2),
        'method': 'async save of the live params+opt_state; stall = '
                  'save() call wall (snapshot only), total = through '
                  'commit (wait_for_checkpoints)',
    }


def bench_resume(trainer) -> dict:
    """Elastic-resume cost on the live train state: same-topology
    restore vs restore-with-reshard (a 4-process checkpoint in
    even_row_shard's layout read back by this one process).  The bytes
    are the same, so the difference is the machinery."""
    import shutil
    import tempfile

    from skypilot_tpu_torch.ckpt import format as ckpt_format
    named, treedef = ckpt_format.flatten_with_keys(trainer._state_dict())
    state = ckpt_format.tree_unflatten(treedef, [
        leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf
        for _, leaf in named])
    same_root = tempfile.mkdtemp(prefix='skytpu-bench-resume-same-')
    grid_root = tempfile.mkdtemp(prefix='skytpu-bench-resume-grid-')
    try:
        ckpt_format.save_pytree(same_root, 1, state)
        writer_grid = 4
        for p in range(writer_grid):
            ckpt_format.write_process_shards(
                grid_root, 1,
                ckpt_format.even_row_windows(state, p, writer_grid),
                process_index=p, process_count=writer_grid)
        ckpt_format.commit(grid_root, 1, process_count=writer_grid)
        t0 = time.perf_counter()
        ckpt_format.restore_pytree(same_root, 1, state)
        same_s = time.perf_counter() - t0
        stats = {}
        t0 = time.perf_counter()
        ckpt_format.restore_pytree_resharded(grid_root, 1, state,
                                             stats=stats)
        reshard_s = time.perf_counter() - t0
        manifest = ckpt_format.load_manifest(grid_root, 1)
        nbytes = int(manifest['bytes'])
    finally:
        shutil.rmtree(same_root, ignore_errors=True)
        shutil.rmtree(grid_root, ignore_errors=True)
    return {
        'bytes': nbytes,
        'gb': round(nbytes / 1e9, 3),
        'restore_same_topology_s': round(same_s, 4),
        'restore_reshard_4_to_1_s': round(reshard_s, 4),
        'reshard_overhead_s': round(reshard_s - same_s, 4),
        'reshard_files_read': stats.get('files_read'),
        'method': 'restore of the live params+opt_state from a '
                  '1-process checkpoint vs a simulated 4-process '
                  'axis-0-sharded checkpoint (global index-map '
                  'assembly), same bytes',
    }


def bench_launch_latency() -> dict:
    """Launch -> first job output line goes through the orchestrator
    (sky.launch on the local cloud), which the port does not have."""
    return {'launch_to_first_line_s': None,
            'skipped': 'the port has no orchestrator: launches go '
                       'through the JAX package\'s sky.launch'}


# ---- roll-ups ------------------------------------------------------------------

def trace_summary(decode: dict, serve: dict) -> dict:
    """Request-tracing + step-phase roll-up for the TRACE_SUMMARY line:
    per-phase step-time shares from the registry's
    `skytpu_infer_step_phase_seconds` histograms, span counts and chain
    verification from bench_serve's exported trace, the spans-on/off
    decode overhead arm, and the SLO burn rates of the affinity arm."""
    from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics
    sums = {}
    for family in telemetry_metrics.INFER_STEP_PHASE_SECONDS.collect():
        for sample in family.samples:
            if sample.name.endswith('_sum'):
                sums[sample.labels['phase']] = sample.value
    total = sum(sums.values())
    shares = ({phase: round(v / total, 4)
               for phase, v in sorted(sums.items())} if total else {})
    trace = serve.get('trace') if isinstance(serve, dict) else None
    trace = trace if isinstance(trace, dict) else {}
    overhead = decode.get('span_overhead') if isinstance(decode, dict) \
        else None
    overhead = overhead if isinstance(overhead, dict) else {}
    affinity = serve.get('prefix_affinity') if isinstance(serve, dict) \
        else None
    affinity = affinity if isinstance(affinity, dict) else {}
    return {
        'step_phase_shares': shares,
        'step_phase_seconds_total': round(total, 4),
        'spans_captured': trace.get('spans_captured'),
        'trace_events': trace.get('events'),
        'trace_path': trace.get('path'),
        'requests_traced': trace.get('requests_traced'),
        'full_chain_requests': trace.get('full_chain_requests'),
        'chain_ok': trace.get('chain_ok'),
        'span_overhead_pct': overhead.get('span_overhead_pct'),
        'slo_burn_fast': affinity.get('slo_burn_fast'),
        'slo_burn_slow': affinity.get('slo_burn_slow'),
    }


def _error_brief(d: dict) -> dict:
    return {'error': str(d['error'])[:120]}


def _decode_brief(d):
    if not isinstance(d, dict):
        return None
    if 'error' in d:
        return _error_brief(d)
    brief = {}
    for variant in ('bf16', 'int8_kv', 'int8_w_kv'):
        v = d.get(variant)
        if isinstance(v, dict):
            brief[variant] = {
                'e2e_tok_s': v.get('decode_tok_s'),
                'steady_tok_s': v.get('steady_decode_tok_s'),
                'roofline_pct': v.get('roofline_pct'),
                'steady_roofline_pct': v.get('steady_roofline_pct'),
            }
    return brief


def build_headline(tok_s: float, mfu: float, llama8b: dict,
                   decode: dict, latency: dict, *,
                   prefix: dict = None, serve: dict = None,
                   spec: dict = None, mesh: dict = None,
                   chaos: dict = None, fuse: dict = None,
                   trace: dict = None, tier: dict = None,
                   disagg: dict = None) -> dict:
    """Compact tail-safe summary of every headline number, printed last
    as `BENCH_HEADLINE {...}` so any tail capture holds all of them."""
    headline = {
        'llama_1b_tok_s_chip': round(tok_s, 1),
        'llama_1b_mfu_pct': round(100 * mfu, 1),
        'llama_8b_tok_s_chip': llama8b.get('tok_s_chip_extrapolated'),
        'llama_8b_mfu_pct': llama8b.get('mfu_pct'),
        'llama_8b_extrapolation_check_pct':
            llama8b.get('extrapolation_check_pct'),
        'decode': _decode_brief(decode),
        'launch_to_first_line_s': (latency or {}).get(
            'launch_to_first_line_s'),
        'vs_baseline': (None if TARGET_TOKENS_PER_SEC_PER_CHIP is None
                        else round(tok_s / TARGET_TOKENS_PER_SEC_PER_CHIP,
                                   3)),
    }
    if isinstance(decode, dict) and 'error' not in decode:
        bf16 = decode.get('bf16')
        pool_stats = bf16.get('pool') if isinstance(bf16, dict) else None
        if isinstance(pool_stats, dict):
            headline['pool'] = {
                'blocks_total': pool_stats.get('blocks_total'),
                'hwm': pool_stats.get('hwm'),
                'table_appends': pool_stats.get('table_appends'),
                'prefix_shares': pool_stats.get('prefix_shares'),
                'pooled_path_cache_migrations':
                    decode.get('pooled_path_cache_migrations'),
            }
    if isinstance(prefix, dict):
        headline['prefix'] = _error_brief(prefix) if 'error' in prefix \
            else {
                'ttft_cold_s': prefix.get('cold', {}).get('ttft_s'),
                'ttft_warm_s': prefix.get('warm', {}).get('ttft_s'),
                'prefill_speedup': prefix.get('prefill_speedup'),
            }
    if isinstance(tier, dict):
        on = tier.get('tier', {})
        headline['tier'] = _error_brief(tier) if 'error' in tier else {
            'warm_hit_ratio': on.get('warm_hit_ratio'),
            'warm_hit_ratio_no_tier': tier.get('no_tier', {}).get(
                'warm_hit_ratio'),
            'working_set_x_budget': tier.get('working_set_x_budget'),
            'spill_gbps': on.get('spill_gbps'),
            'prefetch_gbps': on.get('prefetch_gbps'),
            'prefetch_late_rate': on.get('prefetch_late_rate'),
            'parity_ok': tier.get('parity_ok'),
        }
    if isinstance(serve, dict):
        affinity = serve.get('prefix_affinity', {})
        headline['serve'] = _error_brief(serve) if 'error' in serve else {
            'goodput_gain': serve.get('goodput_gain'),
            'prefix_hit_gain': serve.get('prefix_hit_gain'),
            'affinity_ttft_p99_ms': affinity.get('ttft_p99_ms'),
            'least_load_ttft_p99_ms': serve.get(
                'least_load', {}).get('ttft_p99_ms'),
            'slo_burn_fast': affinity.get('slo_burn_fast'),
            'slo_burn_slow': affinity.get('slo_burn_slow'),
        }
        acct = serve.get('acct')
        if isinstance(acct, dict):
            headline['acct'] = _error_brief(acct) if 'error' in acct else {
                'conservation_ratio': acct.get('conservation_ratio'),
                'fleet_overhead_share': acct.get('fleet_overhead_share'),
                'heavy_share_gap_pct': acct.get('heavy_share_gap_pct'),
                'tenant_device_share': acct.get('attributed_share'),
                'tenants': sorted(acct.get('attributed_share') or {}),
            }
    if isinstance(chaos, dict):
        headline['chaos'] = _error_brief(chaos) if 'error' in chaos else {
            'bit_exact': chaos.get('bit_exact'),
            'sessions_lost': chaos.get('sessions_lost'),
            'tokens_lost': chaos.get('tokens_lost'),
            'tokens_duplicated': chaos.get('tokens_duplicated'),
            'failover_p99_added_latency_ms': chaos.get(
                'failover_p99_added_latency_ms'),
        }
    if isinstance(fuse, dict):
        headline['fuse'] = _error_brief(fuse) if 'error' in fuse else {
            'ttft_p99_dedicated_ms': fuse.get(
                'dedicated', {}).get('ttft_p99_ms'),
            'ttft_p99_fused_ms': fuse.get('fused', {}).get('ttft_p99_ms'),
            'ttft_p99_delta_pct': fuse.get('ttft_p99_delta_pct'),
            'tpot_regression_pct': fuse.get('tpot_regression_pct'),
            'piggybacked_tokens': fuse.get('piggybacked_tokens'),
        }
    if isinstance(disagg, dict):
        if 'error' in disagg:
            headline['disagg'] = _error_brief(disagg)
        else:
            dd = disagg.get('disagg', {}).get('disagg') or {}
            headline['disagg'] = {
                'ttft_p99_fused_ms': disagg.get(
                    'fused', {}).get('ttft_p99_ms'),
                'ttft_p99_disagg_ms': disagg.get(
                    'disagg', {}).get('ttft_p99_ms'),
                'ttft_p99_delta_pct': disagg.get('ttft_p99_delta_pct'),
                'ttft_win_ok': disagg.get('ttft_win_ok'),
                'decode_tpot_p99_ratio': disagg.get(
                    'decode_tpot_p99_ratio'),
                'tpot_guard_ok': disagg.get('tpot_guard_ok'),
                'prefill_replicas': dd.get('prefill_replicas'),
                'decode_replicas': dd.get('decode_replicas'),
                'handoffs': dd.get('handoffs'),
                'handoffs_failed': dd.get('handoffs_failed'),
                'parity_ok': disagg.get('parity_ok'),
            }
    if isinstance(spec, dict):
        headline['spec'] = _error_brief(spec) if 'error' in spec else {
            'speedup_high_acceptance': spec.get('speedup_high_acceptance'),
            'adversarial_vs_off': spec.get('adversarial_vs_off'),
            'accept_rate': spec.get('high_acceptance', {}).get(
                'accept_rate'),
            'greedy_parity': spec.get('greedy_parity'),
        }
    if isinstance(mesh, dict):
        if 'error' in mesh:
            headline['mesh'] = _error_brief(mesh)
        elif 'skipped' in mesh:
            headline['mesh'] = {'skipped': str(mesh['skipped'])[:120]}
        else:
            headline['mesh'] = {
                'ranks': mesh.get('ranks'),
                'allreduce_busbw_gbps': mesh.get(
                    'allreduce', {}).get('busbw_gbps'),
                'allgather_busbw_gbps': mesh.get(
                    'allgather', {}).get('busbw_gbps'),
                'sharded_decode_tok_s_chip': mesh.get(
                    'sharded_decode_tok_s_chip'),
                'collective_time_share_est': mesh.get(
                    'collective_time_share_est'),
                'overlap': mesh.get('overlap'),
                'virtual_devices': mesh.get('virtual_devices', False),
            }
    if isinstance(trace, dict):
        headline['trace'] = _error_brief(trace) if 'error' in trace else {
            'step_phase_shares': trace.get('step_phase_shares'),
            'spans_captured': trace.get('spans_captured'),
            'full_chain_requests': trace.get('full_chain_requests'),
            'span_overhead_pct': trace.get('span_overhead_pct'),
            'slo_burn_fast': trace.get('slo_burn_fast'),
            'slo_burn_slow': trace.get('slo_burn_slow'),
        }
    if 'suspect' in llama8b:
        headline['llama_8b_suspect'] = llama8b['suspect']
    if 'error' in llama8b:
        headline['llama_8b_error'] = str(llama8b['error'])[:120]
    if latency and 'error' in latency:
        headline['launch_latency_error'] = str(latency['error'])[:120]
    return headline


# ---- the training headline and the run ------------------------------------

def train_config(device):
    """(model config, batch, seq, steps) of the training headline: the
    1B's widths in bf16 with remat 'dots' and loss_chunk 256, 8 x 1024
    tokens, 12 steps, on the card; LLAMA_DEBUG on the CPU."""
    import dataclasses

    from skypilot_tpu_torch.models import llama
    if _on_card(device):
        config = dataclasses.replace(
            llama.LLAMA_1B, max_seq_len=2048, dtype=torch.bfloat16,
            remat=True, remat_policy='dots', loss_chunk=256)
        return config, 8, 1024, 12
    return llama.LLAMA_DEBUG, 2, 64, 4


def bench_train(device):
    """The training headline through Trainer.fit: (tokens/s a card, MFU
    = 6N x tokens/s / peak, fit's summary, the trainer)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import TrainConfig, Trainer
    from skypilot_tpu_torch.train import synthetic_batches

    device = torch.device(device)
    config, batch_size, seq, steps = train_config(device)
    params = _init_params(config, device)

    def loss(p, batch):
        return llama.loss_fn(p, batch, config)

    trainer = Trainer(loss, params,
                      TrainConfig(warmup_steps=2, total_steps=steps),
                      device=device)
    del params
    batches = synthetic_batches(batch_size, seq, config.vocab_size)
    n_params = config.num_params()
    flops_per_token = 6 * n_params
    peak = CARD_PEAK_FLOPS if _on_card(device) else CPU_PEAK_FLOPS
    summary = trainer.fit(batches, steps, log_every=0,
                          tokens_per_batch=batch_size * seq,
                          flops_per_token=flops_per_token,
                          peak_flops=peak)
    tok_s = summary['tokens_per_sec']
    mfu = tok_s * flops_per_token / peak
    return tok_s, mfu, summary, trainer


def _safe(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # pylint: disable=broad-except
        return {'error': str(e)[:200]}


def _badness(run):
    # Hard error > suspect flag > cross-check error; the retry keeps the
    # run that ranks lower.
    return ('error' in run, 'suspect' in run,
            run.get('extrapolation_check_pct', float('inf')))


def _errored(value) -> bool:
    return isinstance(value, dict) and 'error' in value


def _summary_line(name: str, fn: Callable[[], Any]) -> bool:
    """Print `name {json}`; True when it carries an error."""
    try:
        value = fn()
    except Exception as e:  # pylint: disable=broad-except
        value = {'error': str(e)[:200]}
    print(f'{name} ' + json.dumps(value), flush=True)
    return _errored(value)


def run(device) -> int:
    """Every sub-bench, the lines, the headline last; 1 when any
    sub-bench or summary failed, else 0."""
    device = torch.device(device)
    on_card = _on_card(device)
    card = card_line() if on_card else None

    # The 8B pieces run first, before the 1B trainer's state is resident.
    llama8b = _safe(bench_8b_extrapolated, device)
    if llama8b.get('extrapolation_check_pct', 0) > 10 or \
            'suspect' in llama8b or 'error' in llama8b:
        # One retry; keep the more trustworthy run, and say so.
        second = _safe(bench_8b_extrapolated, device)
        if _badness(second) < _badness(llama8b):
            llama8b = dict(second,
                           retried='first run failed the cross-check')
    _release(device)
    decode = _safe(bench_decode, device)
    prefix_reuse = _safe(bench_prefix_reuse, device)
    tier_reuse = _safe(bench_tier_reuse, device)
    serve = _safe(bench_serve, device)
    fuse = _safe(bench_fuse, device)
    disagg = _safe(bench_disagg, device)
    chaos = _safe(bench_chaos, device)
    spec = _safe(bench_spec, device)
    _release(device)
    allreduce = _safe(bench_allreduce, device)
    mesh_bench = _safe(bench_mesh, device)
    if 'skipped' in allreduce and isinstance(
            mesh_bench.get('allreduce'), dict):
        # The mesh bench's ranks measured a real multi-rank all-reduce:
        # publish it, with how it was obtained.
        allreduce = dict(mesh_bench['allreduce'],
                         via=mesh_bench.get('via', 'bench_mesh'))
    latency = bench_launch_latency()

    tok_s, mfu, summary, trainer = bench_train(device)
    config, _, _, _ = train_config(device)
    full = {
        'metric': 'llama_1b_train_tokens_per_sec_per_chip',
        'value': round(tok_s, 1),
        'unit': 'tokens/s/chip',
        'vs_baseline': None,
        'extra': {'chips': 1, 'platform': 'gpu' if on_card else 'cpu',
                  'device': (torch.cuda.get_device_name(device) if on_card
                             else 'cpu'),
                  'card': card,
                  'torch': torch.__version__,
                  'step_time_s': round(summary['step_time_s'], 4),
                  'loss': round(summary['loss'], 4),
                  'mfu_pct': round(100 * mfu, 1),
                  'params_b': round(config.num_params() / 1e9, 3),
                  'llama8b': llama8b,
                  'decode': decode,
                  'prefix_reuse': prefix_reuse,
                  'tier_reuse': tier_reuse,
                  'serve': serve,
                  'fuse': fuse,
                  'disagg': disagg,
                  'chaos': chaos,
                  'spec_decode': spec,
                  'allreduce': allreduce,
                  'mesh': mesh_bench,
                  'launch_latency': latency,
                  'method_notes': (
                      'vs_baseline is null: no tokens/s target is derived '
                      'for this card; MFU = 6N x tokens/s / '
                      f'{CARD_PEAK_FLOPS if on_card else CPU_PEAK_FLOPS:.3g}'
                      ' (one card\'s dense bf16 peak on the card); decode '
                      'rooflines at '
                      f'{CARD_HBM_BYTES_PER_S if on_card else CPU_HBM_BYTES_PER_S:.3g}'
                      ' B/s; chained timings are N carried steps, one '
                      'synchronize, best of 3, CUDA events; the mesh '
                      'numbers come from gloo ranks sharing the device '
                      '(virtual_devices), not an interconnect; launch '
                      'latency needs the orchestrator, which the port '
                      'does not have')},
    }
    print(json.dumps(full), flush=True)
    failed = any(_errored(v) for v in (
        llama8b, decode, prefix_reuse, tier_reuse, serve, fuse, disagg,
        chaos, spec, allreduce, mesh_bench))

    def telemetry():
        from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics
        registry = telemetry_metrics.REGISTRY
        p50 = telemetry_metrics.histogram_quantile(
            telemetry_metrics.TRAIN_STEP_SECONDS, 0.5,
            labels={'phase': 'steady'})
        p99 = telemetry_metrics.histogram_quantile(
            telemetry_metrics.TRAIN_STEP_SECONDS, 0.99,
            labels={'phase': 'steady'})
        steady = registry.get_sample_value(
            'skytpu_infer_steady_tokens_per_second')
        syncs_per_token = registry.get_sample_value(
            'skytpu_infer_host_syncs_per_token')
        bucket_chunks = {}
        for family in telemetry_metrics.INFER_DECODE_BUCKET_CHUNKS.collect():
            for sample in family.samples:
                if sample.name.endswith('_total'):
                    bucket_chunks[sample.labels['bucket']] = sample.value
        return {
            'train_step_p50_s': None if p50 is None else round(p50, 4),
            'train_step_p99_s': None if p99 is None else round(p99, 4),
            'decode_steady_tok_s':
                None if steady is None else round(steady, 1),
            'decode_host_syncs_per_token':
                None if syncs_per_token is None
                else round(syncs_per_token, 4),
            'decode_bucket_chunks': bucket_chunks,
        }

    def audit():
        from skypilot_tpu_torch.analysis import audit as audit_lib
        return audit_lib.quick_summary(device=device)

    def pool():
        from skypilot_tpu_torch.telemetry.metrics import REGISTRY
        gauge = REGISTRY.get_sample_value
        return {
            'blocks_total': gauge('skytpu_infer_pool_blocks_total'),
            'blocks_live': gauge('skytpu_infer_pool_blocks_live'),
            'blocks_free': gauge('skytpu_infer_pool_blocks_free'),
            'pool_hwm': gauge('skytpu_infer_pool_hwm'),
            'block_table_appends_total': gauge(
                'skytpu_infer_pool_block_table_appends_total'),
            'prefix_block_shares_total': gauge(
                'skytpu_infer_pool_prefix_block_shares_total'),
            'pooled_path_cache_migrations': decode.get(
                'pooled_path_cache_migrations')
                if isinstance(decode, dict) else None,
        }

    failed |= _summary_line('TELEMETRY_SUMMARY', telemetry)
    failed |= _summary_line('CKPT_SUMMARY', lambda: bench_ckpt(trainer))
    failed |= _summary_line('RESUME_SUMMARY', lambda: bench_resume(trainer))
    trainer.close()
    del trainer
    _release(device)
    failed |= _summary_line('AUDIT_SUMMARY', audit)
    failed |= _summary_line('POOL_SUMMARY', pool)
    for name, value in (('PREFIX_SUMMARY', prefix_reuse),
                        ('TIER_SUMMARY', tier_reuse),
                        ('SERVE_SUMMARY', serve),
                        ('FUSE_SUMMARY', fuse),
                        ('DISAGG_SUMMARY', disagg),
                        ('CHAOS_SUMMARY', chaos),
                        ('SPEC_SUMMARY', spec),
                        ('MESH_SUMMARY', mesh_bench)):
        print(f'{name} ' + json.dumps(value), flush=True)
    trace_roll = _safe(trace_summary, decode, serve)
    print('TRACE_SUMMARY ' + json.dumps(trace_roll), flush=True)
    acct_roll = serve.get('acct') if isinstance(serve, dict) else None
    if not isinstance(acct_roll, dict):
        acct_roll = {'error': 'serve bench emitted no acct block'}
    print('ACCT_SUMMARY ' + json.dumps(acct_roll), flush=True)
    failed |= _errored(trace_roll) or _errored(acct_roll)
    print('BENCH_HEADLINE ' + json.dumps(
        build_headline(tok_s, mfu, llama8b, decode, latency,
                       prefix=prefix_reuse, serve=serve, spec=spec,
                       mesh=mesh_bench, chaos=chaos, fuse=fuse,
                       trace=trace_roll, tier=tier_reuse,
                       disagg=disagg)), flush=True)
    return 1 if failed else 0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None,
                        help="'cpu' for the debug shapes on the host "
                             '(default: the CUDA card)')
    parser.add_argument('--mesh-child', action='store_true',
                        help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print('bench: no CUDA device; pass --device cpu for the debug '
              'shapes on the host', file=sys.stderr)
        return 2
    if args.mesh_child:
        # The ranks' target by its package path (this file may be
        # running as __main__, which a spawned rank cannot import).
        from skypilot_tpu_torch import bench as bench_mod
        from skypilot_tpu_torch.infer import multihost
        n = int(os.environ.get(MESH_RANKS_ENV, '0') or 0) or 4
        multihost.launch_local_ranks(n, bench_mod._mesh_rank,
                                     (args.device,))
        return 0
    from skypilot_tpu_torch.device import resolve_device
    return run(resolve_device(args.device))


if __name__ == '__main__':
    sys.exit(main())
