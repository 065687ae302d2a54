#!/usr/bin/env python3
"""Which torch.distributed collectives gloo runs on CUDA tensors, on this
machine's torch: two rank processes on cuda:0 (gloo allows two ranks on
one card, NCCL does not) try all_reduce, broadcast, all_gather,
all_gather_into_tensor, reduce_scatter_tensor and send/recv, each in a
spawn of its own with a time limit, and print one JSON line per op:
whether it ran and gave the exact answer, or the error.
parallel/collectives.py builds its gathers on all_gather_into_tensor.
With --latency it times that gather instead: 2 and 4 ranks sharing
cuda:0, a (8, 4096) bf16 tensor (a decode step's combine at LLAMA3_8B),
200 gathers a rank, each waited on, beside the same gather of a CPU
tensor; one JSON line per (ranks, device) with the median ms a gather.

Run from the root of a checkout on a card:
    python3 scripts/torch_gloo_probe.py [--latency]
"""
from __future__ import annotations

import json
import multiprocessing
import socket
import subprocess
import sys
import traceback
from datetime import timedelta

import torch

OPS = ('all_reduce', 'broadcast', 'all_gather', 'all_gather_into_tensor',
       'reduce_scatter_tensor', 'send_recv')


def _rank(rank, op, port, queue):
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                                world_size=2, rank=rank,
                                timeout=timedelta(seconds=20))
        x = torch.full((4,), float(rank + 1), device='cuda')
        if op == 'all_reduce':
            dist.all_reduce(x)
            ok = x.tolist() == [3.0] * 4
        elif op == 'broadcast':
            dist.broadcast(x, 0)
            ok = x.tolist() == [1.0] * 4
        elif op == 'all_gather':
            out = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(out, x)
            ok = torch.cat(out).tolist() == [1.0] * 4 + [2.0] * 4
        elif op == 'all_gather_into_tensor':
            out = torch.empty(8, device='cuda')
            dist.all_gather_into_tensor(out, x)
            ok = out.tolist() == [1.0] * 4 + [2.0] * 4
        elif op == 'reduce_scatter_tensor':
            out = torch.empty(2, device='cuda')
            dist.reduce_scatter_tensor(out, torch.cat([x, x])[:4])
            ok = out.tolist() == [3.0] * 2
        else:
            if rank == 0:
                dist.send(x, 1)
                ok = True
            else:
                dist.recv(x, 0)
                ok = x.tolist() == [1.0] * 4
        queue.put((rank, ok, None))
        dist.destroy_process_group()
    except BaseException as e:  # the probe records every failure
        queue.put((rank, False, f'{type(e).__name__}: {e}'.splitlines()[0]
                   + ' | ' + traceback.format_exc().splitlines()[-1][:200]))


def _latency_rank(rank, world, port, device, queue):
    import statistics
    import time
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    x = torch.ones((8 * 4096 * 2,), dtype=torch.uint8, device=device)
    out = torch.empty((world * x.numel(),), dtype=torch.uint8,
                      device=device)
    times = []
    for i in range(220):
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(out, x)
        if device == 'cuda':
            torch.cuda.synchronize()
        if i >= 20:
            times.append((time.perf_counter() - t0) * 1e3)
    queue.put((rank, statistics.median(times)))
    dist.destroy_process_group()


def latency(world, device):
    ctx = multiprocessing.get_context('spawn')
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_latency_rank,
                         args=(r, world, port, device, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    ms = [queue.get(timeout=120)[1] for _ in procs]
    for p in procs:
        p.join(30)
    return {'ranks': world, 'device': device, 'bytes': 8 * 4096 * 2,
            'median_ms_a_gather': max(ms)}


def probe(op):
    ctx = multiprocessing.get_context('spawn')
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank, args=(r, op, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in procs:
            results.append(queue.get(timeout=60))
    except Exception as e:  # noqa: BLE001 (a hang is a result)
        results.append((None, False, f'no answer in 60 s: {e!r}'))
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
    return {'op': op, 'ran': all(ok for _, ok, _ in results)
            and len(results) == 2,
            'errors': sorted({e for _, _, e in results if e})}


def main():
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    if '--latency' in sys.argv[1:]:
        for world in (2, 4):
            for device in ('cuda', 'cpu'):
                print(json.dumps(dict(latency(world, device), card=card,
                                      torch=torch.__version__)), flush=True)
        return 0
    for op in OPS:
        print(json.dumps(dict(probe(op), card=card,
                              torch=torch.__version__)), flush=True)


if __name__ == '__main__':
    sys.exit(main())
