"""All-reduce bench over a mesh of ranks, with an optional sharded
decode.

Counterpart of examples/scripts/allreduce_bench.py: ``--ranks`` rank
processes of this host (train/mesh_run.py; default this host's cards)
on a mesh of dp = ranks time the backend's own all-reduce of
``--payload-mb`` (``collectives.psum_bench``: algbw and busbw, GB/s, as
nccl-tests report them) and this package's exact gather
(``collectives.all_gather_bench``).  With ``--sharded-decode`` the ranks
then serve a short greedy batch through the pooled decode plane sharded
over all of them (``multihost.make_replica_mesh``, the batcher on each
rank running the same calls in step), synchronous and with the
overlapped combines, whose tokens must be identical before a rate is
reported.  Rank 0 prints one JSON line with the reference's keys.  Run
as::

    python -m skypilot_tpu_torch.train.allreduce_bench --ranks 4 \\
        [--payload-mb 256 --iters 20] [--sharded-decode] [--device cpu]

Ranks that share one card run gloo through the host: their rates check
the schedule, they are not a multi-card rate (the JSON says so under
``note``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from skypilot_tpu_torch.train import mesh_run


def _sharded_decode_bench(device) -> dict:
    """Pooled sharded decode tok/s a rank over the replica mesh; every
    rank runs the same scripted workload."""
    from skypilot_tpu_torch.infer import engine, multihost, multihost_check
    from skypilot_tpu_torch.infer import tp as tp_lib
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    config = multihost_check._model()
    mesh = multihost.make_replica_mesh(n_kv_heads=config.n_kv_heads)
    gen = multihost_check._generator(device.type)
    params = tp_lib.init_sharded_params(config, gen, mesh, device)
    gen_config = multihost_check._gen_config()
    n = mesh.size

    def measure(gc):
        batcher = ContinuousBatcher(params, config, gc, mesh=mesh,
                                    device=device)

        def run_batch():
            rids = [batcher.submit(p, max_new_tokens=multihost_check.MAX_NEW)
                    for p in multihost_check.PROMPTS]
            batcher.run_until_idle()
            return [batcher.result(r) for r in rids]

        run_batch()                      # warmup (discarded)
        t0 = time.perf_counter()
        outs = run_batch()
        dt = time.perf_counter() - t0
        return sum(len(o) for o in outs) / dt, outs

    cfg_ovl = dataclasses.replace(gen_config, overlap_collectives=True)
    chunks = engine.resolve_overlap(params, config, cfg_ovl, mesh)
    sync_rate, sync_out = measure(dataclasses.replace(
        gen_config, overlap_collectives=False))
    ovl_rate, ovl_out = measure(cfg_ovl)
    if sync_out != ovl_out:
        raise AssertionError('overlapped sharded decode diverged from the '
                             f'sync schedule (chunks={chunks})')
    return {'ranks': n, 'generated_tokens': sum(len(o) for o in ovl_out),
            'decode_tok_s': round(ovl_rate, 1),
            'decode_tok_s_chip': round(ovl_rate / n, 2),
            'overlap': {
                'chunks': chunks,
                'decode_tok_s_chip_sync': round(sync_rate / n, 2),
                'decode_tok_s_chip_overlapped': round(ovl_rate / n, 2),
                'parity': 'bit-exact',
            },
            'mesh_axes': dict(mesh.shape)}


def run(args, device) -> dict:
    """One rank's share; the result every rank computes."""
    from skypilot_tpu_torch.parallel import collectives
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(dp=n))
    result = collectives.psum_bench(mesh, 'dp', payload_mb=args.payload_mb,
                                    iters=args.iters, device=device)
    result['gather'] = collectives.all_gather_bench(
        mesh, 'dp', payload_mb=args.payload_mb, iters=args.iters,
        device=device)
    result['backend'] = mesh.backend or 'none'
    if device.type == 'cuda' and mesh.backend == 'gloo':
        result['note'] = (f'{n} gloo ranks on {mesh_run.cards(None)} '
                          f'card(s), through the host: not a multi-card '
                          f'rate')
    if args.sharded_decode:
        result = {'allreduce': result,
                  'sharded_decode': _sharded_decode_bench(device)}
    return result


def _rank(local_rank: int, procs_per_host: int, argd: dict) -> None:
    args = argparse.Namespace(**argd)
    device, info = mesh_run.join(args.device, local_rank, procs_per_host)
    try:
        result = run(args, device)
        if info['rank'] == 0:
            print(json.dumps(result), flush=True)
    finally:
        mesh_run.leave()


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--payload-mb', type=float, default=256)
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--ranks', type=int, default=0,
                        help="rank processes (0 = this host's cards)")
    parser.add_argument('--sharded-decode', action='store_true',
                        help='also serve a short batch through the '
                             'pooled decode plane sharded over the ranks')
    parser.add_argument('--device', default=None,
                        help='default: the CUDA cards')
    args = parser.parse_args(argv)
    args.ranks = args.ranks or mesh_run.cards(args.device)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh_run.launch(args.ranks, _rank, vars(args))
    return 0


if __name__ == '__main__':
    sys.exit(main())
