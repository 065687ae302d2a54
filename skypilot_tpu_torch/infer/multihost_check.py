"""Multi-process decode parity check of a sharded replica.

Counterpart of skypilot_tpu/infer/multihost_check.py.  One process a
rank (``devices_per_host`` of them on each of ``num_hosts`` emulated
hosts), joined through the env contract (utils/env_contract.py) into
one process group; rank 0 submits the prompts through the
MultiHostBatcher control channel and the others replay its calls
(infer/multihost.py).  The head's greedy tokens must equal a
one-process, unsharded baseline.  On the CPU the ranks use gloo; on one
card they share it over gloo, which checks the sharded path's
semantics, not a multi-card rate.  The ranks run on the card unless
the caller asks for the CPU (``device='cpu'``, ``--device cpu``).

    python -m skypilot_tpu_torch.infer.multihost_check [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

import torch

from skypilot_tpu_torch.device import resolve_device

PROMPTS = [[5, 9, 2, 7], [11, 3]]
MAX_NEW = 8
_SEED = 2


def _model():
    """Small f32 llama whose axes divide over 4 ranks; 2 KV heads, so 4
    ranks exercise the GQA overshard (tp_kv 2 x tpq 2); head_dim 64, the
    smallest the card's attention kernels take."""
    from skypilot_tpu_torch.models import llama
    return llama.LlamaConfig(
        vocab_size=512, d_model=512, n_layers=2, n_heads=8, n_kv_heads=2,
        d_ff=1024, max_seq_len=512, dtype=torch.float32, remat=False)


def _gen_config():
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    return GeneratorConfig(max_seq_len=64, batch_size=2, temperature=0.0,
                           prompt_buckets=[16], decode_impl='pooled')


def _generator(device: str) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_SEED)
    return gen


def _device_kind(device: Optional[str]) -> str:
    """'cpu' when asked, else 'cuda' (raises without a card)."""
    return resolve_device(device).type


def baseline_decode(device: Optional[str] = None) -> List[List[int]]:
    """One process, unsharded: greedy decode of PROMPTS."""
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    device = _device_kind(device)
    config = _model()
    params = llama.init_params(config, _generator(device), device)
    batcher = ContinuousBatcher(params, config, _gen_config(),
                                device=device)
    rids = [batcher.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    batcher.run_until_idle()
    return [batcher.result(r) for r in rids]


def _rank_main(local_rank: int, devices_per_host: int, device: str,
               backend: str) -> None:
    """One rank (its own process); the host comes from the env
    contract, the device from multihost.rank_device."""
    import torch.distributed as dist
    from skypilot_tpu_torch.infer import multihost
    from skypilot_tpu_torch.infer import tp as tp_lib
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher

    device = multihost.rank_device(device, local_rank)
    info = multihost.initialize_from_env(
        timeout_s=300, backend=backend, procs_per_host=devices_per_host,
        local_rank=local_rank)
    config = _model()
    mesh = multihost.make_replica_mesh(n_kv_heads=config.n_kv_heads)
    params = tp_lib.init_sharded_params(config, _generator(device), mesh,
                                        device)
    batcher = ContinuousBatcher(params, config, _gen_config(), mesh=mesh,
                                device=device)
    if info['rank'] == 0:
        channel = multihost.ControlChannel.head(info['control_port'],
                                                info['world'] - 1)
        spmd = multihost.MultiHostBatcher(batcher, channel)
        rids = [spmd.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        spmd.ping()
        spmd.run_until_idle()
        outs = [spmd.result(r) for r in rids]
        spmd.shutdown()
        print('MULTIHOST_RESULT ' + json.dumps(outs), flush=True)
    else:
        channel = multihost.ControlChannel.connect(
            info['coordinator_host'], info['control_port'])
        multihost.worker_loop(batcher, channel)
    dist.destroy_process_group()


def run_check(num_hosts: int = 2, devices_per_host: int = 2,
              timeout_s: float = 600.0,
              baseline: Optional[Sequence[Sequence[int]]] = None,
              device: Optional[str] = None, backend: str = 'gloo'
              ) -> List[List[int]]:
    """Spawn num_hosts x devices_per_host rank processes, and return
    (and verify against baseline_decode) the head's tokens.  Every
    rank's exit code is checked: one failed rank fails the check."""
    from skypilot_tpu_torch.infer import multihost
    from skypilot_tpu_torch.utils import env_contract
    device = _device_kind(device)
    coord_port = multihost.free_port()
    ips = ['127.0.0.1'] * num_hosts
    procs = []
    for host in range(num_hosts):
        env = dict(os.environ, **env_contract.make_env_vars(
            host, ips, devices_per_host, coordinator_port=coord_port))
        env['SKYTPU_CONTROL_TOKEN'] = f'check-{coord_port}'
        for local in range(devices_per_host):
            procs.append(subprocess.Popen(
                [sys.executable, '-m',
                 'skypilot_tpu_torch.infer.multihost_check', '--rank-main',
                 str(local), str(devices_per_host), device, backend],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env))
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout_s)
            outputs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    failed = [(i, p.returncode) for i, p in enumerate(procs)
              if p.returncode != 0]
    if failed:
        i = failed[0][0]
        raise RuntimeError(
            f'multihost check ranks failed (rank, rc): {failed}:\n'
            f'{outputs[i][-4000:]}')
    for line in outputs[0].splitlines():
        if line.startswith('MULTIHOST_RESULT '):
            result = json.loads(line[len('MULTIHOST_RESULT '):])
            break
    else:
        raise RuntimeError(
            f'no result line from head:\n{outputs[0][-4000:]}')
    expected = list(map(list, baseline)) if baseline is not None \
        else baseline_decode(device)
    if result != expected:
        raise AssertionError(
            f'multi-host decode diverged from single-process baseline: '
            f'{result} vs {expected}')
    return result


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == '--rank-main':
        _rank_main(int(argv[1]), int(argv[2]), argv[3], argv[4])
        return
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--num-hosts', type=int, default=2)
    parser.add_argument('--devices-per-host', type=int, default=2)
    parser.add_argument('--device', default=None,
                        help="'cpu' for the host (default: the card)")
    args = parser.parse_args(argv)
    print(json.dumps(run_check(args.num_hosts, args.devices_per_host,
                               device=args.device)))


if __name__ == '__main__':
    main()
