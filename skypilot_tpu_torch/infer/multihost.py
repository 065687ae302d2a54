"""One serving replica over several processes: the head's scheduler
calls, replayed by every worker.

Counterpart of skypilot_tpu/infer/multihost.py.  A sharded replica runs
one process a rank (parallel/mesh.py), each with its own
ContinuousBatcher over its shards; the ranks' collectives stay in step
only if every rank issues the same device work in the same order.  So
the scheduler runs on every rank: the head (rank 0) owns the HTTP
socket and broadcasts each mutating scheduler call over a TCP control
channel before running it; the workers replay the stream.  This is how
a multi-host replica runs, and how a single-host ``--tp k`` replica runs
its k processes (infer/replica.py).

Determinism: every value the host logic branches on (the sampled
tokens) comes out of gathered logits that are bitwise the same on every
rank (infer/tp.py), and sampled requests draw from generators seeded
alike on every rank, so the replicas' host control flow cannot diverge.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import random
import socket
import struct
import time
from typing import Any, List, Optional, Sequence

from skypilot_tpu_torch.utils import env_contract

logger = logging.getLogger(__name__)

# The control channel listens on the coordinator's port + 2 (+1 is the
# multislice coordinator's).
CONTROL_PORT_OFFSET = 2


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now (the local coordinator's)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def initialize_from_env(timeout_s: Optional[int] = None,
                        backend: Optional[str] = None,
                        procs_per_host: int = 1,
                        local_rank: int = 0) -> dict:
    """Join the replica's process group from the gang env contract
    (utils/env_contract.py).  Returns {num_hosts, host_id, rank, world,
    coordinator_host, control_port}; a world of one process initialises
    nothing."""
    num_hosts = int(os.environ.get(env_contract.NUM_PROCESSES, '1'))
    host_id = int(os.environ.get(env_contract.PROCESS_ID, '0'))
    coord = os.environ.get(env_contract.COORDINATOR_ADDRESS, '')
    rank, world = env_contract.initialize_from_env(
        timeout_s=timeout_s, backend=backend,
        procs_per_host=procs_per_host, local_rank=local_rank)
    if coord:
        host, port = coord.rsplit(':', 1)
        control_port = int(port) + CONTROL_PORT_OFFSET
    else:
        host, control_port = '127.0.0.1', 0
    return {'num_hosts': num_hosts, 'host_id': host_id, 'rank': rank,
            'world': world, 'coordinator_host': host,
            'control_port': control_port}


def make_replica_mesh(tp: Optional[int] = None,
                      n_kv_heads: Optional[int] = None, dp: int = 1):
    """('tp', 'tpq') mesh, or ('dp', 'tp', 'tpq') when dp > 1, over
    EVERY rank of the replica's process group (infer/tp.py's
    make_tp_mesh); a subset would leave ranks idle, and is refused."""
    import torch.distributed as dist
    from skypilot_tpu_torch.infer import tp as tp_lib
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    tp = tp or world // max(dp, 1)
    if dp * tp != world:
        raise ValueError(
            f'multi-host replica must use every chip: dp={dp} x tp={tp} '
            f'but the replica has {world} devices')
    return tp_lib.make_tp_mesh(tp, n_kv_heads=n_kv_heads, dp=dp)


# ---------------------------------------------------------------------------
# Control channel: the head broadcasts scheduler commands to the workers.
# ---------------------------------------------------------------------------


class ChannelBrokenError(RuntimeError):
    """A control-channel peer is gone: the replica's ranks can no longer
    stay in step.  Fatal for the replica: its serving process exits so
    the replica manager replaces it."""


def _auth_token() -> bytes:
    """The worker-admission token, derived from the gang env contract
    (every rank of the replica has the same one); SKYTPU_CONTROL_TOKEN
    overrides it where a deployment provisions a real secret."""
    explicit = os.environ.get('SKYTPU_CONTROL_TOKEN', '')
    seed = explicit or '|'.join((
        os.environ.get(env_contract.TASK_ID, ''),
        os.environ.get(env_contract.COORDINATOR_ADDRESS, ''),
        os.environ.get(env_contract.NODE_IPS, ''),
    ))
    return hashlib.sha256(('skytpu-control:' + seed).encode()).digest()


def _send_msg(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj).encode()
    sock.sendall(struct.pack('>I', len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b''
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError('control channel closed')
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> Any:
    (length,) = struct.unpack('>I', _recv_exact(sock, 4))
    op, args = json.loads(_recv_exact(sock, length).decode())
    return op, tuple(args)


class ControlChannel:
    """Head -> workers command broadcast over TCP: length-prefixed JSON
    (never pickle: a control port must not deserialize code), admission
    gated by the shared token.  The payloads are scheduler calls, not
    tensors: tensors move in the ranks' collectives."""

    def __init__(self, role: str, socks: List[socket.socket]):
        self.role = role
        self._socks = socks

    @classmethod
    def head(cls, port: int, num_workers: int,
             timeout_s: float = 120.0) -> 'ControlChannel':
        token = _auth_token()
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind(('0.0.0.0', port))
        server.listen(num_workers + 4)
        deadline = time.monotonic() + timeout_s
        socks: List[socket.socket] = []
        try:
            while len(socks) < num_workers:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionError(
                        f'only {len(socks)}/{num_workers} workers '
                        f'authenticated within {timeout_s}s')
                server.settimeout(remaining)
                conn, addr = server.accept()
                try:
                    conn.settimeout(10.0)
                    presented = _recv_exact(conn, len(token))
                    if not hmac.compare_digest(presented, token):
                        raise ConnectionError('bad token')
                    conn.settimeout(None)
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                except (ConnectionError, OSError) as e:
                    logger.warning('control: rejected peer %s: %s', addr, e)
                    conn.close()
                    continue
                socks.append(conn)
                logger.info('control: worker connected from %s', addr)
        except Exception:
            for sock in socks:
                sock.close()
            raise
        finally:
            server.close()
        return cls('head', socks)

    @classmethod
    def connect(cls, host: str, port: int,
                timeout_s: float = 120.0) -> 'ControlChannel':
        deadline = time.monotonic() + timeout_s
        last_err: Optional[Exception] = None
        # Exponential backoff with jitter: every worker retries this
        # rendezvous at once, and a fixed poll would keep them in step.
        delay = 0.2
        while time.monotonic() < deadline:
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(None)
                sock.sendall(_auth_token())
                return cls('worker', [sock])
            except OSError as e:  # the head is not listening yet
                last_err = e
                time.sleep(delay * random.uniform(0.5, 1.0))
                delay = min(delay * 2, 2.0)
        raise ConnectionError(
            f'control channel connect to {host}:{port} timed out: '
            f'{last_err}')

    def broadcast(self, obj: Any) -> None:
        assert self.role == 'head'
        try:
            for sock in self._socks:
                _send_msg(sock, obj)
        except OSError as e:
            raise ChannelBrokenError(
                f'worker control connection lost: {e}') from e

    def recv(self) -> Any:
        assert self.role == 'worker'
        return _recv_msg(self._socks[0])

    def close(self) -> None:
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# The scheduler on every rank: the same ContinuousBatcher call sequence.
# ---------------------------------------------------------------------------

# Calls that touch device state or the scheduler state that decides the
# next dispatch: they replay on every rank, in order.  'ping' is a
# liveness no-op the head sends while idle.
_MUTATING = ('submit', 'step', 'result', 'ping')


class MultiHostBatcher:
    """Head-side proxy: each mutating scheduler call is run locally and
    broadcast (submit and result first locally, so a bad request fails
    on the head only; step first broadcast, so the workers start their
    device work together).  Pure reads stay local: every rank's copy is
    the same."""

    def __init__(self, batcher, channel: ControlChannel):
        assert channel.role == 'head'
        self._batcher = batcher
        self._channel = channel

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature=None, top_p=None) -> int:
        prompt = [int(t) for t in prompt]
        rid = self._batcher.submit(prompt, max_new_tokens=max_new_tokens,
                                   temperature=temperature, top_p=top_p)
        # Sampling parameters are device operands of every rank's
        # decode: they ride the broadcast.
        self._channel.broadcast(('submit', (prompt, int(max_new_tokens),
                                            temperature, top_p)))
        return rid

    def step(self) -> None:
        self._channel.broadcast(('step', ()))
        self._batcher.step()

    def result(self, rid: int) -> List[int]:
        out = self._batcher.result(rid)
        self._channel.broadcast(('result', (int(rid),)))
        return out

    def ping(self) -> None:
        """Liveness probe: raises ChannelBrokenError once a worker died
        (the serving driver calls it while idle)."""
        self._channel.broadcast(('ping', ()))

    def run_until_idle(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self._batcher.num_queued and not self._batcher.num_active:
                return
            self.step()
        raise RuntimeError('run_until_idle exceeded max_ticks')

    def shutdown(self) -> None:
        self._channel.broadcast(('shutdown', ()))
        self._channel.close()

    def close(self) -> None:
        """shutdown() the workers, then close the local batcher."""
        self.shutdown()
        self._batcher.close()

    def is_done(self, rid: int) -> bool:
        return self._batcher.is_done(rid)

    def partial(self, rid: int):
        return self._batcher.partial(rid)

    @property
    def num_active(self) -> int:
        return self._batcher.num_active

    @property
    def num_queued(self) -> int:
        return self._batcher.num_queued

    def __getattr__(self, name):
        # Every other read (config, buckets, device, ttft, ...) is the
        # local batcher's: the same on every rank.
        return getattr(self._batcher, name)


def worker_loop(batcher, channel: ControlChannel) -> None:
    """A worker rank: replay the head's scheduler calls until shutdown.
    Any exception is fatal for the replica (its ranks have diverged)
    and propagates."""
    assert channel.role == 'worker'
    while True:
        op, args = channel.recv()
        if op == 'shutdown':
            channel.close()
            return
        if op not in _MUTATING:
            raise RuntimeError(f'unexpected control op {op!r}')
        if op == 'ping':
            continue
        if op == 'result':
            # Pops the request from the worker's mirror.
            batcher.result(*args)
        elif op == 'submit':
            prompt, max_new = args[0], args[1]
            temperature = args[2] if len(args) > 2 else None
            top_p = args[3] if len(args) > 3 else None
            batcher.submit(prompt, max_new_tokens=max_new,
                           temperature=temperature, top_p=top_p)
        else:
            batcher.step()


# ---------------------------------------------------------------------------
# A single-host replica of k processes.
# ---------------------------------------------------------------------------


def rank_device(device: Optional[str], local_rank: int) -> str:
    """A rank's device: 'cpu' when asked, else cuda:{local_rank % the
    host's card count} (ranks share a card when they outnumber them)."""
    if device == 'cpu':
        return 'cpu'
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           'ranks on the host')
    return f'cuda:{local_rank % torch.cuda.device_count()}'


def default_backend(device: Optional[str], world: int) -> str:
    """NCCL when every rank has a card of its own; gloo on the CPU and
    when ranks share a card (NCCL refuses two ranks on one GPU; gloo's
    collectives on CUDA tensors check semantics, not a multi-card
    rate)."""
    if device == 'cpu':
        return 'gloo'
    import torch
    return 'nccl' if torch.cuda.device_count() >= world else 'gloo'


def _rank_entry(env, local_rank, world, target, args):
    os.environ.update(env)
    target(local_rank, world, *args)


def launch_local_ranks(world: int, target, args=(),
                       timeout_s: Optional[float] = None) -> None:
    """Run target(local_rank, world, *args) in `world` processes of this
    host, with the env contract of one host of `world` ranks
    (coordinator 127.0.0.1 on a free port): each calls
    initialize_from_env(procs_per_host=world, local_rank=...).  Every
    rank's exit code is collected; any failure raises RuntimeError
    naming the ranks and codes."""
    import multiprocessing
    port = free_port()
    env = env_contract.make_env_vars(0, ['127.0.0.1'], world,
                                     coordinator_port=port)
    env.setdefault('SKYTPU_CONTROL_TOKEN',
                   os.environ.get('SKYTPU_CONTROL_TOKEN', f'local-{port}'))
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_rank_entry,
                         args=(env, r, world, target, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if failed:
        raise RuntimeError(f'ranks failed (rank, exit code): {failed}')
