"""The port's multi-process replica (infer/multihost.py,
infer/multihost_check.py, utils/env_contract.py) on the CPU.

Unit layer (the tests/test_multihost_decode.py cases, with fake
batchers): the control channel's framing and admission token, the head's
call stream replayed in order by a worker, ping and a broken channel,
validation errors kept on the head, unknown ops refused.  The env
contract builds the reference's variables, and initialize_from_env's
process grid numbers ranks host-major.  Integration layer: run_check's
4 rank processes (2 emulated hosts x 2, the GQA overshard tp_kv 2 x tpq
2 across processes) decode the single-process baseline's greedy tokens
through the control channel.
"""
import os
import socket
import threading
import time

import pytest

torch = pytest.importorskip('torch')

from skypilot_tpu.utils import env_contract as j_env  # noqa: E402
from skypilot_tpu_torch.infer import multihost  # noqa: E402
from skypilot_tpu_torch.infer import multihost_check  # noqa: E402
from skypilot_tpu_torch.utils import env_contract  # noqa: E402


class FakeBatcher:
    """Records the scheduler call stream; returns canned results."""

    def __init__(self):
        self.calls = []
        self._next = 1
        self.num_active = 0
        self.num_queued = 0

    def submit(self, prompt, max_new_tokens=64, temperature=None,
               top_p=None):
        self.calls.append(('submit', list(prompt), max_new_tokens))
        rid = self._next
        self._next += 1
        return rid

    def step(self):
        self.calls.append(('step',))

    def result(self, rid):
        self.calls.append(('result', rid))
        return [7, 8, 9]

    def is_done(self, rid):
        return True


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _head_worker_pair():
    port = _free_port()
    out = {}

    def accept():
        out['head'] = multihost.ControlChannel.head(port, 1)

    t = threading.Thread(target=accept)
    t.start()
    worker = multihost.ControlChannel.connect('127.0.0.1', port)
    t.join(timeout=10)
    return out['head'], worker


def test_control_channel_roundtrip():
    head, worker = _head_worker_pair()
    try:
        head.broadcast(('submit', ([1, 2, 3], 16)))
        head.broadcast(('step', ()))
        assert worker.recv() == ('submit', ([1, 2, 3], 16))
        assert worker.recv() == ('step', ())
    finally:
        head.close()
        worker.close()


def test_control_channel_closed_raises():
    head, worker = _head_worker_pair()
    head.close()
    with pytest.raises(ConnectionError):
        worker.recv()
    worker.close()


def test_spmd_replay_mirrors_call_stream():
    head_ch, worker_ch = _head_worker_pair()
    head_b, worker_b = FakeBatcher(), FakeBatcher()
    spmd = multihost.MultiHostBatcher(head_b, head_ch)
    done = threading.Event()

    def run_worker():
        multihost.worker_loop(worker_b, worker_ch)
        done.set()

    t = threading.Thread(target=run_worker, daemon=True)
    t.start()
    rid = spmd.submit([4, 5], max_new_tokens=8)
    spmd.step()
    assert spmd.result(rid) == [7, 8, 9]
    assert spmd.is_done(rid)  # a pure read: no broadcast
    spmd.shutdown()
    assert done.wait(timeout=10), 'worker_loop did not exit on shutdown'
    assert worker_b.calls == head_b.calls == [
        ('submit', [4, 5], 8), ('step',), ('result', rid)]


def test_head_rejects_bad_token():
    port = _free_port()
    out = {}

    def accept():
        out['head'] = multihost.ControlChannel.head(port, 1, timeout_s=30)

    t = threading.Thread(target=accept)
    t.start()
    deadline = time.monotonic() + 15
    while True:
        try:
            stranger = socket.create_connection(('127.0.0.1', port),
                                                timeout=10)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
    stranger.sendall(b'\x00' * 32)
    worker = multihost.ControlChannel.connect('127.0.0.1', port)
    t.join(timeout=15)
    assert 'head' in out
    try:
        out['head'].broadcast(('ping', ()))
        assert worker.recv() == ('ping', ())
        stranger.settimeout(5)
        assert stranger.recv(1) == b''
    finally:
        out['head'].close()
        worker.close()
        stranger.close()


def test_ping_liveness_and_broken_channel():
    head_ch, worker_ch = _head_worker_pair()
    spmd = multihost.MultiHostBatcher(FakeBatcher(), head_ch)
    spmd.ping()
    assert worker_ch.recv() == ('ping', ())
    worker_ch.close()
    with pytest.raises(multihost.ChannelBrokenError):
        for _ in range(50):  # buffered sends may take a few broadcasts
            spmd.ping()
    head_ch.close()


def test_submit_validation_error_stays_local():

    class RejectingBatcher(FakeBatcher):

        def submit(self, prompt, max_new_tokens=64, temperature=None,
                   top_p=None):
            raise ValueError('prompt too long')

    head_ch, worker_ch = _head_worker_pair()
    spmd = multihost.MultiHostBatcher(RejectingBatcher(), head_ch)
    try:
        with pytest.raises(ValueError):
            spmd.submit([1] * 100, max_new_tokens=4)
        spmd.ping()
        assert worker_ch.recv() == ('ping', ())
    finally:
        head_ch.close()
        worker_ch.close()


def test_worker_loop_rejects_unknown_op():
    head_ch, worker_ch = _head_worker_pair()
    try:
        head_ch.broadcast(('reboot', ()))
        with pytest.raises(RuntimeError, match='unexpected control op'):
            multihost.worker_loop(FakeBatcher(), worker_ch)
    finally:
        head_ch.close()
        worker_ch.close()


def test_auth_token_matches_reference(monkeypatch):
    from skypilot_tpu.infer import multihost as j_multihost
    monkeypatch.setenv(env_contract.COORDINATOR_ADDRESS, '10.0.0.1:8476')
    monkeypatch.setenv(env_contract.TASK_ID, 'task-1')
    assert multihost._auth_token() == j_multihost._auth_token()
    monkeypatch.setenv('SKYTPU_CONTROL_TOKEN', 'secret')
    assert multihost._auth_token() == j_multihost._auth_token()
    assert multihost.CONTROL_PORT_OFFSET == j_multihost.CONTROL_PORT_OFFSET


@pytest.mark.parametrize('kw', [
    dict(node_rank=0, node_ips=['10.0.0.1'], num_chips_per_node=8),
    dict(node_rank=1, node_ips=['10.0.0.1', '10.0.0.2'],
         num_chips_per_node=4, task_id='t-7', coordinator_port=9000),
    dict(node_rank=3, node_ips=['a', 'b', 'c', 'd'], num_chips_per_node=4,
         num_slices=2, slice_id=1),
])
def test_make_env_vars_match_reference(kw):
    assert env_contract.make_env_vars(**kw) == j_env.make_env_vars(**kw)
    for name in ('NODE_IPS', 'NUM_NODES', 'NODE_RANK', 'COORDINATOR_ADDRESS',
                 'PROCESS_ID', 'NUM_PROCESSES', 'MEGASCALE_NUM_SLICES'):
        assert getattr(env_contract, name) == getattr(j_env, name)
    with pytest.raises(ValueError, match='slices'):
        env_contract.make_env_vars(0, ['a', 'b', 'c'], 4, num_slices=2)


def test_process_grid_numbers_ranks_host_major(monkeypatch):
    monkeypatch.setenv(env_contract.NUM_PROCESSES, '3')
    monkeypatch.setenv(env_contract.PROCESS_ID, '2')
    assert env_contract.process_grid(4, 1) == (9, 12)
    assert env_contract.process_grid() == (2, 3)
    with pytest.raises(ValueError, match='local_rank'):
        env_contract.process_grid(2, 2)
    monkeypatch.setenv(env_contract.NUM_PROCESSES, '1')
    monkeypatch.setenv(env_contract.PROCESS_ID, '0')
    # One process: nothing to initialise.
    assert env_contract.initialize_from_env() == (0, 1)
    info = multihost.initialize_from_env()
    assert info['world'] == 1 and info['control_port'] == 0


def test_make_replica_mesh_rejects_partial_use():
    with pytest.raises(ValueError, match='every chip'):
        multihost.make_replica_mesh(tp=2)


def test_run_check_matches_the_single_process_baseline():
    """4 rank processes, 2 emulated hosts: the head's tokens through the
    control channel equal one process's, and every rank exits 0."""
    env = dict(os.environ)
    os.environ['OMP_NUM_THREADS'] = '1'
    try:
        base = multihost_check.baseline_decode('cpu')
        out = multihost_check.run_check(2, 2, timeout_s=300, baseline=base,
                                        device='cpu')
    finally:
        os.environ.clear()
        os.environ.update(env)
    assert out == base
    assert [len(r) for r in out] == [multihost_check.MAX_NEW] * 2


def test_run_check_needs_a_device_without_a_card():
    """The check's entry points run on the card unless asked for the
    CPU: without a card they raise before any rank is spawned."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    for call in (multihost_check.baseline_decode, multihost_check.run_check,
                 lambda: multihost_check.main([])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()


def test_launch_local_ranks_collects_every_exit_code():
    """One failed rank fails the launch, named with its exit code."""
    import _torch_ranks
    with pytest.raises(RuntimeError, match=r'\[\(1, 3\)\]'):
        multihost.launch_local_ranks(2, _torch_ranks.exit_on_rank_one,
                                     timeout_s=120)
