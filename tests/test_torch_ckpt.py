"""The port's checkpoint subsystem (skypilot_tpu_torch/ckpt/) on its own,
on the CPU: format atomicity under injected crashes (through the port's
own stage hook), hash-verified restore, the async writer, retention,
multihost merge (simulated, and two gloo processes), emergency saves,
the resume contract and resharded restores; and the Trainer's checkpoint
surface: saves that hold the step they were asked for, restores in
place, bitwise resume, a SIGTERM inside the optimizer's leaf loop, and
the train_llama entry point.  Ports of tests/test_ckpt.py.

Equality here is bitwise: a restore gives back the bytes that were
saved, and the CPU trainer's steps are deterministic.
"""
import contextlib
import dataclasses
import hashlib
import io
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from skypilot_tpu_torch import ckpt as ckpt_lib  # noqa: E402
from skypilot_tpu_torch.ckpt import format as ckpt_format  # noqa: E402
from skypilot_tpu_torch.ckpt import manager as ckpt_manager  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.telemetry import metrics  # noqa: E402
from skypilot_tpu_torch.telemetry import profiler  # noqa: E402
from skypilot_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from skypilot_tpu_torch.utils import env_contract  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

PRE_COMMIT_STAGES = ('shard_written', 'process_manifest', 'pre_commit')
RESHARD_STAGES = ('reshard_planned', 'reshard_shard_read',
                  'reshard_leaf_assembled', 'reshard_restored')


# ---- chaos helpers on the port's stage hook -----------------------------

class SimulatedCrash(Exception):
    pass


class CrashAtStage:
    def __init__(self, stage, nth=1):
        self.stage, self.nth, self.fires = stage, nth, 0

    def __call__(self, stage, path):
        if stage == self.stage:
            self.fires += 1
            if self.fires == self.nth:
                raise SimulatedCrash(f'killed at {stage}: {path}')


class BlockAtStage:
    def __init__(self, stage, timeout=30.0):
        self.stage, self.timeout = stage, timeout
        self.entered, self.release = threading.Event(), threading.Event()
        self._fired = False

    def __call__(self, stage, path):
        if stage != self.stage or self._fired:
            return
        self._fired = True
        self.entered.set()
        if not self.release.wait(self.timeout):
            raise TimeoutError(f'BlockAtStage never released at {stage}')


@contextlib.contextmanager
def stage_hook(hook):
    prev = ckpt_format.set_stage_hook(hook)
    try:
        yield hook
    finally:
        ckpt_format.set_stage_hook(prev)


def flip_bit(path):
    with open(path, 'r+b') as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x01]))


def first_shard(step_path):
    return os.path.join(step_path, sorted(
        n for n in os.listdir(step_path) if n.startswith('arr_'))[0])


def _counter(name, **labels):
    return metrics.REGISTRY.get_sample_value(name, labels or {}) or 0.0


# ---- trees --------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        'params': {'w': rng.normal(size=(4, 8)).astype(np.float32),
                   'b': np.arange(8, dtype=np.float32) + seed},
        'opt_state': {'mu': rng.normal(size=(4, 8)).astype(np.float32),
                      'count': np.asarray(seed, dtype=np.int32)},
    }


def _bits(leaf):
    """(dtype name, shape, raw bytes) of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).split('.')[1]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, tuple(t.shape), t.numpy().tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), arr.shape, arr.tobytes()


def _assert_tree_equal(a, b):
    la, _ = ckpt_format.flatten_with_keys(a)
    lb, _ = ckpt_format.flatten_with_keys(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        assert _bits(x) == _bits(y), key


def _manager(root, **kwargs):
    kwargs.setdefault('process_index', 0)
    kwargs.setdefault('process_count', 1)
    return ckpt_lib.CheckpointManager(str(root), **kwargs)


# ---- format: roundtrip + atomicity --------------------------------------

_DTYPE_TREES = {
    'float32': lambda: {'w': torch.randn(3, 5, generator=torch.Generator(
        ).manual_seed(0)), 's': torch.tensor(0.25)},
    'bfloat16': lambda: {'w': (torch.arange(15, dtype=torch.float32) / 7
                               ).reshape(3, 5).to(torch.bfloat16),
                         's': torch.tensor(-1.5, dtype=torch.bfloat16)},
    'int32': lambda: {'w': torch.arange(-7, 8, dtype=torch.int32
                                        ).reshape(3, 5),
                      's': torch.tensor(2 ** 31 - 1, dtype=torch.int32)},
}


@pytest.mark.parametrize('dtype', sorted(_DTYPE_TREES))
def test_format_roundtrip(tmp_path, dtype):
    """Tensors round-trip bitwise in f32, bf16 (no numpy dtype: held as
    its bits) and int32; restore gives CPU tensors of the saved dtype,
    and the manifest names the dtype as the JAX package does."""
    tree = _DTYPE_TREES[dtype]()
    committed = ckpt_format.save_pytree(str(tmp_path), 3, tree)
    assert committed == str(tmp_path / 'step_3')
    assert os.path.exists(os.path.join(committed, ckpt_format.MARKER))
    template = {k: torch.zeros_like(v) for k, v in tree.items()}
    restored = ckpt_format.restore_pytree(str(tmp_path), 3, template)
    _assert_tree_equal(tree, restored)
    assert all(t.device.type == 'cpu' and t.dtype == tree[k].dtype
               for k, t in restored.items())
    manifest = ckpt_format.load_manifest(str(tmp_path), 3)
    assert {e['dtype'] for e in manifest['entries']} == {dtype}
    assert ckpt_format.latest_step(str(tmp_path)) == 3


def test_bfloat16_shard_header_is_ml_dtypes_one(tmp_path):
    """A bf16 shard is what numpy writes for an ml_dtypes.bfloat16 array:
    a '<V2' description over the raw bits (numpy's own V2 says '|V2')."""
    x = torch.tensor([[1.0, -2.0], [0.5, 3.0]], dtype=torch.bfloat16)
    ckpt_format.save_pytree(str(tmp_path), 1, {'x': x})
    data = (tmp_path / 'step_1' / 'arr_00000.npy').read_bytes()
    assert b"{'descr': '<V2', 'fortran_order': False, 'shape': (2, 2), }" \
        in data
    assert data.endswith(x.view(torch.int16).numpy().tobytes())
    assert len(data) % 64 == 8   # header padded as numpy pads it


@pytest.mark.parametrize('layout', ['c', 'fortran', 'strided', 'scalar'])
def test_shard_file_is_what_np_save_writes(tmp_path, layout):
    """The hand-written header and the array's own memory make the file
    np.save makes, whatever the leaf's memory order."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6) - 7.5
    leaf = {'c': x, 'fortran': np.asfortranarray(x), 'strided': x[:, ::2],
            'scalar': np.asarray(3, np.int32)}[layout]
    ckpt_format.save_pytree(str(tmp_path), 1, {'x': leaf})
    buf = io.BytesIO()
    np.save(buf, leaf, allow_pickle=False)
    data = (tmp_path / 'step_1' / 'arr_00000.npy').read_bytes()
    assert data == buf.getvalue()
    restored = ckpt_format.restore_pytree(str(tmp_path), 1, {'x': 0})
    assert _bits(restored['x']) == _bits(leaf)


def test_flatten_renders_jax_keystr():
    """Dict keys sorted and repr'd, sequence indices, namedtuple fields,
    None an empty subtree: jax.tree_util.keystr's strings."""
    state = trainer_mod.ScaleByAdamState(count=1, mu={'b': 2, 'a': 3},
                                         nu=[4, None, (5,)])
    tree = {'z': (trainer_mod.EmptyState(), state), 'a': 0}
    named, treedef = ckpt_format.flatten_with_keys(tree)
    assert [k for k, _ in named] == [
        "['a']", "['z'][1].count", "['z'][1].mu['a']", "['z'][1].mu['b']",
        "['z'][1].nu[0]", "['z'][1].nu[2][0]"]
    assert [v for _, v in named] == [0, 1, 3, 2, 4, 5]
    assert ckpt_format.tree_unflatten(treedef, [v for _, v in named]) == tree


@pytest.mark.parametrize('stage', PRE_COMMIT_STAGES)
def test_crash_before_commit_is_invisible(tmp_path, stage):
    """A save killed at ANY pre-rename point leaves latest_step on the
    previous committed checkpoint, and the retried save succeeds."""
    ckpt_format.save_pytree(str(tmp_path), 1, _tree(1))
    with stage_hook(CrashAtStage(stage)):
        with pytest.raises(SimulatedCrash):
            ckpt_format.save_pytree(str(tmp_path), 2, _tree(2))
    committed, corrupt = ckpt_format.scan_steps(str(tmp_path))
    assert [info.step for info in committed] == [1]
    assert corrupt == []
    ckpt_format.save_pytree(str(tmp_path), 2, _tree(2))
    assert ckpt_format.latest_step(str(tmp_path)) == 2
    assert not os.path.exists(ckpt_format.tmp_dir(str(tmp_path), 2))


def test_crash_after_rename_is_durable(tmp_path):
    with stage_hook(CrashAtStage('committed')):
        with pytest.raises(SimulatedCrash):
            ckpt_format.save_pytree(str(tmp_path), 7, _tree(7))
    assert ckpt_format.latest_step(str(tmp_path)) == 7
    _assert_tree_equal(_tree(7), ckpt_format.restore_pytree(
        str(tmp_path), 7, _tree(0)))


def test_torn_commit_skipped_and_counted(tmp_path):
    ckpt_format.save_pytree(str(tmp_path), 1, _tree(1))
    ckpt_format.save_pytree(str(tmp_path), 2, _tree(2))
    os.remove(str(tmp_path / 'step_2' / ckpt_format.MARKER))
    before = _counter('skytpu_ckpt_corrupt_skips_total')
    assert _manager(tmp_path).latest_step() == 1
    assert _counter('skytpu_ckpt_corrupt_skips_total') == before + 1


@pytest.mark.parametrize('damage', ['bit_flip', 'manifest'])
def test_corrupt_step_is_walked_past(tmp_path, damage):
    """A flipped bit in a shard fails SHA-256 verification; a garbage
    manifest fails to parse.  restore_latest lands on the previous
    committed step and counts the skip."""
    ckpt_format.save_pytree(str(tmp_path), 1, _tree(1))
    ckpt_format.save_pytree(str(tmp_path), 2, _tree(2))
    if damage == 'bit_flip':
        flip_bit(first_shard(str(tmp_path / 'step_2')))
    else:
        (tmp_path / 'step_2' / ckpt_format.MANIFEST).write_text('{not json')
    with pytest.raises(ckpt_format.CorruptCheckpointError):
        ckpt_format.restore_pytree(str(tmp_path), 2, _tree(0))
    before = _counter('skytpu_ckpt_corrupt_skips_total')
    step, restored = _manager(tmp_path).restore_latest(_tree(0))
    assert step == 1
    _assert_tree_equal(_tree(1), restored)
    assert _counter('skytpu_ckpt_corrupt_skips_total') == before + 1


def test_legacy_orbax_dir_raises_and_is_walked_past(tmp_path):
    """A step dir with neither manifest nor marker is a legacy Orbax
    checkpoint: discovered as committed (as the JAX package does),
    refused by restore with a clear error, walked past by
    restore_latest."""
    ckpt_format.save_pytree(str(tmp_path), 1, _tree(1))
    (tmp_path / 'step_5').mkdir()
    (tmp_path / 'step_5' / 'payload').write_text('legacy orbax checkpoint')
    manager = _manager(tmp_path)
    assert manager.latest_step() == 5
    assert manager.writer_topology(5) is None
    with pytest.raises(ckpt_manager.LegacyCheckpointError, match='Orbax'):
        manager.restore(5, _tree(0))
    step, restored = manager.restore_latest(_tree(0))
    assert step == 1
    _assert_tree_equal(_tree(1), restored)
    manager.close()


# ---- manager: async pipeline --------------------------------------------

def test_async_save_overlaps_caller(tmp_path):
    manager = _manager(tmp_path)
    block = BlockAtStage('shard_written')
    with stage_hook(block):
        manager.save(1, _tree(1), blocking=False)
        assert block.entered.wait(10)
        assert manager._writer.in_flight == 1
        assert ckpt_format.latest_step(str(tmp_path)) is None
        assert _counter('skytpu_ckpt_async_queue_depth') >= 1
        block.release.set()
        manager.wait_until_finished()
    assert manager._writer.in_flight == 0
    assert ckpt_format.latest_step(str(tmp_path)) == 1
    assert _counter('skytpu_ckpt_async_queue_depth') == 0
    manager.close()


def test_async_writer_killed_mid_save(tmp_path):
    manager = _manager(tmp_path)
    manager.save(1, _tree(1), blocking=True)
    with stage_hook(CrashAtStage('shard_written')):
        manager.save(2, _tree(2), blocking=False)
        with pytest.raises(SimulatedCrash):
            manager.wait_until_finished()
    step, restored = manager.restore_latest(_tree(0))
    assert step == 1
    _assert_tree_equal(_tree(1), restored)
    manager.close()


def test_async_save_error_does_not_poison_writer(tmp_path):
    manager = _manager(tmp_path)
    with stage_hook(CrashAtStage('pre_commit')):
        manager.save(1, _tree(1), blocking=False)
        with pytest.raises(SimulatedCrash):
            manager.wait_until_finished()
    manager.save(2, _tree(2), blocking=False)
    manager.wait_until_finished()
    assert manager.latest_step() == 2
    manager.close()


def test_persistent_writer_failure_fails_next_save(tmp_path):
    manager = _manager(tmp_path, max_consecutive_failures=3)
    for step in (1, 2, 3):
        with stage_hook(CrashAtStage('shard_written')):
            manager.save(step, _tree(step), blocking=False)
            with pytest.raises(SimulatedCrash):
                manager.wait_until_finished()
    assert manager._last_saved_step is None
    with pytest.raises(RuntimeError, match='consecutive'):
        manager.save(4, _tree(4), blocking=False)
    manager.save(5, _tree(5), blocking=True)
    manager.save(6, _tree(6), blocking=False)
    manager.wait_until_finished()
    assert manager.all_steps() == [5, 6]
    manager.close()


def test_should_save_interval_gate(tmp_path):
    manager = _manager(tmp_path, save_interval_steps=5)
    assert [s for s in range(1, 16) if manager.should_save(s)] == [5, 10, 15]
    manager.save(5, _tree(5), blocking=True)
    assert not manager.should_save(5)
    assert _manager(tmp_path).should_save(0) is False
    manager.close()


# ---- retention ----------------------------------------------------------

def test_retention_gc(tmp_path):
    before = _counter('skytpu_ckpt_gc_deleted_total')
    manager = _manager(tmp_path, keep_last=2, keep_every=10)
    for step in (5, 10, 15, 20, 25):
        manager.save(step, _tree(step), blocking=True)
    assert manager.all_steps() == [10, 20, 25]
    assert _counter('skytpu_ckpt_gc_deleted_total') == before + 2
    manager.close()


def test_gc_preserves_legacy_orbax_dirs(tmp_path):
    legacy = tmp_path / 'step_2'
    legacy.mkdir()
    (legacy / 'payload').write_text('legacy orbax checkpoint')
    manager = _manager(tmp_path, keep_last=1)
    for step in (5, 6, 7):
        manager.save(step, _tree(step), blocking=True)
    assert manager.all_steps() == [2, 7]
    manager.close()


def test_gc_only_on_process_zero(tmp_path):
    ckpt_format.save_pytree(str(tmp_path), 1, _tree(1))
    ckpt_format.save_pytree(str(tmp_path), 2, _tree(2))
    manager = _manager(tmp_path, keep_last=1, process_index=1,
                       process_count=2)
    manager._gc()
    assert manager.all_steps() == [1, 2]
    manager.close()


# ---- multihost ----------------------------------------------------------

def test_multihost_merge(tmp_path):
    tree = _tree(3)
    tags = []

    def _barrier(tag):
        tags.append(tag)
        if 'write' in tag:
            ckpt_format.write_process_shards(str(tmp_path), 1, tree,
                                             process_index=1,
                                             process_count=2)

    manager = _manager(tmp_path, process_index=0, process_count=2,
                       barrier=_barrier)
    manager.save(1, tree, blocking=True)
    assert tags == ['skytpu_ckpt_clean_step1', 'skytpu_ckpt_write_step1']
    manifest = ckpt_format.load_manifest(str(tmp_path), 1)
    assert manifest['process_count'] == 2
    assert {e['index'] % 2 for e in manifest['entries']} == {0, 1}
    _assert_tree_equal(tree, ckpt_format.restore_pytree(str(tmp_path), 1,
                                                        _tree(0)))
    manager.close()


def test_multihost_default_barrier_wired(tmp_path):
    multi = _manager(tmp_path, process_index=0, process_count=2)
    single = _manager(tmp_path)
    assert multi._barrier is ckpt_manager._multihost_barrier
    assert single._barrier is None
    assert ckpt_lib.CheckpointManager(str(tmp_path)).process_count == 1
    with pytest.raises(ValueError, match='barrier'):
        ckpt_format.save_pytree(str(tmp_path), 1, _tree(1),
                                process_index=0, process_count=2)
    multi.close()
    single.close()


def _gloo_worker(rank, world, port, root, queue):
    import torch.distributed as dist
    try:
        dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                                world_size=world, rank=rank)
        manager = ckpt_lib.CheckpointManager(root)   # grid and barrier
        manager.save(4, _tree(4), blocking=True)      # from the group
        dist.barrier()
        queue.put((rank, manager.process_index, manager.process_count,
                   manager.latest_step()))
        manager.close()
        dist.destroy_process_group()
    except BaseException as e:  # reported to the parent, which fails
        queue.put((rank, repr(e)))


def test_two_gloo_processes_merge_through_the_default_barrier(tmp_path):
    """Two torch.distributed processes: each manager takes its grid from
    the process group and torch.distributed.barrier as its rendezvous;
    both write their round-robin leaves, process 0 commits."""
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context('spawn')
    queue = ctx.Queue()
    procs = [ctx.Process(target=_gloo_worker,
                         args=(r, 2, port, str(tmp_path), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    results = sorted(queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    assert results == [(0, 0, 2, 4), (1, 1, 2, 4)]
    manifest = ckpt_format.load_manifest(str(tmp_path), 4)
    assert manifest['process_count'] == 2
    assert {e['process'] for e in manifest['entries']} == {0, 1}
    _assert_tree_equal(_tree(4), ckpt_format.restore_pytree(
        str(tmp_path), 4, _tree(0)))


def test_peer_shards_survive_staging_reuse(tmp_path):
    tree = _tree(5)
    ckpt_format.write_process_shards(str(tmp_path), 1, tree,
                                     process_index=1, process_count=2)
    staging = ckpt_format.tmp_dir(str(tmp_path), 1)
    peer_files = set(os.listdir(staging))
    assert peer_files
    ckpt_format.write_process_shards(str(tmp_path), 1, tree,
                                     process_index=0, process_count=2)
    assert peer_files <= set(os.listdir(staging))
    ckpt_format.commit(str(tmp_path), 1, process_count=2)
    _assert_tree_equal(tree, ckpt_format.restore_pytree(str(tmp_path), 1,
                                                        _tree(0)))


def test_stale_staging_cleaned_before_writes(tmp_path):
    stale = ckpt_format.tmp_dir(str(tmp_path), 9)
    os.makedirs(stale)
    with open(os.path.join(stale, 'arr_00000.npy'), 'wb') as f:
        f.write(b'leftover from a crashed save')

    def _barrier(tag):
        if 'clean' in tag:
            assert not os.path.isdir(stale)

    ckpt_format.save_pytree(str(tmp_path), 10, _tree(10), barrier=_barrier)
    assert ckpt_format.latest_step(str(tmp_path)) == 10


def test_multihost_commit_refuses_missing_process(tmp_path):
    ckpt_format.write_process_shards(str(tmp_path), 1, _tree(1),
                                     process_index=0, process_count=2)
    with pytest.raises(ckpt_format.CorruptCheckpointError):
        ckpt_format.commit(str(tmp_path), 1, process_count=2)
    assert ckpt_format.latest_step(str(tmp_path)) is None


def test_nonzero_process_does_not_commit(tmp_path):
    assert ckpt_format.save_pytree(str(tmp_path), 1, _tree(1),
                                   process_index=1, process_count=2,
                                   barrier=lambda tag: None) is None
    assert ckpt_format.latest_step(str(tmp_path)) is None


# ---- emergency save -----------------------------------------------------

@contextlib.contextmanager
def _chained_sigterm():
    chained = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    try:
        yield chained
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_emergency_save_on_sigterm(tmp_path):
    manager = _manager(tmp_path)
    with _chained_sigterm() as chained:
        try:
            manager.register_state_provider(lambda: (7, _tree(7)))
            assert manager.install_signal_handlers() is True
            before = _counter('skytpu_ckpt_emergency_saves_total')
            saves = _counter('skytpu_ckpt_saves_total', kind='emergency')
            os.kill(os.getpid(), signal.SIGTERM)
            assert manager.latest_step() == 7
            assert chained == [signal.SIGTERM]
            assert _counter('skytpu_ckpt_emergency_saves_total') == \
                before + 1
            assert _counter('skytpu_ckpt_saves_total',
                            kind='emergency') == saves + 1
            os.kill(os.getpid(), signal.SIGTERM)   # already committed
            assert manager.all_steps() == [7]
            assert chained == [signal.SIGTERM] * 2
        finally:
            manager.close()


def test_sigterm_during_blocking_save_does_not_deadlock(tmp_path):
    manager = _manager(tmp_path)
    fired = []

    def _kill_once(stage, path):
        if stage == 'pre_commit' and not fired:
            fired.append(stage)
            os.kill(os.getpid(), signal.SIGTERM)

    with _chained_sigterm() as chained:
        try:
            manager.register_state_provider(lambda: (99, _tree(99)))
            assert manager.install_signal_handlers() is True
            before = _counter('skytpu_ckpt_emergency_saves_total')
            with stage_hook(_kill_once):
                manager.save(7, _tree(7), blocking=True)
            assert manager.all_steps() == [7]
            assert chained == [signal.SIGTERM]
            assert _counter('skytpu_ckpt_emergency_saves_total') == before
        finally:
            manager.close()


@pytest.mark.parametrize('block_raises', [False, True])
def test_held_signal_is_handled_when_the_block_ends(tmp_path, block_raises):
    """A signal inside hold_signals() waits for the block: the save then
    sees the state the block finished writing.  A block that raises may
    have torn the state: the held signal only chains, with no save."""
    manager = _manager(tmp_path)
    state = {'step': 1}
    manager.register_state_provider(
        lambda: (state['step'], _tree(state['step'])))
    with _chained_sigterm() as chained:
        try:
            assert manager.install_signal_handlers() is True
            with contextlib.suppress(KeyError):
                with manager.hold_signals():
                    with manager.hold_signals():     # nesting holds too
                        os.kill(os.getpid(), signal.SIGTERM)
                        assert chained == [] and manager.all_steps() == []
                    assert chained == []
                    state['step'] = 2
                    if block_raises:
                        raise KeyError('torn')
            assert chained == [signal.SIGTERM]
            assert manager.all_steps() == ([] if block_raises else [2])
        finally:
            manager.close()


def test_install_signal_handlers_off_main_thread(tmp_path):
    manager = _manager(tmp_path)
    manager.register_state_provider(lambda: (1, _tree(1)))
    results = []
    thread = threading.Thread(
        target=lambda: results.append(manager.install_signal_handlers()))
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert results == [False]
    manager.close()


# ---- resume contract ----------------------------------------------------

def test_resume_envs(tmp_path):
    assert ckpt_lib.resume_envs('') == {}
    assert ckpt_lib.resume_envs('gs://bucket/ckpts') == {}
    assert ckpt_lib.resume_envs(str(tmp_path)) == {}
    for step in (1, 2, 3):
        ckpt_format.save_pytree(str(tmp_path), step, _tree(step))
    os.remove(str(tmp_path / 'step_3' / ckpt_format.MARKER))
    assert ckpt_lib.resume_envs(str(tmp_path)) == {
        'SKYTPU_RESUME_CKPT_PATH': str(tmp_path),
        'SKYTPU_RESUME_STEP': '2',
        'SKYTPU_RESUME_TOPOLOGY': '1',
    }


def test_resume_target_and_topology_parse_env(monkeypatch, tmp_path):
    for var in (env_contract.RESUME_CKPT_PATH, env_contract.RESUME_STEP,
                env_contract.RESUME_TOPOLOGY):
        monkeypatch.delenv(var, raising=False)
    assert env_contract.resume_target() is None
    assert env_contract.resume_topology() is None
    monkeypatch.setenv(env_contract.RESUME_CKPT_PATH, str(tmp_path))
    monkeypatch.setenv(env_contract.RESUME_STEP, '42')
    assert env_contract.resume_target() == (str(tmp_path), 42)
    monkeypatch.setenv(env_contract.RESUME_STEP, 'nan')
    assert env_contract.resume_target() is None
    monkeypatch.setenv(env_contract.RESUME_TOPOLOGY, '4')
    assert env_contract.resume_topology() == 4
    monkeypatch.setenv(env_contract.RESUME_TOPOLOGY, 'potato')
    assert env_contract.resume_topology() is None


# ---- elastic resume: resharded restore ----------------------------------

def _grid_tree(seed=0):
    """f32/bf16/int8 leaves whose axis 0 divides by every grid in
    {1, 2, 4}, and an un-partitionable scalar with one crc-picked
    owner."""
    g = torch.Generator().manual_seed(seed)
    return {
        'w': torch.randn(8, 6, generator=g),
        'emb': torch.randn(8, generator=g).to(torch.bfloat16),
        'q': torch.randint(-128, 127, (4, 3), generator=g,
                           dtype=torch.int8),
        'scale': torch.tensor(seed + 0.5),
    }


def _write_grid(root, step, tree, n):
    for p in range(n):
        ckpt_format.write_process_shards(
            str(root), step, tree, process_index=p, process_count=n,
            shard_spec=ckpt_format.even_row_shard)
    ckpt_format.commit(str(root), step, process_count=n)


@pytest.mark.parametrize('writers', [1, 2, 4])
@pytest.mark.parametrize('readers', [1, 2, 4])
def test_reshard_parity_any_grid_to_any_grid(tmp_path, writers, readers):
    tree = _grid_tree(writers)
    _write_grid(tmp_path, 5, tree, writers)
    _assert_tree_equal(tree, ckpt_format.restore_pytree(
        str(tmp_path), 5, _grid_tree(0)))
    parts = [ckpt_format.restore_pytree_resharded(
        str(tmp_path), 5, _grid_tree(0),
        shard_spec=ckpt_format.even_row_shard,
        process_index=q, process_count=readers) for q in range(readers)]
    for key, want in tree.items():
        windows = [p[key] for p in parts]
        if want.ndim and want.shape[0] % readers == 0 \
                and want.shape[0] >= readers:
            assert _bits(torch.cat(windows)) == _bits(want)
        else:
            for window in windows:
                assert _bits(window) == _bits(want)


def test_reshard_reads_only_overlapping_shards(tmp_path):
    _write_grid(tmp_path, 5, _grid_tree(2), 4)
    stats = {}
    ckpt_format.restore_pytree_resharded(
        str(tmp_path), 5, _grid_tree(0),
        shard_spec=ckpt_format.even_row_shard,
        process_index=0, process_count=4, stats=stats)
    assert stats['writer_process_count'] == 4
    assert stats['files_skipped'] > 0
    assert stats['files_read'] + stats['files_skipped'] >= stats['leaves']


@pytest.mark.parametrize('stage', RESHARD_STAGES)
def test_crash_at_any_reshard_stage_is_retryable(tmp_path, stage):
    tree = _grid_tree(3)
    _write_grid(tmp_path, 3, tree, 2)
    with stage_hook(CrashAtStage(stage)):
        with pytest.raises(SimulatedCrash):
            ckpt_format.restore_pytree_resharded(
                str(tmp_path), 3, _grid_tree(0),
                shard_spec=ckpt_format.even_row_shard,
                process_index=0, process_count=2)
    assert ckpt_format.latest_step(str(tmp_path)) == 3
    manager = _manager(tmp_path)
    step, restored = manager.restore_latest(_grid_tree(0))
    assert step == 3
    _assert_tree_equal(tree, restored)
    manager.close()


@pytest.mark.parametrize('damage', ['missing_shard', 'bit_flip'])
def test_walk_down_past_a_damaged_resharded_step(tmp_path, damage):
    """The newest 4-writer step lost a dead process's shard files, or
    rotted a bit: the reader refuses it (never fabricates data) and the
    manager lands on the previous committed step."""
    _write_grid(tmp_path, 1, _grid_tree(1), 4)
    _write_grid(tmp_path, 2, _grid_tree(2), 4)
    step_path = tmp_path / 'step_2'
    if damage == 'missing_shard':
        manifest = ckpt_format.load_manifest(str(tmp_path), 2)
        dropped = [e['file'] for e in manifest['entries']
                   if e['process'] == 2]
        assert dropped
        for name in dropped:
            os.remove(step_path / name)
    else:
        flip_bit(first_shard(str(step_path)))
    with pytest.raises(ckpt_format.CorruptCheckpointError):
        ckpt_format.restore_pytree(str(tmp_path), 2, _grid_tree(0))
    manager = _manager(tmp_path)
    step, restored = manager.restore_latest(_grid_tree(0))
    assert step == 1
    _assert_tree_equal(_grid_tree(1), restored)
    manager.close()


def test_v1_manifest_from_larger_grid_restores_anywhere(tmp_path):
    tree = _grid_tree(4)
    for p in range(2):
        ckpt_format.write_process_shards(str(tmp_path), 3, tree,
                                         process_index=p, process_count=2)
    ckpt_format.commit(str(tmp_path), 3, process_count=2)
    mpath = tmp_path / 'step_3' / ckpt_format.MANIFEST
    manifest = json.loads(mpath.read_text())
    manifest['version'] = 1
    for entry in manifest['entries']:
        for key in ('global_shape', 'slice', 'process'):
            entry.pop(key)
    mpath.write_text(json.dumps(manifest))
    _assert_tree_equal(tree, ckpt_format.restore_pytree(
        str(tmp_path), 3, _grid_tree(0)))
    windowed = ckpt_format.restore_pytree_resharded(
        str(tmp_path), 3, _grid_tree(0),
        shard_spec=ckpt_format.even_row_shard,
        process_index=1, process_count=2)
    assert _bits(windowed['w']) == _bits(tree['w'][4:])


def test_manager_reshard_metrics_and_routing(tmp_path):
    tree = _grid_tree(6)
    _write_grid(tmp_path, 4, tree, 2)
    shrink = _counter('skytpu_ckpt_reshard_restores_total',
                      direction='shrink')
    bytes_before = _counter('skytpu_ckpt_reshard_bytes_read_total')
    manager = _manager(tmp_path)
    assert manager.writer_topology(4) == 2
    step, restored = manager.restore_latest(_grid_tree(0))
    assert step == 4
    _assert_tree_equal(tree, restored)
    assert _counter('skytpu_ckpt_reshard_restores_total',
                    direction='shrink') == shrink + 1
    assert _counter('skytpu_ckpt_reshard_bytes_read_total') > bytes_before
    envs = ckpt_lib.resume_envs(str(tmp_path))
    assert envs[env_contract.RESUME_TOPOLOGY] == '2'
    manager.close()


# ---- the Trainer's checkpoint surface -----------------------------------

TCFG = dataclasses.replace(llama.LLAMA_DEBUG, d_model=128, d_ff=256,
                           n_heads=1, vocab_size=256)


def _trainer(seed=0, **config):
    params = llama.init_params(TCFG, torch.Generator().manual_seed(seed),
                               'cpu')
    cfg = trainer_mod.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                                  total_steps=8, **config)
    return trainer_mod.Trainer(lambda p, b: llama.loss_fn(p, b, TCFG),
                               params, cfg, device='cpu')


def _batches():
    return trainer_mod.synthetic_batches(2, 16, TCFG.vocab_size, seed=1)


def _state_bits(tr):
    named, _ = ckpt_format.flatten_with_keys(tr._state_dict())
    return tr.step, [(k, _bits(v)) for k, v in named]


def test_state_dict_has_the_jax_trainers_keys():
    """38 leaves for LLAMA_DEBUG's tree in the JAX Trainer's order:
    Adam's count, mu, nu, the schedule's count, then the params."""
    named, _ = ckpt_format.flatten_with_keys(_trainer()._state_dict())
    keys = [k for k, _ in named]
    assert len(keys) == 38
    assert keys[0] == "['opt_state'][1][0].count"
    assert keys[1] == "['opt_state'][1][0].mu['embed']"
    assert keys[13] == "['opt_state'][1][0].nu['embed']"
    assert keys[25] == "['opt_state'][1][2].count"
    assert keys[26:29] == ["['params']['embed']", "['params']['final_norm']",
                           "['params']['layers']['attn']['wk']"]
    assert keys[-1] == "['params']['lm_head']"


def test_async_save_holds_the_step_it_was_asked_for(tmp_path):
    """An async save held in flight while the next step updates the
    parameters in place commits the state at save time (a CPU tensor's
    .cpu() is itself: the snapshot must copy)."""
    tr, batches = _trainer(), _batches()
    manager = tr.enable_checkpointing(str(tmp_path), save_interval_steps=1,
                                      emergency_save=False)
    block = BlockAtStage('shard_written')
    try:
        with stage_hook(block):
            tr.run_step(next(batches))          # async save of step 1
            want = _state_bits(tr)
            assert block.entered.wait(10)
            manager.save_interval_steps = 0
            tr.run_step(next(batches))          # moves every leaf
            assert tr.step == 2
            assert ckpt_format.latest_step(str(tmp_path)) is None
            block.release.set()
            tr.wait_for_checkpoints()
        assert manager.all_steps() == [1]
        other = _trainer(seed=5)
        assert other.restore_latest(str(tmp_path)) == 1
        assert _state_bits(other) == want
    finally:
        tr.close()


def test_restore_is_in_place_and_training_moves_it(tmp_path):
    """A restore copies into the trainer's own tensors (the ones autograd
    differentiates against), so the next step moves the restored values
    and continues the saved run."""
    tr, batches = _trainer(), _batches()
    tr.run_step(next(batches))
    tr.save_checkpoint(str(tmp_path))
    other = _trainer(seed=5)
    leaves = [id(t) for t in other._leaves]
    assert other.restore_checkpoint(str(tmp_path), 1) is None
    assert [id(t) for t in other._leaves] == leaves
    assert [id(t) for t in trainer_mod.tree_leaves(other.params)] == leaves
    restored = [t.clone() for t in other._leaves]
    batch = next(batches)
    got = other.run_step(batch)
    want = tr.run_step(batch)
    assert float(got['loss']) == float(want['loss'])
    assert all(not torch.equal(a, b)
               for a, b in zip(restored, other._leaves))
    assert _state_bits(other) == _state_bits(tr)
    tr.close()
    other.close()


@pytest.mark.parametrize('mu_dtype', [None, 'bfloat16'])
def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, mu_dtype):
    """6 steps straight against 3 steps, a save, a fresh trainer that
    restores and 3 more steps on the same (advanced) batch iterator."""
    straight, batches = _trainer(mu_dtype=mu_dtype), _batches()
    for _ in range(6):
        straight.run_step(next(batches))
    first, batches = _trainer(mu_dtype=mu_dtype), _batches()
    for _ in range(3):
        first.run_step(next(batches))
    first.save_checkpoint(str(tmp_path))
    first.close()
    resumed = _trainer(seed=9, mu_dtype=mu_dtype)
    assert resumed.restore_latest(str(tmp_path)) == 3
    assert resumed.opt_state['count'] == 3
    for _ in range(3):
        resumed.run_step(next(batches))
    assert _state_bits(resumed) == _state_bits(straight)


def test_sigterm_inside_the_optimizer_commits_a_whole_step(tmp_path,
                                                           monkeypatch):
    """SIGTERM raised from inside the optimizer's leaf loop (the 20th of
    ~84 scalar roundings of step 2, in its third leaf): the emergency
    save commits the state before or after that step, under its step
    number, never a mix; then the previous handler runs."""
    tr, batches = _trainer(), _batches()
    tr.run_step(next(batches))
    before = _state_bits(tr)
    calls = []
    real = trainer_mod._in_dtype

    def kill_mid_loop(x, dtype):
        calls.append(x)
        if len(calls) == 20:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(x, dtype)

    with _chained_sigterm() as chained:
        try:
            tr.enable_checkpointing(str(tmp_path), emergency_save=True)
            monkeypatch.setattr(trainer_mod, '_in_dtype', kill_mid_loop)
            tr.run_step(next(batches))
            monkeypatch.undo()
            assert len(calls) > 40 and chained == [signal.SIGTERM]
            after = _state_bits(tr)
            steps = ckpt_format.scan_steps(str(tmp_path))[0]
            assert [info.step for info in steps] in ([1], [2])
            other = _trainer(seed=5)
            step = other.restore_latest(str(tmp_path))
            assert _state_bits(other) == (before if step == 1 else after)
        finally:
            tr.close()


def test_restore_latest_on_an_empty_dir_and_close_twice(tmp_path):
    tr = _trainer()
    tr.run_step(next(_batches()))
    want = _state_bits(tr)
    assert tr.restore_latest(str(tmp_path / 'nothing')) is None
    assert tr.restore_latest(str(tmp_path)) is None
    assert _state_bits(tr) == want
    tr.enable_checkpointing(str(tmp_path), save_interval_steps=1)
    tr.close()
    tr.close()
    assert tr._auto_ckpt is None and tr._ckpt_managers == {}


def test_restore_refuses_a_mismatched_state(tmp_path):
    """Counts that differ, or a leaf of another dtype, raise before any
    tensor of the trainer is touched."""
    tr = _trainer()
    tr.run_step(next(_batches()))
    tr.save_checkpoint(str(tmp_path))
    want = _state_bits(_trainer(seed=5))
    bf16 = _trainer(seed=5, mu_dtype='bfloat16')
    with pytest.raises(ValueError, match='float32'):
        bf16.restore_checkpoint(str(tmp_path), 1)
    mpath = tmp_path / 'step_1' / ckpt_format.MANIFEST
    manifest = json.loads(mpath.read_text())
    entry = manifest['entries'][25]          # the schedule's count
    buf = io.BytesIO()
    np.save(buf, np.asarray(7, np.int32))
    (tmp_path / 'step_1' / entry['file']).write_bytes(buf.getvalue())
    entry['sha256'] = hashlib.sha256(buf.getvalue()).hexdigest()
    mpath.write_text(json.dumps(manifest))
    other = _trainer(seed=5)
    with pytest.raises(ValueError, match='differ'):
        other.restore_checkpoint(str(tmp_path), 1)
    assert _state_bits(other) == want
    tr.close()


def test_fit_updates_the_train_metrics_and_profile_window(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv(profiler.ENV_VAR, str(tmp_path))
    steps = _counter('skytpu_train_steps_total')
    warm = _counter('skytpu_train_step_duration_seconds_count',
                    phase='warmup')
    steady = _counter('skytpu_train_step_duration_seconds_count',
                      phase='steady')
    tr = _trainer()
    out = tr.fit(_batches(), 4, log_every=0, tokens_per_batch=32,
                 flops_per_token=6 * TCFG.num_params())
    assert _counter('skytpu_train_steps_total') == steps + 4
    assert _counter('skytpu_train_step_duration_seconds_count',
                    phase='warmup') == warm + 1
    assert _counter('skytpu_train_step_duration_seconds_count',
                    phase='steady') == steady + 3
    assert _counter('skytpu_train_loss') == out['loss']
    assert _counter('skytpu_train_grad_norm') == out['grad_norm']
    assert _counter('skytpu_train_tokens_per_second') == \
        out['tokens_per_sec']
    assert _counter('skytpu_train_mfu_ratio') == out['mfu']
    trace = tmp_path / f'trainer_fit-pid{os.getpid()}' / 'trace.json'
    assert json.loads(trace.read_text())['traceEvents']


def _entry_point(ckpt_dir, *extra):
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.train_llama',
           '--model-size', 'debug', '--device', 'cpu', '--seq-len', '16',
           '--batch-size', '2', '--checkpoint-every', '2',
           '--checkpoint-dir', str(ckpt_dir), *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_entry_point_commits_and_resumes(tmp_path):
    """train_llama on the CPU: the first run commits steps 2 and 4; the
    relaunch with --resume auto restores step 4 (walking past a torn
    step 6 dir) and finishes at step 6."""
    first = _entry_point(tmp_path, '--steps', '4')
    assert first.returncode == 0, first.stderr
    assert 'saved step 2' in first.stdout and 'saved step 4' in first.stdout
    assert ckpt_lib.CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    (tmp_path / 'step_6').mkdir()
    (tmp_path / 'step_6' / ckpt_format.MARKER).write_text('')
    second = _entry_point(tmp_path, '--steps', '6', '--resume', 'auto')
    assert second.returncode == 0, second.stderr
    lines = second.stdout.splitlines()
    assert 'resumed from step 4' in lines
    assert 'saved step 6' in lines
    final = [line for line in lines if line.startswith('final: loss=')]
    assert final and np.isfinite(float(final[0].split()[1][5:]))
    refused = _entry_point(tmp_path, '--steps', '6', '--fsdp', '4')
    assert refused.returncode != 0 and '11(g)' in refused.stderr
