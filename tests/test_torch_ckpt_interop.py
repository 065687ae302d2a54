"""The on-disk contract across the two packages, on the CPU: a checkpoint
written by the JAX package (skypilot_tpu.ckpt, the JAX Trainer on the
8-device CPU mesh) restores bitwise in the port (skypilot_tpu_torch.ckpt,
its Trainer), and the reverse; the same state gives the same manifest
entries and byte-identical shard files; sharded writes of 2 simulated
processes restore whole and resharded either way, and 4 processes in
even_row_shard's layout write byte-identical files in both packages;
resume_envs agree; and
the port's train_fit steplog record has the JAX record's keys.

Cases: LLAMA_DEBUG with (f32 params, mu f32), (bf16 params, mu bf16),
(f32 params, mu bf16).  Tolerances: restores are bitwise.  One step
after a restore in both packages: loss and grad_norm at rtol 1e-5 in f32
(summation order only, the bound of test_trainer_trajectory_matches_jax_
trainer), and at rtol 2^-6 (two bf16 ulps) with bf16 params, whose
forward rounds every product to bf16 in each package's own order.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from skypilot_tpu import ckpt as j_ckpt  # noqa: E402
from skypilot_tpu.ckpt import format as j_format  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.parallel import MeshConfig, make_mesh  # noqa: E402
from skypilot_tpu.parallel import sharding as j_sharding  # noqa: E402
from skypilot_tpu.train import trainer as j_trainer  # noqa: E402
from skypilot_tpu_torch import ckpt as t_ckpt  # noqa: E402
from skypilot_tpu_torch.ckpt import format as t_format  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.train import trainer  # noqa: E402

CASES = [('float32', None), ('bfloat16', None), ('float32', 'bfloat16')]
BATCH, SEQ = 8, 32
ENTRY_KEYS = ('index', 'key', 'file', 'sha256', 'dtype', 'shape',
              'global_shape', 'slice', 'bytes', 'process')


def _bits(leaf):
    """(dtype name, shape, raw bytes) of a JAX array, numpy array or
    tensor: bf16 compares as its bits in both packages."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).split('.')[1]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, tuple(t.shape), t.numpy().tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), tuple(arr.shape), arr.tobytes()


def _assert_states_equal(j_tree, t_tree):
    j_named, _ = j_format.flatten_with_keys(j_tree)
    t_named, _ = t_format.flatten_with_keys(t_tree)
    assert [k for k, _ in j_named] == [k for k, _ in t_named]
    for (key, j), (_, t) in zip(j_named, t_named):
        assert _bits(j) == _bits(t), key


def _to_torch(x) -> torch.Tensor:
    """A JAX or numpy leaf as a tensor, bit for bit (bf16 through its
    int16 view, not through a float conversion)."""
    arr = np.asarray(x)
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _configs(param_dtype):
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG,
                               dtype=jnp.dtype(param_dtype))
    tcfg = dataclasses.replace(llama.LLAMA_DEBUG,
                               dtype=getattr(torch, param_dtype))
    return jcfg, tcfg


def _host_params(jcfg, seed):
    """JAX init_params as host numpy arrays: the JAX Trainer donates the
    buffers it is given, and each case builds several trainers."""
    return jax.tree.map(np.asarray,
                        j_llama.init_params(jcfg, jax.random.PRNGKey(seed)))


def _j_trainer(jcfg, mu_dtype, params):
    return j_trainer.Trainer(
        lambda p, b: j_llama.loss_fn(p, b, jcfg), params,
        make_mesh(MeshConfig(dp=jax.device_count())),
        j_sharding.LLAMA_RULES,
        j_trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                              total_steps=4, mu_dtype=mu_dtype))


def _t_trainer(tcfg, mu_dtype, j_params):
    """The port's trainer from the JAX trainer's (initial) params."""
    params = jax.tree.map(_to_torch, j_params)
    return trainer.Trainer(
        lambda p, b: llama.loss_fn(p, b, tcfg), params,
        trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                            total_steps=4, mu_dtype=mu_dtype),
        device='cpu')


def _copy_jax_state_into(tr, j_tr):
    """Set the port trainer's state to the JAX trainer's, bit for bit,
    without going through a checkpoint."""
    adam = j_tr.opt_state[1][0]
    with torch.no_grad():
        for dst, src in zip(tr._leaves, jax.tree.leaves(j_tr.params)):
            dst.copy_(_to_torch(src))
    tr.opt_state['mu'] = [_to_torch(x) for x in jax.tree.leaves(adam.mu)]
    tr.opt_state['nu'] = [_to_torch(x) for x in jax.tree.leaves(adam.nu)]
    tr.opt_state['count'] = int(adam.count)
    tr.step = j_tr.step


@pytest.fixture(scope='module', params=CASES,
                ids=[f'{p}-mu_{m}' for p, m in CASES])
def case(request):
    param_dtype, mu_dtype = request.param
    jcfg, tcfg = _configs(param_dtype)
    init = _host_params(jcfg, 0)
    j_tr = _j_trainer(jcfg, mu_dtype, init)
    batches = list(zip(range(3), j_trainer.synthetic_batches(
        BATCH, SEQ, jcfg.vocab_size)))
    for _, batch in batches[:2]:
        j_tr.run_step(batch)
    return dict(param_dtype=param_dtype, mu_dtype=mu_dtype, jcfg=jcfg,
                tcfg=tcfg, init=init, j_tr=j_tr,
                batches=[b for _, b in batches])


def test_same_state_gives_the_same_files(case, tmp_path):
    """The JAX trainer's state after 2 steps, saved by each package:
    equal manifest entries and byte-identical shard files (manifest.json
    itself differs in its metadata's time)."""
    j_tr = case['j_tr']
    tr = _t_trainer(case['tcfg'], case['mu_dtype'], case['init'])
    _copy_jax_state_into(tr, j_tr)
    _assert_states_equal(j_tr._state_dict(), tr._state_dict())
    j_format.save_pytree(str(tmp_path / 'jax'), 2, j_tr._state_dict())
    t_format.save_pytree(str(tmp_path / 'torch'), 2, tr._state_dict())
    j_entries = j_format.load_manifest(str(tmp_path / 'jax'), 2)['entries']
    t_entries = t_format.load_manifest(str(tmp_path / 'torch'),
                                       2)['entries']
    assert len(j_entries) == len(t_entries) == 38
    for j, t in zip(j_entries, t_entries):
        assert {k: j[k] for k in ENTRY_KEYS} == {k: t[k] for k in ENTRY_KEYS}
        assert (tmp_path / 'jax' / 'step_2' / j['file']).read_bytes() == \
            (tmp_path / 'torch' / 'step_2' / t['file']).read_bytes()
    dtypes = {e['key'].split('.')[-1].split('[')[0]: e['dtype']
              for e in t_entries}
    assert dtypes['mu'] == (case['mu_dtype'] or case['param_dtype'])


def test_port_checkpoint_restores_bitwise_into_jax(case, tmp_path):
    """The reverse: the port trains 2 steps from the same initial params
    and saves; a fresh JAX Trainer restores it bitwise."""
    tr = _t_trainer(case['tcfg'], case['mu_dtype'], case['init'])
    batches = trainer.synthetic_batches(BATCH, SEQ,
                                        case['tcfg'].vocab_size)
    for _ in range(2):
        tr.run_step(next(batches))
    tr.save_checkpoint(str(tmp_path))
    tr.close()
    j_tr = _j_trainer(case['jcfg'], case['mu_dtype'], _host_params(
        case['jcfg'], 7))
    assert j_tr.restore_latest(str(tmp_path)) == 2
    assert int(j_tr.opt_state[1][0].count) == \
        int(j_tr.opt_state[1][2].count) == 2
    _assert_states_equal(j_tr._state_dict(), tr._state_dict())
    j_tr.close()


def _write_two_processes(fmt, root, tree):
    for p in range(2):
        if fmt is j_format:
            fmt.write_process_shards(str(root), 3, tree, process_index=p,
                                     process_count=2,
                                     shard_spec=fmt.even_row_shard)
        else:
            fmt.write_process_shards(str(root), 3,
                                     t_format.even_row_windows(tree, p, 2),
                                     process_index=p, process_count=2)
    fmt.commit(str(root), 3, process_count=2)


def _resharded(fmt, root, template):
    if fmt is j_format:
        return [fmt.restore_pytree_resharded(
            str(root), 3, template, shard_spec=fmt.even_row_shard,
            process_index=q, process_count=2) for q in range(2)]
    return [fmt.restore_pytree_resharded(
        str(root), 3, t_format.even_row_windows(template, q, 2))
        for q in range(2)]


def test_sharded_writes_cross_the_packages(case, tmp_path):
    """JAX writes the state as 2 processes (axis 0 split by
    even_row_shard); the port restores it whole and as 2 readers'
    windows.  Then the port writes, and JAX reads it both ways."""
    j_tr = case['j_tr']
    tr = _t_trainer(case['tcfg'], case['mu_dtype'], case['init'])
    _copy_jax_state_into(tr, j_tr)
    j_state, t_state = j_tr._state_dict(), tr._state_dict()
    for writer, reader, template, root in (
            (j_format, t_format, t_state, tmp_path / 'jax'),
            (t_format, j_format, j_state, tmp_path / 'torch')):
        _write_two_processes(writer, root, j_state if writer is j_format
                             else t_state)
        whole = reader.restore_pytree(str(root), 3, template)
        _assert_states_equal(j_state, whole)
        named, _ = reader.flatten_with_keys(template)
        windows = [reader.flatten_with_keys(p)[0]
                   for p in _resharded(reader, root, template)]
        for i, (key, leaf) in enumerate(named):
            parts = [w[i][1] for w in windows]
            rows = leaf.shape[0] if leaf.ndim else 0
            if rows >= 2 and rows % 2 == 0:
                joined = (torch.cat(parts) if reader is t_format
                          else np.concatenate([np.asarray(x)
                                               for x in parts]))
                assert _bits(joined) == _bits(leaf), key
            else:
                assert all(_bits(x) == _bits(leaf) for x in parts), key


def test_resume_envs_agree(case, tmp_path):
    j_tr = case['j_tr']
    j_format.save_pytree(str(tmp_path), 1, j_tr._state_dict())
    _write_two_processes(j_format, tmp_path, j_tr._state_dict())
    j_format.save_pytree(str(tmp_path), 5, j_tr._state_dict())
    os.remove(tmp_path / 'step_5' / j_format.MARKER)
    want = j_ckpt.resume_envs(str(tmp_path))
    assert want['SKYTPU_RESUME_STEP'] == '3'
    assert t_ckpt.resume_envs(str(tmp_path)) == want
    for root in ('', 'gs://bucket/x', str(tmp_path / 'empty')):
        assert t_ckpt.resume_envs(root) == j_ckpt.resume_envs(root) == {}


@pytest.mark.parametrize('reader', ['jax', 'torch'])
def test_even_row_shard_four_processes_cross_the_packages(case, reader,
                                                          tmp_path):
    """The same state written by 4 simulated processes in even_row_shard's
    layout, by the JAX package (shard_spec=even_row_shard) and by the
    port (its own even_row_shard, as even_row_windows' Shard leaves):
    byte-identical shard files and per-process manifests, the same
    merged entries; then `reader` restores the other package's
    checkpoint through restore_pytree_resharded, whole and as the 4
    processes' windows, bitwise."""
    j_tr = case['j_tr']
    tr = _t_trainer(case['tcfg'], case['mu_dtype'], case['init'])
    _copy_jax_state_into(tr, j_tr)
    j_state, t_state = j_tr._state_dict(), tr._state_dict()
    n = 4
    for key, leaf in t_format.flatten_with_keys(t_state)[0]:
        shape = tuple(np.shape(leaf))
        for p in range(n):
            assert t_format.even_row_shard(key, shape, p, n) == \
                j_format.even_row_shard(key, shape, p, n), key
    roots = {'jax': tmp_path / 'jax', 'torch': tmp_path / 'torch'}
    for p in range(n):
        j_format.write_process_shards(str(roots['jax']), 5, j_state,
                                      process_index=p, process_count=n,
                                      shard_spec=j_format.even_row_shard)
        t_format.write_process_shards(
            str(roots['torch']), 5, t_format.even_row_windows(t_state, p, n),
            process_index=p, process_count=n)
    j_format.commit(str(roots['jax']), 5, process_count=n)
    t_format.commit(str(roots['torch']), 5, process_count=n)
    j_dir, t_dir = roots['jax'] / 'step_5', roots['torch'] / 'step_5'
    names = sorted(f.name for f in j_dir.iterdir()
                   if f.name != j_format.MANIFEST)
    assert names == sorted(f.name for f in t_dir.iterdir()
                           if f.name != t_format.MANIFEST)
    assert sum(name.startswith('manifest-p') for name in names) == n
    for name in names:
        assert (j_dir / name).read_bytes() == (t_dir / name).read_bytes(), \
            name
    j_entries = j_format.load_manifest(str(roots['jax']), 5)['entries']
    t_entries = t_format.load_manifest(str(roots['torch']), 5)['entries']
    assert [{k: e[k] for k in ENTRY_KEYS} for e in j_entries] == \
        [{k: e[k] for k in ENTRY_KEYS} for e in t_entries]
    if reader == 'jax':
        root, fmt, template, want = roots['torch'], j_format, j_state, j_state
        whole = fmt.restore_pytree_resharded(str(root), 5, template)
        windows = [fmt.restore_pytree_resharded(
            str(root), 5, template, shard_spec=fmt.even_row_shard,
            process_index=q, process_count=n) for q in range(n)]
    else:
        root, fmt, template, want = roots['jax'], t_format, t_state, j_state
        whole = fmt.restore_pytree_resharded(str(root), 5, template)
        windows = [fmt.restore_pytree_resharded(
            str(root), 5, t_format.even_row_windows(template, q, n))
            for q in range(n)]
    _assert_states_equal(want, whole)
    named = fmt.flatten_with_keys(template)[0]
    flat = [fmt.flatten_with_keys(w)[0] for w in windows]
    for i, (key, leaf) in enumerate(named):
        parts = [w[i][1] for w in flat]
        rows = leaf.shape[0] if leaf.ndim else 0
        if rows >= n and rows % n == 0:
            joined = (torch.cat(parts) if fmt is t_format
                      else np.concatenate([np.asarray(x) for x in parts]))
            assert _bits(joined) == _bits(leaf), key
        else:
            assert all(_bits(x) == _bits(leaf) for x in parts), key
    tr.close()


def test_train_fit_steplog_record_has_the_jax_keys(tmp_path, monkeypatch):
    jcfg, tcfg = _configs('float32')
    init = _host_params(jcfg, 0)
    records = {}
    for name, make in (('jax', lambda: _j_trainer(jcfg, None, init)),
                       ('torch', lambda: _t_trainer(tcfg, None, init))):
        path = tmp_path / f'{name}.jsonl'
        monkeypatch.setenv('SKYTPU_STEP_TELEMETRY_FILE', str(path))
        make().fit(j_trainer.synthetic_batches(BATCH, SEQ, jcfg.vocab_size),
                   2, log_every=0, tokens_per_batch=BATCH * SEQ,
                   flops_per_token=6 * jcfg.num_params())
        records[name] = json.loads(path.read_text().splitlines()[-1])
    assert records['torch']['kind'] == 'train_fit'
    assert records['torch']['step'] == 2
    assert set(records['torch']) == set(records['jax'])


def test_jax_checkpoint_restores_bitwise_into_the_port(case, tmp_path):
    """JAX trains 2 steps and saves; the port's Trainer (other weights)
    restores the latest step bitwise, with step == count == 2; one more
    step on the same batch agrees in loss and grad_norm.  Last of the
    case's tests: it steps the shared JAX trainer."""
    j_tr = case['j_tr']
    j_tr.save_checkpoint(str(tmp_path))
    j_tr.close()
    tr = _t_trainer(case['tcfg'], case['mu_dtype'], _host_params(
        case['jcfg'], 7))
    assert tr.restore_latest(str(tmp_path)) == 2
    assert tr.step == tr.opt_state['count'] == 2
    _assert_states_equal(j_tr._state_dict(), tr._state_dict())
    rtol = 1e-5 if case['param_dtype'] == 'float32' else 2 ** -6
    batch = case['batches'][2]
    want = j_tr.run_step(batch)
    got = tr.run_step(batch)
    for key in ('loss', 'grad_norm'):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=rtol)
    tr.close()
