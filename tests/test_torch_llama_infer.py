"""The port's pooled forward (skypilot_tpu_torch/infer/llama_infer.py)
against the JAX package at LLAMA_DEBUG widths, on the CPU.

The JAX parameter tree crosses over through numpy (f32 leaves) and
params_from_numpy.  Tolerances:
- f32: atol 5e-5 on logits (|logit| < 4) and arena rows; the two sides
  differ only in summation order (measured ~5e-6).
- bf16: atol 0.1; XLA and PyTorch round the bf16 products of every
  matmul at other places, a few bf16 ulps at |x| < 4 after two layers
  (measured ~0.04).
The garbage block 0 is excluded from arena comparisons: duplicate pad
writes land there in an order neither framework defines.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import block_pool as j_block_pool  # noqa: E402
from skypilot_tpu.infer import llama_infer as j_infer  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu_torch.infer import block_pool  # noqa: E402
from skypilot_tpu_torch.infer import llama_infer  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402

ATOL = {'float32': 5e-5, 'bfloat16': 0.1}
BS = 16
N_BLOCKS = 9


def _models(dtype: str):
    jcfg = dataclasses.replace(j_llama.LLAMA_DEBUG, dtype=jnp.dtype(dtype))
    tcfg = dataclasses.replace(llama.LLAMA_DEBUG,
                               dtype=getattr(torch, dtype))
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jcfg, tcfg, jp, llama.params_from_numpy(tree, tcfg, 'cpu')


@pytest.fixture(scope='module', params=['float32', 'bfloat16'])
def models(request):
    return (request.param,) + _models(request.param)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, dtype):
    np.testing.assert_allclose(_np(a), _np(b), atol=ATOL[dtype], rtol=0)


def _live(arena):
    return {k: _np(v)[:, 1:] for k, v in arena.items()}


def test_params_from_numpy_round_trips(models):
    dtype, jcfg, tcfg, jp, tp = models
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert node.dtype == tcfg.dtype
        np.testing.assert_array_equal(node.float().numpy(), _np(leaf))


def _prefill_both(jcfg, tcfg, jp, tp):
    rng = np.random.RandomState(0)
    group, seq = 2, 32
    tokens = rng.randint(1, jcfg.vocab_size, size=(group, seq)).astype(
        np.int32)
    lengths = np.asarray([30, 11], np.int32)
    # Row 1's second logical block is past its prompt: garbage block.
    tables_scatter = np.asarray([[3, 7], [5, 0]], np.int32)
    j_small = j_infer.init_cache(jcfg, group, seq)
    j_logits, j_small = j_infer.prefill(jp, jnp.asarray(tokens), jcfg,
                                        j_small, jnp.asarray(lengths))
    j_arena = j_infer.scatter_prefill_pooled(
        j_small, j_block_pool.init_arena(jcfg, N_BLOCKS, BS),
        jnp.asarray(tables_scatter))
    t_small = llama_infer.init_cache(tcfg, group, seq, device='cpu')
    t_logits, _ = llama_infer.prefill(tp, torch.from_numpy(tokens), tcfg,
                                      t_small, torch.from_numpy(lengths))
    t_arena = block_pool.init_arena(tcfg, N_BLOCKS, BS, device='cpu')
    llama_infer.scatter_prefill_pooled(t_small, t_arena,
                                       torch.from_numpy(tables_scatter))
    return j_logits, j_arena, t_logits, t_arena, lengths


def test_prefill_and_scatter_match_jax(models):
    dtype, jcfg, tcfg, jp, tp = models
    j_logits, j_arena, t_logits, t_arena, _ = _prefill_both(jcfg, tcfg,
                                                             jp, tp)
    assert t_logits.dtype == torch.float32
    assert t_logits.shape == (2, tcfg.vocab_size)
    _close(t_logits, j_logits, dtype)
    for key in ('k', 'v'):
        _close(_live(t_arena)[key], _live(j_arena)[key], dtype)


def test_decode_steps_match_jax(models):
    """Four pooled decode steps, feeding both sides JAX's greedy token:
    logits and the arena agree after every step."""
    dtype, jcfg, tcfg, jp, tp = models
    j_logits, j_arena, _, t_arena, lengths = _prefill_both(jcfg, tcfg,
                                                           jp, tp)
    # Each slot's table grows by one block past its prompt.
    tables = np.asarray([[3, 7, 2, 0], [5, 4, 0, 0]], np.int32)
    positions = lengths.copy()
    token = np.array(jnp.argmax(j_logits, -1), np.int32)
    for _ in range(4):
        j_logits, j_arena = j_infer.decode_step_pooled(
            jp, jnp.asarray(token), jcfg, j_arena, jnp.asarray(positions),
            jnp.asarray(tables))
        t_logits, _ = llama_infer.decode_step_pooled(
            tp, torch.from_numpy(token), tcfg, t_arena,
            torch.from_numpy(positions), torch.from_numpy(tables))
        _close(t_logits, j_logits, dtype)
        if dtype == 'float32':
            np.testing.assert_array_equal(
                t_logits.argmax(-1).numpy(), np.asarray(j_logits).argmax(-1))
        for key in ('k', 'v'):
            _close(_live(t_arena)[key], _live(j_arena)[key], dtype)
        token = np.array(jnp.argmax(j_logits, -1), np.int32)
        positions = positions + 1


def _window_prefill(tcfg, tp, prompt, table_row, chunk):
    arena = block_pool.init_arena(tcfg, N_BLOCKS, BS, device='cpu')
    table = torch.from_numpy(table_row)
    for start in range(0, len(prompt), chunk):
        window = np.zeros((chunk,), np.int32)
        piece = prompt[start:start + chunk]
        window[:len(piece)] = piece
        h, _ = llama_infer.prefill_window_pooled(
            tp, torch.from_numpy(window), tcfg, arena, table, start)
        last_start = start
    h_last = h[len(prompt) - 1 - last_start]
    logits = (h_last @ tp['lm_head']).float()
    return logits, arena


def test_chunked_window_prefill_matches_whole_prompt():
    """prefill_window_pooled in 16-token windows gives the whole-prompt
    prefill's greedy token and arena rows (f32)."""
    _, tcfg, _, tp = _models('float32')
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, tcfg.vocab_size, size=40).astype(np.int32)
    table_row = np.asarray([6, 2, 8, 0], np.int32)
    w_logits, w_arena = _window_prefill(tcfg, tp, prompt, table_row, 16)

    small = llama_infer.init_cache(tcfg, 1, 48, device='cpu')
    tokens = np.zeros((1, 48), np.int32)
    tokens[0, :40] = prompt
    logits, _ = llama_infer.prefill(tp, torch.from_numpy(tokens), tcfg,
                                    small, torch.tensor([40]))
    arena = block_pool.init_arena(tcfg, N_BLOCKS, BS, device='cpu')
    llama_infer.scatter_prefill_pooled(small, arena,
                                       torch.from_numpy(table_row[None, :3]))
    assert int(w_logits.argmax()) == int(logits[0].argmax())
    np.testing.assert_allclose(w_logits.numpy(), logits[0].numpy(),
                               atol=ATOL['float32'])
    for key in ('k', 'v'):
        got = w_arena[key][:, table_row[:3]].reshape(
            tcfg.n_layers, -1, tcfg.n_kv_heads, tcfg.head_dim)[:, :40]
        want = arena[key][:, table_row[:3]].reshape(
            tcfg.n_layers, -1, tcfg.n_kv_heads, tcfg.head_dim)[:, :40]
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=ATOL['float32'])


def test_window_prefill_matches_jax(models):
    dtype, jcfg, tcfg, jp, tp = models
    rng = np.random.RandomState(6)
    window = rng.randint(1, jcfg.vocab_size, size=16).astype(np.int32)
    table_row = np.asarray([6, 2, 8, 0], np.int32)
    start = 24     # a window straddling blocks 1 and 2
    j_arena = j_block_pool.init_arena(jcfg, N_BLOCKS, BS)
    j_h, j_arena = j_infer.prefill_window_pooled(
        jp, jnp.asarray(window), jcfg, j_arena, jnp.asarray(table_row),
        jnp.int32(start))
    t_arena = block_pool.init_arena(tcfg, N_BLOCKS, BS, device='cpu')
    t_h, _ = llama_infer.prefill_window_pooled(
        tp, torch.from_numpy(window), tcfg, t_arena,
        torch.from_numpy(table_row), start)
    _close(t_h, j_h, dtype)
    for key in ('k', 'v'):
        _close(_live(t_arena)[key], _live(j_arena)[key], dtype)


def test_deferred_branches_raise():
    """The int8 cache and int8 weights, once deferred, now have the JAX
    layout and product, and an unknown kv_dtype raises (MoE layers, once
    deferred too, are served: tests/test_torch_moe.py)."""
    _, tcfg, _, tp = _models('float32')
    cache = llama_infer.init_cache(tcfg, 1, 16, kv_dtype='int8',
                                   device='cpu')
    j_cache = j_infer.init_cache(j_llama.LLAMA_DEBUG, 1, 16, kv_dtype='int8')
    for key, arr in j_cache.items():
        assert tuple(cache[key].shape) == arr.shape
        assert str(cache[key].dtype).split('.')[-1] == str(arr.dtype)
    with pytest.raises(ValueError, match='kv_dtype'):
        llama_infer.init_cache(tcfg, 1, 16, kv_dtype='int4', device='cpu')
    from skypilot_tpu_torch.infer import quant
    w = {'q': torch.tensor([[1, -2], [3, 4], [0, 127]], dtype=torch.int8),
         's': torch.tensor([0.5, 2.0])}
    x = torch.tensor([[1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(quant.matmul(x, w).numpy(),
                                  [[3.5, 774.0]])
