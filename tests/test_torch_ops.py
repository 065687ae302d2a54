"""The port's kernel modules (skypilot_tpu_torch/ops) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  On CPU
tensors each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do, and its plain references.  Tolerances: f32 atol 1e-5 (the
two sides sum in another order); bf16 inputs are compared in f32 after
the cast, at the atol stated per test.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.ops import attention as j_attention  # noqa: E402
from skypilot_tpu.ops import decode_attention as j_decode  # noqa: E402
from skypilot_tpu.ops import rmsnorm as j_rmsnorm  # noqa: E402
from skypilot_tpu.ops import rope as j_rope  # noqa: E402
from skypilot_tpu_torch.ops import _kernels  # noqa: E402
from skypilot_tpu_torch.ops import attention  # noqa: E402
from skypilot_tpu_torch.ops import decode_attention  # noqa: E402
from skypilot_tpu_torch.ops import rmsnorm  # noqa: E402
from skypilot_tpu_torch.ops import rope  # noqa: E402

F32_ATOL = 1e-5


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`
    (bf16 rounding happens once, in JAX, then travels exactly)."""
    j = jnp.asarray(arr).astype(jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---- rmsnorm ---------------------------------------------------------------

@pytest.mark.parametrize('dtype,atol', [
    ('float32', F32_ATOL),
    # One bf16 ulp at |y| < 4: the two sides' rsqrt may round the last
    # f32 bit differently before the cast.
    ('bfloat16', 2 ** -6),
])
@pytest.mark.parametrize('rows', [8, 5])
def test_rms_norm_matches_jax(dtype, atol, rows):
    rng = np.random.RandomState(rows)
    x_j, x_t = _pair(rng.randn(rows, 256).astype(np.float32), dtype)
    w_j, w_t = _pair((1 + 0.1 * rng.randn(256)).astype(np.float32), dtype)
    out = rmsnorm.rms_norm(x_t, w_t, eps=1e-5)
    assert out.dtype == x_t.dtype and out.shape == x_t.shape
    ref_xla = j_rmsnorm._rms_norm_xla(x_j, w_j, 1e-5)
    ref_pallas = j_rmsnorm._rmsnorm_pallas(x_j, w_j, 1e-5, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref_xla), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(out), _np(ref_pallas), atol=atol, rtol=0)


def test_rms_norm_on_cpu_never_launches_the_kernel():
    before = rmsnorm.rms_norm.launches
    x = torch.randn(3, 4, 64)
    rmsnorm.rms_norm(x, torch.ones(64))
    assert rmsnorm.rms_norm.launches == before


# ---- rope ------------------------------------------------------------------

_LLAMA3 = {'rope_type': 'llama3', 'factor': 8.0, 'low_freq_factor': 1.0,
           'high_freq_factor': 4.0, 'original_max_position_embeddings': 64}


@pytest.mark.parametrize('scaling', [None, _LLAMA3])
@pytest.mark.parametrize('with_positions', [False, True])
def test_rope_matches_jax(scaling, with_positions):
    rng = np.random.RandomState(1)
    cos_j, sin_j = j_rope.rope_frequencies(32, 300, 500000.0, scaling)
    cos_t, sin_t = rope.rope_frequencies(32, 300, 500000.0, scaling)
    np.testing.assert_allclose(cos_t.numpy(), _np(cos_j), atol=F32_ATOL)
    np.testing.assert_allclose(sin_t.numpy(), _np(sin_j), atol=F32_ATOL)
    x_j, x_t = _pair(rng.randn(2, 6, 3, 32).astype(np.float32), 'float32')
    pos = rng.randint(0, 300, size=(2, 6)).astype(np.int32)
    if with_positions:
        ref = j_rope.apply_rope(x_j, cos_j, sin_j, positions=jnp.asarray(pos))
        out = rope.apply_rope(x_t, cos_t, sin_t,
                              positions=torch.from_numpy(pos).long())
    else:
        ref = j_rope.apply_rope(x_j, cos_j, sin_j)
        out = rope.apply_rope(x_t, cos_t, sin_t)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=F32_ATOL)


def test_rope_rejects_unknown_scaling():
    with pytest.raises(NotImplementedError, match='llama3'):
        rope.rope_frequencies(32, 8, scaling={'rope_type': 'yarn'})


# ---- flash attention (prefill) ---------------------------------------------

@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('group', [1, 4])
def test_flash_attention_matches_jax(causal, group):
    rng = np.random.RandomState(2 + group)
    batch, seq, heads, hd = 2, 128, 4, 128
    kv = heads // group
    q_j, q_t = _pair(rng.randn(batch, seq, heads, hd).astype(np.float32),
                     'float32')
    k_j, k_t = _pair(rng.randn(batch, seq, kv, hd).astype(np.float32),
                     'float32')
    v_j, v_t = _pair(rng.randn(batch, seq, kv, hd).astype(np.float32),
                     'float32')
    out = attention.flash_attention(q_t, k_t, v_t, causal=causal)
    assert out.shape == q_t.shape
    ref = j_attention.flash_attention(q_j, k_j, v_j, causal=causal,
                                      use_pallas=False)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=F32_ATOL)
    # The Pallas forward kernel itself, in its (B, H, S, D) layout.
    kern, _ = j_attention._flash_fwd(
        jnp.swapaxes(q_j, 1, 2), jnp.swapaxes(k_j, 1, 2),
        jnp.swapaxes(v_j, 1, 2), causal=causal, block=128,
        interpret=True, need_lse=False)
    np.testing.assert_allclose(out.numpy(), _np(jnp.swapaxes(kern, 1, 2)),
                               atol=F32_ATOL)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('group', [1, 4])
def test_flash_fwd_plain_matches_jax_kernel(dtype, causal, group):
    """_flash_fwd_plain (K2's own numerics, the plain version the card's
    tensor-core K2 is held to) against the Pallas _flash_fwd in
    interpret mode: o and lse, two 128-row k-blocks so the kernel's
    online rescaling runs.  f32: atol 1e-5 (summation order).  bf16: the
    lse is f32 on both sides (atol 1e-5); p is rounded to bf16 against
    the running max of the kernel's k-block and the row's final max
    here, so o is held per row: atol one bf16 ulp (2^-7) of the row's
    largest |o|, rtol two ulps (2^-6); measured at most 0.53 of it."""
    rng = np.random.RandomState(20 + group + 2 * causal)
    batch, seq, heads, hd = 1, 256, 4, 128
    kv = heads // group
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = [
        _pair(rng.randn(batch, seq, h, hd).astype(np.float32), dtype)
        for h in (heads, kv, kv)]
    o, lse = attention._flash_fwd_plain(q_t, k_t, v_t, causal)
    assert o.dtype == q_t.dtype and lse.dtype == torch.float32
    assert lse.shape == (batch, heads, seq)
    sw = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
    o_j, lse_j = j_attention._flash_fwd(sw(q_j), sw(k_j), sw(v_j), causal,
                                        128, interpret=True, need_lse=True)
    np.testing.assert_allclose(lse.numpy(), _np(lse_j[..., 0]),
                               atol=F32_ATOL)
    want = _np(sw(o_j))
    if dtype == 'float32':
        np.testing.assert_allclose(o.numpy(), want, atol=F32_ATOL)
        return
    row_max = np.abs(want).max(-1, keepdims=True)
    excess = np.abs(_np(o) - want) - (2 ** -7 * row_max
                                       + 2 ** -6 * np.abs(want))
    assert excess.max() <= 0, excess.max()


def test_flash_attention_bf16_matches_jax_reference():
    # bf16: the two frameworks round the bf16 score and output products
    # at other places; atol is two bf16 ulps at |o| < 2.
    rng = np.random.RandomState(7)
    q_j, q_t = _pair(rng.randn(1, 40, 4, 64).astype(np.float32), 'bfloat16')
    k_j, k_t = _pair(rng.randn(1, 40, 2, 64).astype(np.float32), 'bfloat16')
    v_j, v_t = _pair(rng.randn(1, 40, 2, 64).astype(np.float32), 'bfloat16')
    out = attention.flash_attention(q_t, k_t, v_t)
    assert out.dtype == torch.bfloat16
    ref = j_attention.flash_attention(q_j, k_j, v_j, use_pallas=False)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2 * 2 ** -7)


def test_flash_attention_rejects_wrong_rank():
    with pytest.raises(ValueError, match='B, S, H, D'):
        attention.flash_attention(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4),
                                  torch.zeros(2, 3, 4))


# ---- paged decode attention ------------------------------------------------

def _arena_case(seed=1):
    """Scattered, non-monotonic tables over a 2-layer arena; positions at
    0, BS-1, BS and the table's end."""
    rng = np.random.RandomState(seed)
    lay, bs, t_width, kv, group, hd, batch = 2, 16, 4, 2, 2, 128, 4
    nb = 1 + batch * t_width
    q = rng.randn(batch, kv, group, hd).astype(np.float32)
    k = rng.randn(lay, nb, bs, kv, hd).astype(np.float32)
    v = rng.randn(lay, nb, bs, kv, hd).astype(np.float32)
    positions = np.asarray([0, bs - 1, bs, t_width * bs - 1], np.int32)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((batch, t_width), np.int32)
    for b in range(batch):
        live = positions[b] // bs + 1
        tables[b, :live] = perm[b * t_width:b * t_width + live]
    return q, k, v, tables, positions


def test_decode_attention_matches_jax_kernel():
    q, k, v, tables, positions = _arena_case()
    layer = 1
    out = decode_attention.decode_attention_pooled(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), layer, torch.from_numpy(positions))
    ref = j_decode.decode_attention_pooled(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        layer, jnp.asarray(positions), interpret=True)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=F32_ATOL)


def test_reference_decode_attention_matches_jax():
    q, k, v, tables, positions = _arena_case(seed=2)
    bs = k.shape[2]
    k_g = k[0][tables].reshape(4, -1, *k.shape[3:])
    v_g = v[0][tables].reshape(4, -1, *v.shape[3:])
    out = decode_attention.reference_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_g), torch.from_numpy(v_g),
        torch.from_numpy(positions))
    ref = j_decode.reference_decode_attention(
        jnp.asarray(q), jnp.asarray(k_g), jnp.asarray(v_g),
        jnp.asarray(positions))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=F32_ATOL)
    plain = decode_attention.decode_attention_pooled(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), 0, torch.from_numpy(positions))
    np.testing.assert_allclose(plain.numpy(), out.numpy(), atol=F32_ATOL)
    assert k_g.shape[1] == tables.shape[1] * bs


def test_decode_attention_ignores_garbage_past_position():
    """Blocks a table does not map (the garbage block included) and rows
    past each slot's position must not change its output."""
    q, k, v, tables, positions = _arena_case(seed=3)
    layer = 0
    args = (torch.from_numpy(tables), layer, torch.from_numpy(positions))
    out1 = decode_attention.decode_attention_pooled(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), *args)
    k2, v2 = k.copy(), v.copy()
    mapped = set(tables.flatten().tolist()) - {0}
    unmapped = [b for b in range(k.shape[1]) if b not in mapped]
    k2[:, unmapped] = 1e4
    v2[:, unmapped] = -1e4
    bs = k.shape[2]
    for b, pos in enumerate(positions):
        blk = tables[b, pos // bs]
        k2[layer, blk, pos % bs + 1:] = 1e4
        v2[layer, blk, pos % bs + 1:] = -1e4
    out2 = decode_attention.decode_attention_pooled(
        torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2),
        *args)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


def test_decode_attention_bf16_matches_jax_kernel():
    # bf16 arena and q; the JAX kernel keeps p in f32 and the port's
    # plain version casts p to bf16 (as the JAX decode off the TPU
    # does): atol is two bf16 ulps at |o| < 2.
    q, k, v, tables, positions = _arena_case(seed=4)
    pairs = [_pair(a, 'bfloat16') for a in (q, k, v)]
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = pairs
    out = decode_attention.decode_attention_pooled(
        q_t, k_t, v_t, torch.from_numpy(tables), 1,
        torch.from_numpy(positions))
    ref = j_decode.decode_attention_pooled(
        q_j, k_j, v_j, jnp.asarray(tables), 1, jnp.asarray(positions),
        interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2 * 2 ** -7)


def _int8_rows(x: np.ndarray):
    """Per-row absmax int8 quantization (the JAX test_fused_step.py
    helper): (int8 values, f32 scales over the last axis)."""
    s = np.maximum(np.abs(x).max(-1), 1e-8).astype(np.float32) / 127.0
    return np.round(x / s[..., None]).astype(np.int8), s


def test_decode_attention_int8_is_deferred():
    """The int8 arena (once deferred to ROADMAP Queue A item 7) against
    the JAX kernel in interpret mode.  The JAX kernel dequantizes before
    the dot and keeps p in f32; the port's plain version follows the JAX
    CPU decode (scales after each contraction, p cast to q's dtype), the
    same math in f32 up to summation order: atol 1e-5."""
    q, k, v, tables, positions = _arena_case(seed=6)
    k8, ks = _int8_rows(k)
    v8, vs = _int8_rows(v)
    args = [torch.from_numpy(a) for a in (q, k8, v8, tables)]
    out = decode_attention.decode_attention_pooled(
        *args, 1, torch.from_numpy(positions), torch.from_numpy(ks),
        torch.from_numpy(vs))
    ref = j_decode.decode_attention_pooled(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(tables), 1, jnp.asarray(positions), jnp.asarray(ks),
        jnp.asarray(vs), interpret=True)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=F32_ATOL)


# ---- kernel build --------------------------------------------------------

def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build names what is missing (it never falls back
    to the plain versions)."""
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc'):
        _kernels._nvcc()


def test_kernel_library_name_tracks_sources():
    digest = _kernels._digest()
    assert len(digest) == 16 and digest == _kernels._digest()
    names = {p.name for p in _kernels._sources()}
    assert {'rmsnorm.cu', 'flash_fwd.cu', 'paged_decode.cu',
            'paged_window.cu'} <= names
