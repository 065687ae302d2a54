"""K3's launch policy (skypilot_tpu_torch/ops/rmsnorm.py, _norm_launch) on
the CPU: its configuration pinned at the shapes the paths launch, its
invariants and refusals, the launch the wrapper makes, and a plain
emulation of a launch (each thread's vectors, the warp's shuffle tree,
the warps' partials) against the plain version and the JAX package (the
kernel itself runs only on the card: tests/test_torch_kernels.py).

Inputs are numpy draws from fixed seeds.  Tolerance: f32's, atol = rtol
= 2e-5 (every side computes in f32 and sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.ops import rmsnorm as j_rmsnorm  # noqa: E402
from skypilot_tpu_torch.ops import _kernels  # noqa: E402
from skypilot_tpu_torch.ops import rmsnorm  # noqa: E402
from tests.test_torch_decode_split import H100_SMS  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16, F32 = 2, 4


# ---- the policy -------------------------------------------------------------

@pytest.mark.parametrize('rows,d,elem,launch', [
    # Prefill chunks (4 x 512 rows) and training (8 x 1024, 2 x 4096) in
    # bf16: a warp a row, the row's vectors in registers.
    (2048, 4096, BF16, (32, 16, 256)),   # LLAMA3_8B, Mixtral
    (2048, 3072, BF16, (32, 12, 256)),   # Gemma-7B
    (2048, 1536, BF16, (32, 6, 256)),    # Qwen2.5-1.5B
    (2048, 8192, BF16, (64, 16, 512)),   # the 70B preset
    (8192, 4096, BF16, (32, 16, 528)),   # capped at 4 blocks an SM
    (4097, 4096, BF16, (32, 16, 513)),
    # Decode (8 slots), verify (8 x 13), windows (256) and the fused lane
    # (264): more threads a row, so the rows spread over more SMs.
    (8, 4096, BF16, (512, 1, 8)),
    (8, 3072, BF16, (256, 2, 8)),
    (8, 1536, BF16, (128, 2, 4)),
    (8, 8192, BF16, (1024, 1, 8)),
    (104, 4096, BF16, (512, 1, 104)),
    (256, 4096, BF16, (256, 2, 256)),
    (264, 4096, BF16, (128, 4, 132)),
    (264, 3072, BF16, (128, 3, 132)),
    (264, 1536, BF16, (128, 2, 132)),
    (1, 4096, BF16, (512, 1, 1)),
    # f32 (the debug models, parity runs): twice the vectors a row.
    (2048, 4096, F32, (64, 16, 512)),
    (8, 4096, F32, (1024, 1, 8)),
    (2048, 1536, F32, (32, 12, 256)),
    # The debug widths.
    (16, 64, F32, (32, 1, 2)),
    (1, 8, BF16, (32, 1, 1)),
    (7, 264, BF16, (32, 2, 1)),
])
def test_norm_launch_on_the_paths_shapes(rows, d, elem, launch):
    assert rmsnorm._norm_launch(rows, d, elem, H100_SMS) == launch


def _max_threads(nv):
    """The kernel's launch bounds at nv vectors a thread
    (csrc/rmsnorm.cu, rms_max_threads)."""
    return 1024 if nv <= 4 else 512 if nv <= 12 else 256


@pytest.mark.parametrize('elem', [BF16, F32])
@pytest.mark.parametrize('sms', [H100_SMS, 7])
def test_norm_launch_invariants(elem, sms):
    """Every configuration: tpr a power of two from 32 to 1,024; nv one of
    the kernel's counts whose vectors cover the row (or 0, the loop, only
    past 12 vectors a thread at 512 threads and 4 at 1,024); a block
    within the kernel's launch bounds; at least one block and at most 4
    an SM; and fewer threads a row than a row's vectors unless a warp is
    already more (no block is spread thinner than one vector a
    thread)."""
    for rows in (1, 2, 7, 8, 13, 104, 131, 132, 264, 1000, 2048, 100000):
        for d in (8, 16, 264, 1000, 1536, 3072, 4096, 5120, 8192, 14336,
                  65536, 131072):
            tpr, nv, grid = rmsnorm._norm_launch(rows, d, elem, sms)
            nvec = d * elem // 16
            assert tpr in (32, 64, 128, 256, 512, 1024)
            assert 1 <= grid <= min(-(-rows // (max(tpr, 256) // tpr)),
                                    4 * sms)
            if nv == 0:
                assert tpr == 1024 and nvec > 12 * 512
                continue
            assert nv in rmsnorm._NORM_VECS
            assert nv * tpr >= nvec                   # the row is covered
            assert max(tpr, 256) <= _max_threads(nv)  # the registers
            assert tpr == 32 or tpr <= nvec


@pytest.mark.parametrize('rows,d', [(0, 4096), (-1, 4096), (8, 12),
                                    (8, 4), (8, 0), (8, 4100)])
def test_norm_launch_refuses(rows, d):
    with pytest.raises(ValueError, match='rows|multiple of 8'):
        rmsnorm._norm_launch(rows, d, BF16, H100_SMS)


# ---- the launch -------------------------------------------------------------

@pytest.mark.parametrize('shape,dtype,launch', [
    ((2, 4, 4096), torch.bfloat16, (512, 1, 8)),
    ((4, 512, 3072), torch.bfloat16, (32, 12, 256)),
    ((264, 4096), torch.float32, (128, 8, 132)),
])
def test_rms_norm_launch_arguments(monkeypatch, shape, dtype, launch):
    """The wrapper's launch, with the library call recorded: the pointers,
    rows = the product of the leading dims, d, eps, the dtype code and
    the policy's (tpr, nv, grid); one launch counted; no launch for an
    empty x."""
    calls = []
    monkeypatch.setattr(_kernels, 'launch',
                        lambda name, device, *args: calls.append(
                            (name, args)))
    monkeypatch.setattr(_kernels, 'sm_count', lambda device: H100_SMS)
    d = shape[-1]
    x, w = torch.zeros(shape, dtype=dtype), torch.ones(d, dtype=dtype)
    before = rmsnorm.rms_norm.launches
    y = rmsnorm._rms_norm_cuda(x, w, 1e-6)
    assert y.shape == x.shape and y.dtype == dtype
    assert rmsnorm.rms_norm.launches == before + 1
    (name, args), = calls
    assert name == 'skk_rmsnorm'
    assert args[:3] == (x.data_ptr(), w.data_ptr(), y.data_ptr())
    assert args[3:5] == (x.numel() // d, d)
    assert args[5] == pytest.approx(1e-6)
    assert args[6] == _kernels.DTYPE_CODES[dtype]
    assert args[7:] == launch
    rmsnorm._rms_norm_cuda(torch.zeros(0, d, dtype=dtype), w, 1e-6)
    assert len(calls) == 1 and rmsnorm.rms_norm.launches == before + 1


@pytest.mark.parametrize('bad,match', [
    (lambda x, w: (x[:, :12], w[:12]), 'multiple of 8'),
    (lambda x, w: (x, w[:8]), 'weight shape'),
    (lambda x, w: (x.t(), w[:8]), 'contiguous'),
    (lambda x, w: (x, w.double()), 'weight must match'),
])
def test_rms_norm_launch_refuses(monkeypatch, bad, match):
    """Inputs the kernel does not take raise before any launch."""
    calls = []
    monkeypatch.setattr(_kernels, 'launch',
                        lambda name, device, *args: calls.append(name))
    monkeypatch.setattr(_kernels, 'sm_count', lambda device: H100_SMS)
    x, w = torch.zeros(8, 16), torch.ones(16)
    with pytest.raises(ValueError, match=match):
        rmsnorm._rms_norm_cuda(*bad(x, w), 1e-5)
    assert not calls


# ---- a launch emulated ------------------------------------------------------

def _emulate(x, w, eps, tpr, nv):
    """What a K3 launch computes on f32 rows x (rows, d), in the kernel's
    order: thread t of a row holds vectors t + j tpr (j < nv, or every
    such vector with nv 0) and sums their squares, vector by vector; the
    warp adds its lanes by the xor tree; the row adds its warps' partials
    in order; y = (x * rsqrt(ss / d + eps)) * w.  Also checks that every
    element belongs to exactly one (thread, vector)."""
    rows, d = x.shape
    vec = 4
    nvec = d // vec
    owner = np.full(nvec, -1)
    per_vec = np.zeros((rows, nvec), np.float32)
    for e in range(vec):
        per_vec += x[:, e::vec] * x[:, e::vec]
    thread = np.zeros((rows, tpr), np.float32)
    for j in range(nv if nv else -(-nvec // tpr)):
        for t in range(tpr):
            i = t + j * tpr
            if i < nvec:
                assert owner[i] == -1
                owner[i] = t
                thread[:, t] += per_vec[:, i]
    assert (owner >= 0).all()
    warps = thread.reshape(rows, tpr // 32, 32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        warps = warps + warps[..., lanes ^ o]
    ss = np.zeros(rows, np.float32)
    for k in range(tpr // 32):
        ss += warps[:, k, 0]
    r = (1 / np.sqrt(ss / np.float32(d) + np.float32(eps))).astype(
        np.float32)
    return (x * r[:, None]) * w


@pytest.mark.parametrize('rows,d', [(8, 4096), (264, 1536), (5, 3072),
                                    (104, 264), (3, 8), (2, 5000), (2, 26000)])
def test_emulated_launch_matches_plain_and_jax(rows, d):
    """The policy's f32 launch at each shape, emulated, against
    _rms_norm_plain and the JAX package's _rms_norm_xla (d 26,000 takes
    6,500 vectors: past 12 a thread at 512 threads and 4 at 1,024, the
    loop)."""
    rng = np.random.RandomState(rows + d)
    x = rng.randn(rows, d).astype(np.float32)
    w = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    tpr, nv, _ = rmsnorm._norm_launch(rows, d, F32, H100_SMS)
    assert (nv == 0) == (d == 26000)
    got = _emulate(x, w, 1e-5, tpr, nv)
    plain = rmsnorm._rms_norm_plain(torch.from_numpy(x),
                                    torch.from_numpy(w), 1e-5).numpy()
    ref = np.asarray(j_rmsnorm._rms_norm_xla(jnp.asarray(x), jnp.asarray(w),
                                             1e-5))
    np.testing.assert_allclose(got, plain, **F32_TOL)
    np.testing.assert_allclose(got, ref, **F32_TOL)
