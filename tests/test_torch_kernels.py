"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (these tests skip without an NVIDIA card and nvcc).

Run on a machine with a card:
    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerances (kernel vs plain, same inputs): f32 atol 2e-5 (summation
order); bf16 atol 3e-2 + rtol 2e-2 (the plain versions round scores or
probabilities to bf16 where the kernels keep f32, and outputs are
rounded to bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=2e-2)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'false)')
    from skypilot_tpu_torch.ops import _kernels
    try:
        _kernels._nvcc()
    except RuntimeError:
        pytest.skip('needs nvcc to build the kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,d', [(1, 8), (7, 256), (64, 4096)])
def test_rms_norm_kernel(cuda, dtype, rows, d):
    from skypilot_tpu_torch.ops import rmsnorm
    x = torch.randn(rows, d, generator=cuda, device='cuda').to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=cuda, device='cuda')).to(dtype)
    before = rmsnorm.rms_norm.launches
    out = rmsnorm.rms_norm(x, w)
    assert rmsnorm.rms_norm.launches == before + 1
    torch.testing.assert_close(out, rmsnorm._rms_norm_plain(x, w, 1e-5),
                               **TOL[dtype])
    with pytest.raises(ValueError, match='multiple of 8'):
        rmsnorm.rms_norm(torch.zeros(rows, 12, device='cuda', dtype=dtype),
                         torch.ones(12, device='cuda', dtype=dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('seq,heads,kv,hd,causal', [
    (1, 4, 4, 64, True), (77, 8, 2, 128, True), (130, 4, 1, 256, False),
    (64, 32, 8, 128, True)])
def test_flash_attention_kernel(cuda, dtype, seq, heads, kv, hd, causal):
    from skypilot_tpu_torch.ops import attention
    q = torch.randn(2, seq, heads, hd, generator=cuda, device='cuda').to(dtype)
    k = torch.randn(2, seq, kv, hd, generator=cuda, device='cuda').to(dtype)
    v = torch.randn(2, seq, kv, hd, generator=cuda, device='cuda').to(dtype)
    out = attention.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(
        out, attention._attention_plain(q, k, v, causal=causal),
        **TOL[dtype])
    with pytest.raises(ValueError, match='head_dim'):
        attention.flash_attention(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hd,group,bs', [(64, 1, 16), (128, 4, 64),
                                         (256, 8, 32)])
def test_paged_decode_kernel(cuda, dtype, hd, group, bs):
    from skypilot_tpu_torch.ops import decode_attention
    batch, kv, t_width, layers = 4, 2, 5, 2
    nb = 1 + batch * t_width
    rng = np.random.RandomState(hd)
    positions = torch.tensor([0, bs - 1, bs, t_width * bs - 1],
                             dtype=torch.int32, device='cuda')
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((batch, t_width), np.int32)
    for b in range(batch):
        live = int(positions[b]) // bs + 1
        tables[b, :live] = perm[b * t_width:b * t_width + live]
    tables = torch.as_tensor(tables, device='cuda')
    q = torch.randn(batch, kv, group, hd, generator=cuda,
                    device='cuda').to(dtype)
    k = torch.randn(layers, nb, bs, kv, hd, generator=cuda,
                    device='cuda').to(dtype)
    v = torch.randn(layers, nb, bs, kv, hd, generator=cuda,
                    device='cuda').to(dtype)
    out = decode_attention.decode_attention_pooled(q, k, v, tables, 1,
                                                   positions)
    torch.testing.assert_close(
        out, decode_attention._decode_attention_plain(q, k, v, tables, 1,
                                                      positions),
        **TOL[dtype])
    with pytest.raises(ValueError, match='int32'):
        decode_attention.decode_attention_pooled(q, k, v, tables.long(), 1,
                                                 positions)


def test_batcher_on_card_matches_host(cuda):
    """LLAMA_DEBUG f32 served through the kernels gives the host's
    greedy tokens."""
    from skypilot_tpu_torch.infer.engine import GeneratorConfig
    from skypilot_tpu_torch.infer.serving import ContinuousBatcher
    from skypilot_tpu_torch.models import llama
    cfg = llama.LLAMA_DEBUG
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')

    def run(device):
        p = _to(params, device)
        b = ContinuousBatcher(p, cfg, GeneratorConfig(
            max_seq_len=128, batch_size=2, prompt_buckets=[16, 32],
            prefill_chunk=24, kv_block_size=16), decode_chunk=4,
            device=device)
        rids = [b.submit(list(range(1, n + 1)), max_new_tokens=8)
                for n in (5, 30, 9)]
        b.run_until_idle()
        return [b.result(r) for r in rids]

    assert run('cuda') == run('cpu')


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
