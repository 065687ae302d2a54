"""The port's KV handoff image codec (skypilot_tpu_torch/serve/disagg.py)
and the batcher's handoff and session surface (export_handoff,
ingest_handoff, export_session, drain_sessions), on the CPU, held against
the JAX package (tests/test_disagg.py's codec and handoff cases).

What must hold:
- the same payload encodes to identical bytes in both packages (f32,
  int8 + f32 scales, and bf16: a torch bf16 tensor against an ml_dtypes
  array of the same bits); an image from either decodes in the other,
  bitwise; truncated, bit-flipped and tampered images are refused with
  the typed errors;
- a handoff (prefill, export, encode, decode, ingest, decode) gives the
  single-pool tokens in f32 and int8 KV, the prefill pool releases what
  it exported, and the image's shapes are the JAX export's;
- across the frameworks: the JAX batcher exports an image and the port's
  batcher ingests it, and the reverse; both decode the same greedy
  tokens;
- export_session survives a copy fault mid-spill, and drain_sessions'
  specs re-submitted on another batcher continue with the same tokens.

At LLAMA_DEBUG (2 layers, f32), weights from one JAX draw.  Tolerances:
tokens identical (greedy, f32); image bytes and payloads bitwise.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.serve import disagg as j_disagg  # noqa: E402
from skypilot_tpu_torch.infer import kv_tier  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import llama  # noqa: E402
from skypilot_tpu_torch.serve import disagg  # noqa: E402

CFG = llama.LLAMA_DEBUG
J_CFG = j_llama.LLAMA_DEBUG
PROMPT = [((7 * i) % 500) + 1 for i in range(24)]


@pytest.fixture(autouse=True)
def _one_thread():
    """The engines run many small ops: with several test workers on the
    host's cores, torch's intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def models():
    jp = j_llama.init_params(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, llama.params_from_numpy(tree, CFG, 'cpu')


@pytest.fixture
def closing():
    """Closes (joins) every batcher made in the test at teardown."""
    made = []
    yield made.append
    for b in made:
        b.close()


def _kw(**kw):
    base = dict(max_seq_len=128, batch_size=2, temperature=0.0,
                prompt_buckets=[32], prefix_cache_mb=0.5, prefix_block=8,
                host_tier_mb=4.0)
    base.update(kw)
    return base


# ---- codec --------------------------------------------------------------

def _payload(nodes=2, seed=0, dtype=np.float32, with_scale=False):
    """Per-node component dicts in the export layout (leading dims
    (x, ids_per_node)), as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nodes):
        bufs = {'k': rng.normal(size=(2, 1, 4)).astype(dtype),
                'v': rng.normal(size=(2, 1, 4)).astype(dtype)}
        if with_scale:
            bufs['k'] = rng.integers(-120, 120,
                                     size=(2, 1, 4)).astype(np.int8)
            bufs['k_scale'] = rng.normal(size=(2, 1, 1)).astype(np.float32)
        out.append(bufs)
    return out


def _as_torch(payload):
    """The same payload as CPU torch tensors (bf16 from its bits)."""
    out = []
    for bufs in payload:
        d = {}
        for c, a in bufs.items():
            if a.dtype == ml_dtypes.bfloat16:
                d[c] = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16)
            else:
                d[c] = torch.from_numpy(np.ascontiguousarray(a))
        out.append(d)
    return out


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


@pytest.mark.parametrize('case', ['f32', 'int8', 'bf16'])
def test_same_payload_same_bytes_and_cross_decode(case):
    dtype = ml_dtypes.bfloat16 if case == 'bf16' else np.float32
    payload = _payload(dtype=dtype, with_scale=case == 'int8')
    tokens = list(range(1, 17))
    want = j_disagg.encode_kv_image(tokens, 8, payload)
    assert disagg.encode_kv_image(tokens, 8, payload) == want
    assert disagg.encode_kv_image(tokens, 8, _as_torch(payload)) == want
    img = disagg.decode_kv_image(want)
    assert (img.tokens, img.tokens_per_node, img.nodes) == (tokens, 8, 2)
    j_img = j_disagg.decode_kv_image(
        disagg.encode_kv_image(tokens, 8, _as_torch(payload)))
    for got, jgot, ref in zip(img.payload, j_img.payload, payload):
        assert sorted(got) == sorted(ref)
        for c in ref:
            assert str(got[c].dtype) == f'torch.{ref[c].dtype.name}'
            assert list(got[c].shape) == list(ref[c].shape)
            assert _bits(got[c]) == _bits(ref[c]) == _bits(jgot[c])
    assert disagg.image_nbytes(payload) == disagg.image_nbytes(
        _as_torch(payload)) == j_disagg.image_nbytes(payload)


def test_truncation_and_framing_rejected():
    data = disagg.encode_kv_image([1, 2], 8, _payload())
    for bad in (data[:-3], data + b'x', data[:8]):
        with pytest.raises(disagg.HandoffImageError, match='truncated'):
            disagg.decode_kv_image(bad)
    with pytest.raises(disagg.HandoffImageError, match='magic'):
        disagg.decode_kv_image(b'NOTANIMG' + data[8:])


def test_bitflip_and_header_tamper_are_corrupt():
    data = bytearray(disagg.encode_kv_image([1, 2], 8, _payload()))
    data[-1] ^= 0x40
    with pytest.raises(disagg.CorruptImageError):
        disagg.decode_kv_image(bytes(data))
    with pytest.raises(j_disagg.CorruptImageError):
        j_disagg.decode_kv_image(bytes(data))
    data = bytearray(disagg.encode_kv_image([1, 2], 8, _payload()))
    idx = bytes(data).index(b'"tokens"')
    data[idx + 1] ^= 0x01
    with pytest.raises(disagg.CorruptImageError):
        disagg.decode_kv_image(bytes(data))
    assert issubclass(disagg.CorruptImageError, disagg.HandoffImageError)


def test_encode_rejects_empty_and_inconsistent_payloads():
    with pytest.raises(disagg.HandoffImageError, match='empty'):
        disagg.encode_kv_image([1], 8, [])
    bad = _payload()
    del bad[1]['v']
    with pytest.raises(disagg.HandoffImageError, match='components'):
        disagg.encode_kv_image([1], 8, bad)


# ---- batcher handoff ----------------------------------------------------

def _pool_balanced(b):
    b.pool.check_invariant()
    return b.pool.free_blocks() + b.pool.live_blocks() == b.pool.n_blocks - 1


def _serve(b, prompt, n):
    rid = b.submit(prompt, max_new_tokens=n)
    b.run_until_idle()
    return b.result(rid)


def _port(tp, closing, **kw):
    b = ContinuousBatcher(tp, CFG, GeneratorConfig(**_kw(**kw)),
                          decode_chunk=8, device='cpu')
    closing(b)
    return b


def _jax(jp, closing, **kw):
    b = j_serving.ContinuousBatcher(jp, J_CFG, j_engine.GeneratorConfig(
        **_kw(**kw)), decode_chunk=8)
    closing(b)
    return b


@pytest.mark.parametrize('kv', [None, 'int8'], ids=['f32', 'int8'])
def test_handoff_decode_bit_exact_and_equal_to_jax(models, closing, kv):
    jp, tp = models
    want = _serve(_port(tp, closing, kv_cache_dtype=kv), PROMPT, 8)
    jref = _jax(jp, closing, kv_cache_dtype=kv)
    assert _serve(jref, PROMPT, 8) == want

    pre = _port(tp, closing, kv_cache_dtype=kv)
    _serve(pre, PROMPT, 1)
    res = pre.export_handoff(PROMPT)
    assert res['tokens'] == ((len(PROMPT) - 1) // 8) * 8
    assert _pool_balanced(pre)

    jpre = _jax(jp, closing, kv_cache_dtype=kv)
    _serve(jpre, PROMPT, 1)
    jres = jpre.export_handoff(PROMPT)
    assert jres['tokens'] == res['tokens']
    data = disagg.encode_kv_image(PROMPT[:res['tokens']], 8, res['payload'])
    jdata = j_disagg.encode_kv_image(PROMPT[:jres['tokens']], 8,
                                     jres['payload'])
    # The same header: components, dtypes and shapes of the JAX export.
    hdr = disagg._PROLOGUE.size
    assert data[hdr:hdr + 300].split(b'}]')[0] == \
        jdata[hdr:hdr + 300].split(b'}]')[0]
    assert len(data) == len(jdata)
    img = disagg.decode_kv_image(data)
    assert img.nodes == res['tokens'] // 8

    dec = _port(tp, closing, kv_cache_dtype=kv)
    assert dec.ingest_handoff(PROMPT, img.payload) == img.nodes
    dec.tier_flush()
    assert _serve(dec, PROMPT, 8) == want
    dec.tier_flush()
    assert dec._tier.stats()['adopted'] == img.nodes
    assert dec._prefix.hits == 1
    assert _pool_balanced(dec)


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_handoff_across_the_frameworks(models, closing, direction):
    """One package prefills and exports, the other ingests the image and
    decodes: the single-pool tokens of both packages."""
    jp, tp = models
    want = _serve(_port(tp, closing), PROMPT, 8)
    if direction == 'jax_to_port':
        pre, dec = _jax(jp, closing), _port(tp, closing)
        codec_out, codec_in = j_disagg, disagg
    else:
        pre, dec = _port(tp, closing), _jax(jp, closing)
        codec_out, codec_in = disagg, j_disagg
    _serve(pre, PROMPT, 1)
    res = pre.export_handoff(PROMPT)
    img = codec_in.decode_kv_image(codec_out.encode_kv_image(
        PROMPT[:res['tokens']], 8, res['payload']))
    assert dec.ingest_handoff(PROMPT, img.payload) == img.nodes > 0
    dec.tier_flush()
    assert _serve(dec, PROMPT, 8) == want
    assert dec._prefix.hits == 1


def test_corrupt_image_falls_back_to_cold_prefill(models, closing):
    _, tp = models
    want = _serve(_port(tp, closing), PROMPT, 8)
    pre = _port(tp, closing)
    _serve(pre, PROMPT, 1)
    res = pre.export_handoff(PROMPT)
    data = bytearray(disagg.encode_kv_image(PROMPT[:res['tokens']], 8,
                                            res['payload']))
    data[-5] ^= 0x01
    dec = _port(tp, closing)
    with pytest.raises(disagg.CorruptImageError):
        dec.ingest_handoff(PROMPT, disagg.decode_kv_image(
            bytes(data)).payload)
    assert _serve(dec, PROMPT, 8) == want
    assert dec._prefix.hits == 0 and dec._tier.adopted == 0


def test_export_handoff_unknown_prefix_returns_none(models, closing):
    _, tp = models
    assert _port(tp, closing).export_handoff(
        [9, 8, 7, 6, 5, 4, 3, 2, 1]) is None


# ---- sessions -----------------------------------------------------------

def test_export_session_survives_copy_fault_mid_spill(models, closing,
                                                      monkeypatch):
    _, tp = models
    b = ContinuousBatcher(tp, CFG, GeneratorConfig(**_kw()), decode_chunk=4,
                          device='cpu')
    closing(b)
    warm = [((5 * i) % 500) + 1 for i in range(24)]
    _serve(b, warm, 4)
    live = [((11 * i) % 500) + 1 for i in range(16)]
    rid = b.submit(live, max_new_tokens=12)
    b.step()
    assert b.num_active == 1

    def boom(_):
        raise RuntimeError('host copy died')

    monkeypatch.setattr(kv_tier, '_complete_copy', boom)
    assert b._prefix.forget(warm, spill=True) > 0
    specs = b.drain_sessions()             # must NOT raise
    assert [s['rid'] for s in specs] == [rid]
    assert specs[0]['tier']['device_tokens'] >= 0
    assert not b._tier.in_flight()
    assert b.num_active == 0
    b.pool.check_invariant()


def test_drained_sessions_continue_on_another_batcher(models, closing):
    """drain_sessions mid-decode; the specs re-submitted (prompt + out,
    the remaining budget) on another batcher continue with the tokens of
    an uninterrupted run."""
    _, tp = models
    prompts = [PROMPT, [((3 * i) % 500) + 2 for i in range(13)]]
    ref = _port(tp, closing, prompt_buckets=[32, 64])
    rids = [ref.submit(p, max_new_tokens=20) for p in prompts]
    ref.run_until_idle()
    want = [ref.result(r) for r in rids]
    a = _port(tp, closing, prompt_buckets=[32, 64])
    for p in prompts:
        a.submit(p, max_new_tokens=20)
    a.step()                       # admitted, one decode chunk
    specs = a.drain_sessions()
    assert len(specs) == 2 and all(0 < len(s['out']) < 20 for s in specs)
    assert a.num_active == 0 and a.pool.live_blocks() == a._prefix.node_count
    b = _port(tp, closing, prompt_buckets=[32, 64])
    rids = [b.submit(s['prompt'] + s['out'],
                     max_new_tokens=s['max_new_tokens'] - len(s['out']))
            for s in specs]
    b.run_until_idle()
    got = [s['out'] + b.result(r) for s, r in zip(specs, rids)]
    assert got == want
