"""The port's HF checkpoint conversion (skypilot_tpu_torch/models/
convert.py) against the JAX package's and against ``transformers``, on
the CPU.

Tiny HF models of the five families are built with ``transformers``
from fixed seeds (norm weights drawn far from their init, so Gemma's
(1 + w) fold is exercised) and saved to ``tmp_path`` as one safetensors
file, as sharded safetensors with an index, and as torch ``.bin``
(one file, and sharded with an index).
The port loads each directory itself, without ``transformers`` or
``safetensors``.  Tolerances:
- the converted leaves: bitwise equal to the JAX package's
  ``hf_state_dict_to_params`` of the model's state_dict, in f32 and in
  bf16 (bf16 compared through f32, which is exact);
- forward logits, f32: within 1e-4 of the JAX package's forward (the
  same weights, sums in another order) and within 2e-3 of transformers'
  (the JAX package's own bound in tests/test_convert.py);
- the training loss and every gradient of a converted Gemma and Qwen2,
  f32: atol 1e-5 against jax.grad (test_torch_train.py's bound);
- the batchers: greedy tokens identical to transformers' ``generate``
  and to the JAX ContinuousBatcher, token for token;
- the refusals: the JAX package's exception type and text.
"""
import dataclasses
import importlib.util
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
safetensors_torch = pytest.importorskip('safetensors.torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from skypilot_tpu.infer import engine as j_engine  # noqa: E402
from skypilot_tpu.infer import serving as j_serving  # noqa: E402
from skypilot_tpu.models import convert as j_convert  # noqa: E402
from skypilot_tpu.models import llama as j_llama  # noqa: E402
from skypilot_tpu.models import moe as j_moe  # noqa: E402
from skypilot_tpu_torch.infer.engine import GeneratorConfig  # noqa: E402
from skypilot_tpu_torch.infer.serving import ContinuousBatcher  # noqa: E402
from skypilot_tpu_torch.models import convert, llama, moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGITS_JAX_ATOL = 1e-4
LOGITS_HF_TOL = 2e-3
GRAD_ATOL = 1e-5

# Tiny models of each family: (transformers config class, its kwargs,
# seed).  Llama: rope_scaling 'llama3' and tied embeddings; Mistral: a
# window below max_position_embeddings; Gemma: head_dim 32 != 64 / 4;
# Qwen2: biases, 6 query heads over 1 KV head (a group of 6), tied;
# Mixtral: 4 experts, top 2.
FAMILIES = {
    'llama': ('LlamaConfig', dict(
        vocab_size=160, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        rope_scaling={'rope_type': 'llama3', 'factor': 4.0,
                      'low_freq_factor': 1.0, 'high_freq_factor': 4.0,
                      'original_max_position_embeddings': 32},
        tie_word_embeddings=True), 0),
    'mistral': ('MistralConfig', dict(
        vocab_size=128, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, sliding_window=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False), 1),
    'gemma': ('GemmaConfig', dict(
        vocab_size=128, hidden_size=64, intermediate_size=144,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=32, max_position_embeddings=256, rms_norm_eps=1e-6,
        rope_theta=10000.0, hidden_activation='gelu_pytorch_tanh'), 2),
    'qwen2': ('Qwen2Config', dict(
        vocab_size=160, hidden_size=96, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=1,
        max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=1e6,
        use_sliding_window=False, tie_word_embeddings=True), 3),
    'mixtral': ('MixtralConfig', dict(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=256, sliding_window=None, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False), 4),
}
FORMATS = ('safetensors', 'sharded', 'bin', 'sharded-bin', 'state_dict')
DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _hf_model(family):
    cls, kwargs, seed = FAMILIES[family]
    cfg = getattr(transformers, cls)(attn_implementation='eager', **kwargs)
    torch.manual_seed(seed)
    model = getattr(transformers, cls.replace('Config', 'ForCausalLM'))(cfg)
    model.eval()
    gemma = family == 'gemma'
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('norm.weight'):
                # Gemma stores w (runtime 1 + w), the others the scale.
                p.copy_(torch.randn(p.shape) * 0.5 + (0.0 if gemma else 1.0))
    return model


@pytest.fixture(scope='module')
def hf_models():
    return {}


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    """(family, format) -> a directory the model was saved to, once."""
    cache = {}

    def get(family, fmt, model):
        if (family, fmt) not in cache:
            d = tmp_path_factory.mktemp(f'{family}_{fmt}')
            kw = dict(safe_serialization=not fmt.endswith('bin'))
            if fmt.startswith('sharded'):
                kw['max_shard_size'] = '20KB'
            model.save_pretrained(str(d), **kw)
            cache[family, fmt] = str(d)
        return cache[family, fmt]
    return get


def _model(hf_models, family):
    if family not in hf_models:
        hf_models[family] = _hf_model(family)
    return hf_models[family]


def _norm_offset(family):
    return 1.0 if family == 'gemma' else 0.0


def _jax(model, family, jdtype):
    jcfg = j_convert.config_from_hf(model.config, dtype=jdtype)
    return jcfg, j_convert.hf_state_dict_to_params(
        model.state_dict(), jcfg, norm_offset=_norm_offset(family))


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _keys(tree):
    return [(k, _keys(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()]


def _same_config(port_cfg, jax_cfg, tdtype):
    assert type(port_cfg).__name__ == type(jax_cfg).__name__
    want = dataclasses.asdict(jax_cfg)
    got = dataclasses.asdict(port_cfg)
    assert got.pop('dtype') == tdtype
    want.pop('dtype')
    assert got == want


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('fmt', FORMATS)
@pytest.mark.parametrize('family', list(FAMILIES))
def test_leaves_bitwise_equal_to_jax(hf_models, saved, family, fmt, dtype):
    """Every converted leaf, from every file format (and from the
    in-memory state_dict), is bitwise the JAX package's, and the config
    is the JAX package's."""
    tdtype, jdtype = DTYPES[dtype]
    model = _model(hf_models, family)
    jcfg, jp = _jax(model, family, jdtype)
    if fmt == 'state_dict':
        cfg = convert.config_from_hf(model.config, dtype=tdtype)
        tree = convert.hf_state_dict_to_params(
            model.state_dict(), cfg, norm_offset=_norm_offset(family),
            device='cpu')
    else:
        tree, cfg = convert.load_hf_model(saved(family, fmt, model),
                                          dtype=tdtype, device='cpu')
    _same_config(cfg, jcfg, tdtype)
    init = (moe.init_params if family == 'mixtral' else llama.init_params)(
        cfg, torch.Generator().manual_seed(0), 'cpu')
    assert _keys(tree) == _keys(init)     # init_params' layout and order
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, want in flat:
        got = _leaf(tree, path)
        assert got.dtype == tdtype and got.is_contiguous(), path
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            err_msg=jax.tree_util.keystr(path))
    if family == 'gemma' and dtype == 'bfloat16':
        # The offset is added in f32 and rounded once: adding it to the
        # bf16-rounded weight rounds twice and gives other weights.
        w = model.state_dict()['model.layers.0.input_layernorm.weight']
        twice = (w.to(torch.bfloat16) + 1).to(torch.bfloat16)
        assert not torch.equal(twice, tree['layers']['ln1'][0])


@pytest.mark.parametrize('family', list(FAMILIES))
def test_config_json_dict_maps_as_the_hf_object(hf_models, family):
    model = _model(hf_models, family)
    from_obj = convert.config_from_hf(model.config, dtype=torch.float32)
    from_dict = convert.config_from_hf(
        json.loads(model.config.to_json_string(use_diff=False)),
        dtype=torch.float32)
    assert from_dict == from_obj


def _tokens(vocab):
    rng = np.random.RandomState(0)
    return rng.randint(0, vocab, size=(2, 12))


@pytest.mark.parametrize('family', list(FAMILIES))
def test_logits_match_jax_and_transformers(hf_models, saved, family):
    model = _model(hf_models, family)
    tree, cfg = convert.load_hf_model(saved(family, 'safetensors', model),
                                      dtype=torch.float32, device='cpu')
    jcfg, jp = _jax(model, family, jnp.float32)
    tokens = _tokens(cfg.vocab_size)
    with torch.no_grad():
        want_hf = model(torch.from_numpy(tokens)).logits.float().numpy()
        if family == 'mixtral':
            got, _ = moe.forward(tree, torch.from_numpy(tokens), cfg)
            want_jax, _ = j_moe.forward(jp, jnp.asarray(tokens), jcfg)
        else:
            got = llama.forward(tree, torch.from_numpy(tokens), cfg)
            want_jax = j_llama.forward(jp, jnp.asarray(tokens), jcfg)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want_jax),
                               atol=LOGITS_JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got, want_hf, atol=LOGITS_HF_TOL,
                               rtol=LOGITS_HF_TOL)


@pytest.mark.parametrize('family', ['gemma', 'qwen2'])
def test_loss_and_every_gradient_match_jax(hf_models, saved, family):
    """The training loss and every gradient of a converted Gemma (gelu,
    embed_scale, head_dim 32 != 64 / 4) and Qwen2 (biases, G 6) model
    against jax.grad of the JAX package's loss_fn, f32: loss and each
    gradient element at atol GRAD_ATOL."""
    model = _model(hf_models, family)
    tree, cfg = convert.load_hf_model(saved(family, 'safetensors', model),
                                      dtype=torch.float32, device='cpu')
    jcfg, jp = _jax(model, family, jnp.float32)
    tokens = _tokens(cfg.vocab_size)
    want_loss, want = jax.value_and_grad(
        lambda p: j_llama.loss_fn(p, {'tokens': jnp.asarray(tokens)},
                                  jcfg))(jp)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    params = [_leaf(tree, path).requires_grad_() for path, _ in leaves]
    loss = llama.loss_fn(tree, {'tokens': torch.from_numpy(tokens)}, cfg)
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=GRAD_ATOL, rtol=0)
    for (path, _), g in zip(leaves, grads):
        w = np.asarray(_leaf(want, path))
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# The batcher's requests: more than its slots, one chunked (a 24-token
# prefill window).
KW = dict(max_seq_len=128, batch_size=2, prompt_buckets=[16, 32, 64],
          prefill_chunk=24, kv_block_size=16)
BUDGETS = [8, 6, 7]


def _prompts(vocab):
    rng = np.random.RandomState(5)
    return [[int(t) for t in rng.randint(1, vocab, size=n)]
            for n in (5, 30, 9)]


@pytest.mark.parametrize('family,extra', [
    ('llama', {}), ('gemma', {}), ('qwen2', {}),
    ('gemma', dict(spec_k=3)), ('qwen2', dict(spec_k=3)),
    ('gemma', dict(fuse_budget=8)), ('qwen2', dict(fuse_budget=8))],
    ids=['llama', 'gemma', 'qwen2', 'gemma-spec', 'qwen2-spec',
         'gemma-fused', 'qwen2-fused'])
def test_batcher_greedy_matches_transformers_and_jax(hf_models, saved,
                                                     family, extra):
    """The port's ContinuousBatcher over a converted checkpoint gives
    transformers' greedy continuation and the JAX batcher's, token for
    token (more requests than slots; one prompt chunked), plain, with
    speculative verify (spec_k) and with fused prefill+decode steps."""
    model = _model(hf_models, family)
    tree, cfg = convert.load_hf_model(saved(family, 'sharded', model),
                                      dtype=torch.float32, device='cpu')
    prompts = _prompts(cfg.vocab_size)
    want = []
    with torch.no_grad():
        for p, n in zip(prompts, BUDGETS):
            out = model.generate(torch.tensor([p]), max_new_tokens=n,
                                 do_sample=False, num_beams=1,
                                 eos_token_id=None, pad_token_id=0)
            want.append(out[0, len(p):].tolist())
    assert [len(w) for w in want] == BUDGETS
    jcfg, jp = _jax(model, family, jnp.float32)
    kw = dict(KW, **extra)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jb = j_serving.ContinuousBatcher(jp, jcfg,
                                         j_engine.GeneratorConfig(**kw),
                                         decode_chunk=4)
        j_rids = [jb.submit(p, max_new_tokens=n)
                  for p, n in zip(prompts, BUDGETS)]
        jb.run_until_idle()
    b = ContinuousBatcher(tree, cfg, GeneratorConfig(**kw), decode_chunk=4,
                          device='cpu')
    rids = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)]
    b.run_until_idle()
    got = [b.result(r) for r in rids]
    assert got == want
    assert got == [jb.result(r) for r in j_rids]
    if 'spec_k' in extra:
        assert b.spec_proposed > 0
    if 'fuse_budget' in extra:
        assert b._fuse_policy.stats.steps > 0


# ---- refusals ---------------------------------------------------------------

class SimpleConfig:
    """A config.json dict as attributes (the JAX package reads HF
    configs through getattr)."""

    def __init__(self, fields):
        self.__dict__.update(fields)


_REFUSALS = {
    'rope-yarn': (dict(rope_scaling={'rope_type': 'yarn', 'factor': 4.0}),
                  {}),
    'model-type': (dict(model_type='phi3'), {}),
    'qwen2-sliding': (dict(model_type='qwen2', use_sliding_window=True,
                           sliding_window=128), {}),
    'gemma-activation': (dict(model_type='gemma', hidden_act='relu',
                              hidden_activation=None), {}),
    'mistral-window': (dict(model_type='mistral', sliding_window=512,
                            max_position_embeddings=8192),
                       {'max_seq_len': 2048}),
}


@pytest.mark.parametrize('case', list(_REFUSALS))
def test_refusals_match_jax(case):
    fields, overrides = _REFUSALS[case]
    hf = dict(dict(model_type='llama', vocab_size=64, hidden_size=32,
                   intermediate_size=64, num_hidden_layers=1,
                   num_attention_heads=2, num_key_value_heads=1,
                   max_position_embeddings=1024, rms_norm_eps=1e-5),
              **fields)
    with pytest.raises(NotImplementedError) as want:
        j_convert.config_from_hf(SimpleConfig(hf), **overrides)
    with pytest.raises(NotImplementedError) as got:
        convert.config_from_hf(hf, **overrides)
    assert str(got.value) == str(want.value)


def test_mistral_window_caps_the_context():
    hf = dict(model_type='mistral', vocab_size=64, hidden_size=32,
              intermediate_size=64, num_hidden_layers=1,
              num_attention_heads=2, num_key_value_heads=1,
              max_position_embeddings=8192, sliding_window=512,
              rms_norm_eps=1e-5)
    assert convert.config_from_hf(hf).max_seq_len == 512
    assert convert.config_from_hf(hf, max_seq_len=256).max_seq_len == 256


@pytest.mark.parametrize('where', ['hub-name', 'missing-dir'])
def test_load_takes_local_directories_only(tmp_path, where):
    path = ('meta-llama/Llama-3.1-8B' if where == 'hub-name'
            else str(tmp_path / 'absent'))
    with pytest.raises(FileNotFoundError, match='local'):
        convert.load_hf_model(path, device='cpu')


def test_load_refuses_a_directory_without_weights(tmp_path):
    (tmp_path / 'config.json').write_text(json.dumps(dict(
        model_type='llama', vocab_size=32, hidden_size=16,
        intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
        num_key_value_heads=1, max_position_embeddings=32,
        rms_norm_eps=1e-5)))
    with pytest.raises(FileNotFoundError, match='safetensors'):
        convert.load_hf_model(str(tmp_path), device='cpu')


# ---- the safetensors format ----------------------------------------------

@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_reader_reads_safetensors_package_files_bitwise(tmp_path, dtype):
    """Files written by the safetensors package (its header padding, its
    data_offsets from the end of the header, its __metadata__) read
    bitwise through the port's reader, odd sizes and a 0-d tensor
    included."""
    gen = torch.Generator().manual_seed(0)
    tensors = {name: torch.randn(shape, generator=gen).to(dtype)
               for name, shape in (('a', (3, 5)), ('b.weight', (7,)),
                                   ('c', (2, 3, 4)), ('d', ()),
                                   ('e', (1, 1)))}
    path = str(tmp_path / 'x.safetensors')
    safetensors_torch.save_file(tensors, path, metadata={'format': 'pt'})
    reader = convert._SafetensorsReader([path])
    for name, want in tensors.items():
        got = reader.get(name)
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want), name
    header, start = convert.read_safetensors_header(path)
    assert '__metadata__' not in header and start % 8 == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('family', list(FAMILIES))
def test_chip_smoke_writer_files_read_bitwise(tmp_path, hf_models, family):
    """chip_smoke.py's checkpoint writer: the safetensors package reads
    its shards bitwise, and they hold the names and (out, in) shapes of
    the transformers model of the same config; the port's loader gives
    the tree hf_state_dict_to_params gives from the same tensors."""
    cs = _chip_smoke()
    hf_config = json.loads(
        _model(hf_models, family).config.to_json_string(use_diff=False))
    drawn = {}

    def make(name, shape):
        drawn[name] = cs.draw_hf_tensor(name, shape, 0, torch.bfloat16,
                                        'cpu', gemma=family == 'gemma')
        return drawn[name]
    total = cs.write_hf_checkpoint(str(tmp_path), hf_config, make,
                                   shard_bytes=16 << 10)
    files = sorted(p.name for p in tmp_path.glob('*.safetensors'))
    assert len(files) > 1 and (tmp_path /
                               'model.safetensors.index.json').exists()
    read = {}
    for name in files:
        read.update(safetensors_torch.load_file(str(tmp_path / name)))
    assert set(read) == set(drawn)
    assert all(torch.equal(read[n], drawn[n]) for n in drawn)
    assert total == sum(t.numel() * 2 for t in drawn.values())
    hf_shapes = {n: tuple(t.shape)
                 for n, t in _model(hf_models, family).state_dict().items()
                 if not (n == 'lm_head.weight'
                         and hf_config['tie_word_embeddings'])}
    assert {n: tuple(t.shape) for n, t in drawn.items()} == hf_shapes
    tree, cfg = convert.load_hf_model(str(tmp_path), device='cpu')
    want = convert.hf_state_dict_to_params(
        drawn, cfg, norm_offset=_norm_offset(family), device='cpu')
    for (path, got), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        assert torch.equal(got, w), jax.tree_util.keystr(path)


def test_llama3_70b_preset_matches_jax():
    got = dataclasses.asdict(llama.LLAMA3_70B)
    want = dataclasses.asdict(j_llama.LLAMA3_70B)
    assert got.pop('dtype') == torch.bfloat16
    assert want.pop('dtype') == jnp.bfloat16
    assert got == want
    assert llama.LLAMA3_70B.num_params() == j_llama.LLAMA3_70B.num_params()
