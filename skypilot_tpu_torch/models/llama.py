"""Llama-3-family decoder: configuration, parameters, and the training
forward and loss.

Counterpart of skypilot_tpu/models/llama.py: the config with a torch
dtype, the presets, random initialisation from a ``torch.Generator``, the
conversion of a JAX parameter tree (as nested dicts of numpy arrays) into
this package's tensors, and ``hidden_states``/``forward``/``loss_fn`` for
training.  Parameters keep the JAX package's layout: one dict, with the
per-layer weights stacked on a leading layer axis.  The JAX ``lax.scan``
over layers is a Python loop over ``torch.unbind`` views of the stacked
leaves; ``jax.checkpoint`` around each layer is
``torch.utils.checkpoint`` (non-reentrant), with ``remat_policy='dots'``
as selective checkpointing that saves the 2-D projections.  The serving
forward lives in ``infer/llama_infer.py``; ``forward_pipelined`` waits for
the mesh slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import losses as losses_ops
from skypilot_tpu_torch.ops import rmsnorm as rmsnorm_ops
from skypilot_tpu_torch.ops import rope as rope_ops

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    # HF-style rope_scaling dict stored as a tuple of items (hashable);
    # rope_type 'llama3' is implemented (ops/rope.py).  None = unscaled.
    rope_scaling: Optional[tuple] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Training: checkpoint each layer (recompute its activations in the
    # backward); remat_policy 'dots' saves the projections' outputs and
    # recomputes the rest; loss_chunk computes the CE in sequence chunks
    # (ops/losses.py) so the full (B, S, vocab) logits never exist.
    remat: bool = True
    remat_policy: Optional[str] = None
    loss_chunk: Optional[int] = None
    # Family knobs: Gemma's gelu-tanh MLP, sqrt(d) embedding scale and
    # decoupled head_dim; Qwen2's q/k/v biases.
    mlp_act: str = 'silu'                  # 'silu' | 'gelu_tanh'
    embed_scale: float = 1.0
    head_dim_override: Optional[int] = None
    attn_bias: bool = False

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.d_model // self.n_heads

    @property
    def rope_scaling_dict(self) -> Optional[Dict[str, Any]]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    def num_params(self) -> int:
        d, ff, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 + \
            d * self.n_kv_heads * self.head_dim * 2
        if self.attn_bias:
            attn += self.n_heads * self.head_dim + \
                2 * self.n_kv_heads * self.head_dim
        mlp = 3 * d * ff
        return v * d * 2 + l * (attn + mlp + 2 * d) + d


# Presets (sizes match the public Llama-3 family).
LLAMA3_8B = LlamaConfig()
LLAMA3_70B = LlamaConfig(d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                         d_ff=28672)
LLAMA_1B = LlamaConfig(vocab_size=32768, d_model=2048, n_layers=16,
                       n_heads=16, n_kv_heads=8, d_ff=5632, max_seq_len=4096)
LLAMA_DEBUG = LlamaConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
                          n_kv_heads=1, d_ff=512, max_seq_len=512,
                          dtype=torch.float32, remat=False)


def init_params(config: LlamaConfig, generator: torch.Generator,
                device=None, *, ffn=None, shard=None) -> Params:
    """Random stacked-layer parameters (same dict layout and scales as
    the JAX ``init_params``; not the same numbers).

    Values are drawn on `generator`'s device, one layer at a time so the
    f32 draw never holds more than one layer, and stored on `device`
    (default: the CUDA card) in config.dtype.  `ffn(dense)` returns the
    layers' feed-forward entry as (key, subtree) from the stacked
    initializer ``dense(path, *shape)`` (scale shape[-2] ** -0.5); the
    default is the gated MLP, ('mlp', ...), and models/moe.py passes its
    expert bank.  `shard(path, x, lead)` (infer/tp.py's
    init_sharded_params) cuts each drawn tensor to one rank's block
    before it is stored; `lead` counts x's leading axes that the leaf's
    spec has and x does not (1 for one layer of a stacked leaf)."""
    device = resolve_device(device)
    gen_device = generator.device
    d, ff = config.d_model, config.d_ff
    hd, nh, nkv, nl = (config.head_dim, config.n_heads, config.n_kv_heads,
                       config.n_layers)
    dt = config.dtype

    def cut(path, x, lead):
        return x if shard is None else shard(path, x, lead)

    def normal(path, shape, scale, lead=0):
        x = torch.randn(shape, generator=generator, device=gen_device,
                        dtype=torch.float32)
        return cut(path, x.mul_(scale), lead).to(device=device, dtype=dt)

    def dense(path, *shape):
        out = None
        for i in range(shape[0]):
            layer = normal(path, shape[1:], shape[-2] ** -0.5, lead=1)
            if out is None:
                out = torch.empty((shape[0],) + tuple(layer.shape),
                                  device=device, dtype=dt)
            out[i] = layer
        return out

    def ones(path, *shape):
        return cut(path, torch.ones(shape, device=device, dtype=dt), 0)

    def zeros(path, *shape):
        return cut(path, torch.zeros(shape, device=device, dtype=dt), 0)

    attn = {
        'wq': dense('layers/attn/wq', nl, d, nh * hd),
        'wk': dense('layers/attn/wk', nl, d, nkv * hd),
        'wv': dense('layers/attn/wv', nl, d, nkv * hd),
        'wo': dense('layers/attn/wo', nl, nh * hd, d),
    }
    if config.attn_bias:
        attn.update(bq=zeros('layers/attn/bq', nl, nh * hd),
                    bk=zeros('layers/attn/bk', nl, nkv * hd),
                    bv=zeros('layers/attn/bv', nl, nkv * hd))
    if ffn is None:
        def ffn(dense):
            return 'mlp', {'w_gate': dense('layers/mlp/w_gate', nl, d, ff),
                           'w_up': dense('layers/mlp/w_up', nl, d, ff),
                           'w_down': dense('layers/mlp/w_down', nl, ff, d)}
    # The embedding is drawn before the ffn: a seed's draw order is kept.
    embed = normal('embed', (config.vocab_size, d), 0.02)
    ffn_key, ffn_tree = ffn(dense)
    return {
        'embed': embed,
        'layers': {
            'ln1': ones('layers/ln1', nl, d),
            'ln2': ones('layers/ln2', nl, d),
            'attn': attn,
            ffn_key: ffn_tree,
        },
        'final_norm': ones('final_norm', d),
        'lm_head': normal('lm_head', (d, config.vocab_size), d ** -0.5),
    }


def params_from_numpy(tree: Mapping[str, Any], config: LlamaConfig,
                      device=None) -> Params:
    """A parameter tree of nested dicts of numpy arrays (for example the
    JAX tree after ``np.asarray(x, np.float32)`` on every leaf: numpy
    has no bfloat16 that torch takes) -> this package's tensors in
    config.dtype on `device`.  bf16 -> f32 -> bf16 is lossless."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        arr = np.array(node, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=device, dtype=config.dtype)

    return convert(tree)


def layer_params(params: Params, i: int) -> Params:
    """Layer i's weights as views into the stacked tensors."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(params['layers'])


def gate_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Gated-MLP activation in f32 (silu for Llama/Mistral, tanh-gelu
    for Gemma), cast back to the compute dtype."""
    xf = x.float()
    if kind == 'silu':
        out = torch.nn.functional.silu(xf)
    elif kind == 'gelu_tanh':
        out = torch.nn.functional.gelu(xf, approximate='tanh')
    else:
        raise ValueError(f'Unknown mlp_act {kind!r}')
    return out.to(x.dtype)


def embed_tokens(params: Params, tokens: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """Token embedding lookup and the family's embedding scale (applied
    in the table dtype, as the JAX package does)."""
    h = params['embed'][tokens]
    if config.embed_scale != 1.0:
        h = h * torch.full((), config.embed_scale, dtype=h.dtype,
                           device=h.device)
    return h


# The 2-D products that jax.checkpoint_policies.dots_with_no_batch_dims_
# saveable keeps: every `x @ W` projection reaches aten as mm (addmm with
# a bias).  Attention's products (inside the kernels, or batched on the
# CPU) and all elementwise work are recomputed.
_SAVED_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]

_REMAT_POLICIES = {
    None: lambda: checkpoint_lib.noop_context_fn,
    'dots': lambda: functools.partial(
        checkpoint_lib.create_selective_checkpoint_contexts, _SAVED_DOTS),
}


def _remat_policy(config: LlamaConfig):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for the policy."""
    if config.remat_policy not in _REMAT_POLICIES:
        raise ValueError(
            f'Unknown remat_policy {config.remat_policy!r}; '
            f'valid values: {sorted(_REMAT_POLICIES, key=repr)}')
    return _REMAT_POLICIES[config.remat_policy]()


def attention_block(h: torch.Tensor, layer_params: Params,
                    config: LlamaConfig, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """The attention half of a training layer: h + attention(norm(h)),
    through K3 (rms_norm) and K2 (flash_attention, causal)."""
    batch, seq, _ = h.shape
    hd, nh, nkv = config.head_dim, config.n_heads, config.n_kv_heads
    attn_p = layer_params['attn']

    x = rmsnorm_ops.rms_norm(h, layer_params['ln1'], eps=config.norm_eps)
    q, k, v = x @ attn_p['wq'], x @ attn_p['wk'], x @ attn_p['wv']
    if 'bq' in attn_p:  # Qwen2-family qkv biases (config.attn_bias)
        q, k, v = (q + attn_p['bq'], k + attn_p['bk'],
                   v + attn_p['bv'])
    q = q.reshape(batch, seq, nh, hd)
    k = k.reshape(batch, seq, nkv, hd)
    v = v.reshape(batch, seq, nkv, hd)
    q = rope_ops.apply_rope(q, cos, sin)
    k = rope_ops.apply_rope(k, cos, sin)
    o = attention_ops.flash_attention(q, k, v, causal=True)
    return h + (o.reshape(batch, seq, nh * hd) @ attn_p['wo'])


def _layer(h: torch.Tensor, layer_params: Params, *, config: LlamaConfig,
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    mlp_p = layer_params['mlp']
    h = attention_block(h, layer_params, config, cos, sin)
    x = rmsnorm_ops.rms_norm(h, layer_params['ln2'], eps=config.norm_eps)
    gate = gate_activation(x @ mlp_p['w_gate'], config.mlp_act)
    h = h + ((gate * (x @ mlp_p['w_up'])) @ mlp_p['w_down'])
    return h


def unbind_layers(params: Params, n_layers: int) -> List[Params]:
    """Per-layer weight dicts as views of the stacked leaves, one
    ``torch.unbind`` per leaf: its backward is one ``stack`` per leaf,
    where indexing each layer would zero-fill the whole stacked leaf once
    per layer."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return torch.unbind(node, 0)

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    views = split(params['layers'])
    return [take(views, i) for i in range(n_layers)]


def hidden_states(params: Params, tokens: torch.Tensor,
                  config: LlamaConfig) -> torch.Tensor:
    """tokens (B, S) int -> post-final-norm hidden states (B, S, d): the
    pre-head trunk of forward(), which loss_fn consumes directly when the
    cross entropy is chunked (config.loss_chunk)."""
    cos, sin = rope_ops.rope_frequencies(
        config.head_dim, tokens.shape[1], config.rope_theta,
        scaling=config.rope_scaling_dict, device=tokens.device)
    h = embed_tokens(params, tokens, config)
    layer_fn = functools.partial(_layer, config=config, cos=cos, sin=sin)
    context_fn = _remat_policy(config) if config.remat else None
    for lp in unbind_layers(params, config.n_layers):
        if config.remat:
            h = checkpoint_lib.checkpoint(layer_fn, h, lp,
                                          use_reentrant=False,
                                          context_fn=context_fn)
        else:
            h = layer_fn(h, lp)
    return rmsnorm_ops.rms_norm(h, params['final_norm'],
                                eps=config.norm_eps)


def forward(params: Params, tokens: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) f32."""
    h = hidden_states(params, tokens, config)
    return (h @ params['lm_head']).float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy.  batch: {'tokens': (B, S)}; the model
    predicts tokens[:, 1:] from tokens[:, :-1]."""
    tokens = batch['tokens']
    if config.loss_chunk:
        h = hidden_states(params, tokens[:, :-1], config)
        return losses_ops.chunked_softmax_xent(
            h, params['lm_head'], tokens[:, 1:],
            chunk_size=config.loss_chunk)
    logits = forward(params, tokens[:, :-1], config)
    return -torch.mean(token_logprobs(logits, tokens[:, 1:]))


# log p(targets) from logits, (..., S) f32: the JAX package's
# llama.token_logprobs, the one implementation in ops/losses.py.
token_logprobs = losses_ops.token_logprobs
