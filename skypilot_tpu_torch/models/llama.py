"""Llama-3-family decoder configuration and parameters.

Counterpart of skypilot_tpu/models/llama.py for the serving path: the
config with a torch dtype, the presets, random initialisation from a
``torch.Generator``, and the conversion of a JAX parameter tree (as
nested dicts of numpy arrays) into this package's tensors.  Parameters
keep the JAX package's layout: one dict, with the per-layer weights
stacked on a leading layer axis.  The training forward and loss come with
the training slice (ROADMAP.md Queue A item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device

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
LLAMA_1B = LlamaConfig(vocab_size=32768, d_model=2048, n_layers=16,
                       n_heads=16, n_kv_heads=8, d_ff=5632, max_seq_len=4096)
LLAMA_DEBUG = LlamaConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
                          n_kv_heads=1, d_ff=512, max_seq_len=512,
                          dtype=torch.float32)


def init_params(config: LlamaConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random stacked-layer parameters (same dict layout and scales as
    the JAX ``init_params``; not the same numbers).

    Values are drawn on `generator`'s device, one layer at a time so the
    f32 draw never holds more than one layer, and stored on `device`
    (default: the CUDA card) in config.dtype."""
    device = resolve_device(device)
    gen_device = generator.device
    d, ff = config.d_model, config.d_ff
    hd, nh, nkv, nl = (config.head_dim, config.n_heads, config.n_kv_heads,
                       config.n_layers)
    dt = config.dtype

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=gen_device,
                        dtype=torch.float32)
        return (x * scale).to(device=device, dtype=dt)

    def dense(*shape):
        out = torch.empty(shape, device=device, dtype=dt)
        for i in range(shape[0]):
            out[i] = normal(shape[1:], shape[-2] ** -0.5)
        return out

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dt)

    attn = {
        'wq': dense(nl, d, nh * hd),
        'wk': dense(nl, d, nkv * hd),
        'wv': dense(nl, d, nkv * hd),
        'wo': dense(nl, nh * hd, d),
    }
    if config.attn_bias:
        attn.update(bq=zeros(nl, nh * hd), bk=zeros(nl, nkv * hd),
                    bv=zeros(nl, nkv * hd))
    return {
        'embed': normal((config.vocab_size, d), 0.02),
        'layers': {
            'ln1': ones(nl, d),
            'ln2': ones(nl, d),
            'attn': attn,
            'mlp': {
                'w_gate': dense(nl, d, ff),
                'w_up': dense(nl, d, ff),
                'w_down': dense(nl, ff, d),
            },
        },
        'final_norm': ones(d),
        'lm_head': normal((d, config.vocab_size), d ** -0.5),
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
        h = h * torch.tensor(config.embed_scale, dtype=h.dtype,
                             device=h.device)
    return h
