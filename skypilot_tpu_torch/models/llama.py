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
forward lives in ``infer/llama_infer.py``.

Under a training mesh (``mesh=``, parallel/mesh.py, one process a rank)
the trunk, ``forward`` and ``loss_fn`` run on this rank's blocks under
``LLAMA_RULES``: each layer gathers its fsdp-split weights inside its
checkpoint region (remat gathers them again rather than keeping them;
the gradient is reduce-scattered back), tp splits the heads and the
feed-forward with Megatron's f/g pair, the embedding lookup and the
cross entropy run on vocabulary blocks over tp, and an sp rank embeds
and scores its S / sp rows, with RoPE at their global positions and
attention over the sp ring (parallel/ring_attention.py).  The loss is
the mean over every token of the global batch, the same on every rank.
``forward_pipelined`` splits the layer stack into GPipe stages over the
'pp' axis (parallel/pipeline.py), each stage composing with all of the
above; every pp rank holds every layer, as the rules give no pp entry,
and embeds and scores its rows itself.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import losses as losses_ops
from skypilot_tpu_torch.ops import rmsnorm as rmsnorm_ops
from skypilot_tpu_torch.ops import rope as rope_ops
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import pipeline as pipeline_lib
from skypilot_tpu_torch.parallel import ring_attention as ring_lib
from skypilot_tpu_torch.parallel import sharding

Params = Dict[str, Any]
# (q, k, v) (B, S, H|KV, hd) -> o (B, S, H, hd): the reference's
# attention_fn hook.
AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                       torch.Tensor]


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


def _take(node, i: int):
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    return node[i]


def layer_params(params: Params, i: int) -> Params:
    """Layer i's weights as views into the stacked tensors.  (A module
    function: a recursive closure would leave a reference cycle behind
    every call.)"""
    return _take(params['layers'], i)


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


class Shards:
    """How a rank's training forward meets its mesh: the mesh, the rules
    that split each leaf, and the rank's place on the tp and sp axes.

    ``weight(path, w, lead)`` is w (this rank's block of leaf `path`,
    less its first `lead` dimensions) with its fsdp-split dimensions
    gathered: the FSDP gather, whose gradient is reduce-scattered back.
    Dimensions over tp or ep stay this rank's blocks."""

    def __init__(self, mesh, rules: sharding.PartitionRules):
        self.mesh, self.rules = mesh, rules
        self.tp, self.tp_index = mesh.axis_size('tp'), mesh.axis_index('tp')
        self.sp, self.sp_index = mesh.axis_size('sp'), mesh.axis_index('sp')
        # The axes over which ranks see different tokens.
        self.data_axes = ('dp', 'fsdp', 'sp')

    def weight(self, path: str, w: torch.Tensor, lead: int = 0
               ) -> torch.Tensor:
        spec = self.rules.spec_for(path)[lead:]
        for dim, entry in enumerate(spec):
            if entry == 'fsdp':
                w = collectives.gather_scatter(w, self.mesh, 'fsdp', dim)
        return w


def embed_tokens(params: Params, tokens: torch.Tensor,
                 config: LlamaConfig,
                 shards: Optional[Shards] = None) -> torch.Tensor:
    """Token embedding lookup and the family's embedding scale (applied
    in the table dtype, as the JAX package does).  Under a mesh the
    table is a (vocab / tp) block: tokens outside it give zero rows and
    the rows are summed over tp (one rank holds each token's row, so the
    sum is exact)."""
    table = (params['embed'] if shards is None
             else shards.weight('embed', params['embed']))
    if shards is None or shards.tp == 1:
        h = table[tokens]
    else:
        rows = table.shape[0]
        local = tokens - shards.tp_index * rows
        valid = (local >= 0) & (local < rows)
        h = torch.where(valid[..., None], table[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        h = collectives.sum_forward(h, shards.mesh, 'tp')
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


def _kv_weights(attn_p: Params, config: LlamaConfig, shards: Shards):
    """wk, wv (and bk, bv) for this rank's query heads under tp: their
    own blocks when the KV heads divide over tp, else gathered over tp
    (gradient reduce-scattered back) and cut to the KV heads this rank's
    query heads map to."""
    names = ['wk', 'wv'] + (['bk', 'bv'] if 'bk' in attn_p else [])
    out = {n: shards.weight(f'layers/attn/{n}', attn_p[n], lead=1)
           for n in names}
    if shards.tp == 1 or config.n_kv_heads % shards.tp == 0:
        return out
    lo, hi = ring_lib.kv_head_block(config.n_heads, config.n_kv_heads,
                                    shards.tp, shards.tp_index)
    hd = config.head_dim
    return {n: collectives.gather_scatter(w, shards.mesh, 'tp', w.ndim - 1)
            [..., lo * hd:hi * hd] for n, w in out.items()}


def attention_block(h: torch.Tensor, layer_params: Params,
                    config: LlamaConfig, cos: torch.Tensor,
                    sin: torch.Tensor,
                    shards: Optional[Shards] = None,
                    attention_fn: Optional[AttentionFn] = None
                    ) -> torch.Tensor:
    """The attention half of a training layer: h + attention(norm(h)),
    through K3 (rms_norm) and K2 (flash_attention, causal), or
    attention_fn(q, k, v) when given.  Under a mesh: this rank's query
    heads and their KV heads, attention over the sp ring when sp > 1,
    and the output projection's partial sums added over tp (cos/sin are
    the rows of this rank's positions)."""
    batch, seq, _ = h.shape
    hd = config.head_dim
    attn_p = layer_params['attn']

    x = rmsnorm_ops.rms_norm(h, layer_params['ln1'], eps=config.norm_eps)
    if shards is None:
        w = attn_p
    else:
        x = collectives.sum_backward(x, shards.mesh, 'tp')
        w = dict(_kv_weights(attn_p, config, shards),
                 wq=shards.weight('layers/attn/wq', attn_p['wq'], lead=1),
                 wo=shards.weight('layers/attn/wo', attn_p['wo'], lead=1))
        if 'bq' in attn_p:
            w['bq'] = attn_p['bq']
    q, k, v = x @ w['wq'], x @ w['wk'], x @ w['wv']
    if 'bq' in w:  # Qwen2-family qkv biases (config.attn_bias)
        q, k, v = q + w['bq'], k + w['bk'], v + w['bv']
    q = q.reshape(batch, seq, -1, hd)
    k = k.reshape(batch, seq, -1, hd)
    v = v.reshape(batch, seq, -1, hd)
    q = rope_ops.apply_rope(q, cos, sin)
    k = rope_ops.apply_rope(k, cos, sin)
    if shards is not None and shards.sp > 1:
        o = ring_lib.ring_attention_manual(q, k, v, mesh=shards.mesh,
                                           axis_name='sp', causal=True)
    elif attention_fn is not None:
        o = attention_fn(q, k, v)
    else:
        o = attention_ops.flash_attention(q, k, v, causal=True)
    out = o.reshape(batch, seq, -1) @ w['wo']
    if shards is not None:
        out = collectives.sum_forward(out, shards.mesh, 'tp')
    return h + out


def _layer(h: torch.Tensor, layer_params: Params, *, config: LlamaConfig,
           cos: torch.Tensor, sin: torch.Tensor,
           shards: Optional[Shards] = None,
           attention_fn: Optional[AttentionFn] = None) -> torch.Tensor:
    mlp_p = layer_params['mlp']
    h = attention_block(h, layer_params, config, cos, sin, shards,
                        attention_fn)
    x = rmsnorm_ops.rms_norm(h, layer_params['ln2'], eps=config.norm_eps)
    if shards is not None:
        x = collectives.sum_backward(x, shards.mesh, 'tp')
        mlp_p = {k: shards.weight(f'layers/mlp/{k}', w, lead=1)
                 for k, w in mlp_p.items()}
    gate = gate_activation(x @ mlp_p['w_gate'], config.mlp_act)
    out = (gate * (x @ mlp_p['w_up'])) @ mlp_p['w_down']
    if shards is not None:
        out = collectives.sum_forward(out, shards.mesh, 'tp')
    return h + out


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


def rank_rope(config: LlamaConfig, seq_local: int, device,
              shards: Optional[Shards] = None):
    """(cos, sin) for this rank's positions: rows 0..S-1, or under sp
    the rows of the rank's block, sp_index * S_local onwards."""
    sp, index = (1, 0) if shards is None else (shards.sp, shards.sp_index)
    cos, sin = rope_ops.rope_frequencies(
        config.head_dim, seq_local * sp, config.rope_theta,
        scaling=config.rope_scaling_dict, device=device)
    start = index * seq_local
    return cos[start:start + seq_local], sin[start:start + seq_local]


def hidden_states(params: Params, tokens: torch.Tensor,
                  config: LlamaConfig, mesh=None,
                  rules: sharding.PartitionRules = sharding.LLAMA_RULES
                  ) -> torch.Tensor:
    """tokens (B, S) int -> post-final-norm hidden states (B, S, d): the
    pre-head trunk of forward(), which loss_fn consumes directly when the
    cross entropy is chunked (config.loss_chunk).  Under a mesh, tokens
    are this rank's rows (its sequence block under sp) and params its
    blocks under `rules`."""
    shards = None if mesh is None else Shards(mesh, rules)
    return _trunk(params, tokens, config, shards)


def _run_layers(h: torch.Tensor, layers: Params, n_layers: int,
                layer_fn, config: LlamaConfig) -> torch.Tensor:
    """h through the n stacked layers of `layers`, each checkpointed
    under config.remat."""
    context_fn = _remat_policy(config) if config.remat else None
    for lp in unbind_layers({'layers': layers}, n_layers):
        if config.remat:
            h = checkpoint_lib.checkpoint(layer_fn, h, lp,
                                          use_reentrant=False,
                                          context_fn=context_fn)
        else:
            h = layer_fn(h, lp)
    return h


def _trunk(params: Params, tokens: torch.Tensor, config: LlamaConfig,
           shards: Optional[Shards]) -> torch.Tensor:
    cos, sin = rank_rope(config, tokens.shape[1], tokens.device, shards)
    h = embed_tokens(params, tokens, config, shards)
    layer_fn = functools.partial(_layer, config=config, cos=cos, sin=sin,
                                 shards=shards)
    h = _run_layers(h, params['layers'], config.n_layers, layer_fn, config)
    return rmsnorm_ops.rms_norm(h, params['final_norm'],
                                eps=config.norm_eps)


def forward(params: Params, tokens: torch.Tensor,
            config: LlamaConfig, mesh=None,
            rules: sharding.PartitionRules = sharding.LLAMA_RULES
            ) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) f32; under a mesh this
    rank's rows and vocabulary block (B, S, vocab / tp)."""
    if mesh is None:
        return (hidden_states(params, tokens, config)
                @ params['lm_head']).float()
    shards = Shards(mesh, rules)
    h, head = head_block(_trunk(params, tokens, config, shards), params,
                         shards)
    return (h @ head).float()


def forward_pipelined(params: Params, tokens: torch.Tensor,
                      config: LlamaConfig, *, mesh, num_microbatches: int,
                      attention_fn: Optional[AttentionFn] = None,
                      sequence_axis: Optional[str] = None
                      ) -> torch.Tensor:
    """forward() with the layer stack split into GPipe stages over the
    mesh's 'pp' axis (parallel/pipeline.py; embed and head replicated
    over the stages): tokens (B, S) -> logits (B, S, vocab) f32, under
    the mesh this rank's rows and vocabulary block as forward() gives
    them, every stage composing with dp, fsdp and tp under LLAMA_RULES.

    sequence_axis: the pp x sp composition ('sp').  tokens are then
    this rank's sequence block, the stages attend over the sp ring
    (ring_attention_manual) and RoPE takes the block's global
    positions, sp_index * S_local onwards.  A mesh with sp > 1 needs
    it, as the reference's manual region does."""
    if sequence_axis not in (None, 'sp'):
        raise ValueError(f"sequence_axis must be None or 'sp', got "
                         f'{sequence_axis!r}')
    shards = Shards(mesh, sharding.LLAMA_RULES)
    if shards.sp > 1 and sequence_axis is None:
        raise ValueError(f"a mesh with sp={shards.sp} pipelines with "
                         f"sequence_axis='sp'")
    num_stages = mesh.axis_size('pp')
    per_stage = config.n_layers // num_stages
    cos, sin = rank_rope(config, tokens.shape[1], tokens.device, shards)
    h = embed_tokens(params, tokens, config, shards)
    layer_fn = functools.partial(_layer, config=config, cos=cos, sin=sin,
                                 shards=shards, attention_fn=attention_fn)

    def stage_fn(stage_layers, h_mb):
        return _run_layers(h_mb, stage_layers, per_stage, layer_fn, config)

    stage_params = pipeline_lib.stack_stages(params['layers'], num_stages)
    h = pipeline_lib.pipeline_apply(stage_fn, stage_params, h, mesh=mesh,
                                    num_microbatches=num_microbatches)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    h, head = head_block(h, params, shards)
    return (h @ head).float()


def head_block(h: torch.Tensor, params: Params, shards: Shards):
    """(h, this rank's lm_head block with its fsdp rows gathered): h
    passes through Megatron's f over tp, whose ranks hold the head's
    vocabulary blocks."""
    return (collectives.sum_backward(h, shards.mesh, 'tp'),
            shards.weight('lm_head', params['lm_head']))


def rank_tokens(tokens: torch.Tensor, shards: Optional[Shards]):
    """(inputs, targets) of this rank: tokens[:, :-1] and tokens[:, 1:],
    under sp the rank's block of S / sp rows of each."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if shards is not None and shards.sp > 1:
        seq = inputs.shape[1]
        if seq % shards.sp:
            raise ValueError(f'sequence {seq} does not divide over '
                             f'sp={shards.sp}')
        n = seq // shards.sp
        lo = shards.sp_index * n
        inputs, targets = inputs[:, lo:lo + n], targets[:, lo:lo + n]
    return inputs, targets


def rank_logprobs(params: Params, tokens: torch.Tensor,
                  config: LlamaConfig, mesh,
                  rules: sharding.PartitionRules = sharding.LLAMA_RULES
                  ) -> torch.Tensor:
    """log p of this rank's targets, (B, S_local) f32 (the same on every
    tp rank): tokens (B, S + 1) are the rank's batch rows, of which it
    scores its sequence block."""
    shards = Shards(mesh, rules)
    inputs, targets = rank_tokens(tokens, shards)
    h, head = head_block(_trunk(params, inputs, config, shards), params,
                         shards)
    if config.loss_chunk:
        return losses_ops.chunked_token_logprobs(
            h, head, targets, chunk_size=config.loss_chunk, mesh=mesh)
    return losses_ops.token_logprobs_from_hidden(h, head, targets, mesh)


def mesh_mean(local_sum: torch.Tensor, count: int, mesh,
              axes=('dp', 'fsdp', 'sp')) -> torch.Tensor:
    """A mean over the global batch from each rank's sum over its
    `count` tokens: the sums added in rank order over the data axes
    (the gradient of each rank's sum is the mean's), over count x the
    axes' size."""
    total = collectives.sum_forward(local_sum, mesh, axes)
    return total / (count * mesh.axis_size(axes))


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig, mesh=None,
            rules: sharding.PartitionRules = sharding.LLAMA_RULES,
            forward_fn: Optional[Callable[..., torch.Tensor]] = None
            ) -> torch.Tensor:
    """Next-token cross entropy.  batch: {'tokens': (B, S)}; the model
    predicts tokens[:, 1:] from tokens[:, :-1].  Under a mesh, batch
    holds this rank's rows (the Trainer splits the batch over dp and
    fsdp) and the loss is the global batch's mean on every rank.
    forward_fn(params, tokens, config) -> logits replaces forward (the
    reference's hook: ``functools.partial(forward_pipelined, mesh=...,
    num_microbatches=...)``); under a mesh it takes this rank's rows
    and sequence block and returns its vocabulary block."""
    tokens = batch['tokens']
    if forward_fn is not None:
        if mesh is None:
            logits = forward_fn(params, tokens[:, :-1], config)
            return -torch.mean(token_logprobs(logits, tokens[:, 1:]))
        inputs, targets = rank_tokens(tokens, Shards(mesh, rules))
        lp = losses_ops.vocab_parallel_logprobs(
            forward_fn(params, inputs, config), targets, mesh)
        return -mesh_mean(lp.sum(), lp.numel(), mesh)
    if mesh is not None:
        lp = rank_logprobs(params, tokens, config, mesh, rules)
        return -mesh_mean(lp.sum(), lp.numel(), mesh)
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
