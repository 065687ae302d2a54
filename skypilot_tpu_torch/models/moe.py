"""Mixture-of-Experts decoder (Mixtral-style): the expert bank that takes
the place of the Llama MLP.

Counterpart of skypilot_tpu/models/moe.py: the config, the parameter
tree (a 'moe' subtree of router (L, d, E) and expert banks (L, E, d, ff)
/ (L, E, ff, d) in place of 'mlp'), GShard top-k gating with per-expert
capacity ('capacity', the training formulation: overflowing tokens are
dropped), the exact dropless top-k block ('dense': every expert computes
every token, the serving and checkpoint-parity formulation), and the
training trunk and loss.  Attention, norms and rope are the Llama
layer's (``llama.attention_block``: K2, K3).  The expert products are
batched matrix products over the stored banks, as the JAX package's are
einsums outside any kernel; each is written as ``bmm``/``matmul`` over
the (E, d, ff) and (E, ff, d) banks as they are stored, so no product
copies a permuted bank (a decode step streams the banks once).  One-hot
rows are comparisons against an ``arange``: a dropped token's slot
index past the capacity gives an all-zero row, as ``jax.nn.one_hot``
does, and nothing reads a device value on the host, so the dense block
runs inside a captured CUDA graph.

Under a training mesh (``mesh=``, ``MOE_RULES``) a rank holds E / ep
experts of each bank.  Every rank routes its tokens over all E experts
(the router gathered over fsdp), so both routers keep their dispatch,
combine and capacity; the rank runs its experts on the dispatch and
combine sliced to them (the combine's gradient gathered back over ep).
Under sp the 'capacity' router ranks a token's slot along the whole
sequence: each k-iteration adds the expert counts of the sp ranks
before this one (an exclusive prefix over sp), and the next starts
from the global fill; the capacity is the global sequence's.  A slot
holds one token and the expert FFN works row by row, so a rank runs its
own tokens' slots and the others' stay zero.
The expert outputs are added over tp (which splits each expert's ff)
before the combine, and the combined ones over ep, in rank order.  The
aux loss's fractions are taken over the global batch, so it is the
single card's value on every rank.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import losses as losses_ops
from skypilot_tpu_torch.ops import rmsnorm as rmsnorm_ops
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import sharding

Params = llama.Params


@dataclasses.dataclass(frozen=True)
class MoeConfig(llama.LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # 'capacity': GShard dispatch with per-expert capacity (tokens past
    # it are dropped; the training formulation).  'dense': exact dropless
    # top-k, every expert computes every token and the combine weights
    # zero the unchosen (E / top_k x the expert FLOPs; the serving and
    # evaluation formulation, and what infer/ runs).
    router_impl: str = 'capacity'

    def num_params(self) -> int:
        d, ff, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 + \
            d * self.n_kv_heads * self.head_dim * 2
        moe = self.n_experts * 3 * d * ff + d * self.n_experts
        return v * d * 2 + l * (attn + moe + 2 * d) + d


MOE_DEBUG = MoeConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=256, max_seq_len=512,
                      n_experts=4, top_k=2, dtype=torch.float32, remat=False)


def init_params(config: MoeConfig, generator: torch.Generator,
                device=None, *, shard=None) -> Params:
    """Random stacked-layer parameters in the JAX tree layout and scales
    (not the same numbers): the Llama tree with a 'moe' subtree in place
    of 'mlp', each leaf drawn one layer at a time in f32 and stored in
    config.dtype (the dense MLP is never drawn)."""
    d, ff, nl, ne = (config.d_model, config.d_ff, config.n_layers,
                     config.n_experts)

    def bank(dense):
        return 'moe', {'router': dense('layers/moe/router', nl, d, ne),
                       'w_gate': dense('layers/moe/w_gate', nl, ne, d, ff),
                       'w_up': dense('layers/moe/w_up', nl, ne, d, ff),
                       'w_down': dense('layers/moe/w_down', nl, ne, ff, d)}
    return llama.init_params(config, generator, device, ffn=bank,
                             shard=shard)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows of `idx` over n classes; an index outside [0, n)
    gives a row of zeros (jax.nn.one_hot's rule)."""
    classes = torch.arange(n, device=idx.device, dtype=idx.dtype)
    return (idx.unsqueeze(-1) == classes).float()


def _load_balance(gates: torch.Tensor, n_experts: int,
                  shards=None) -> torch.Tensor:
    """Switch/GShard aux loss on top-1 assignments: E * sum_e(fraction of
    tokens routed to e * mean gate of e).  Under a mesh the fractions
    are the global batch's: each rank's sums over its tokens, added over
    the data axes."""
    tokens = _one_hot(gates.argmax(-1), n_experts)
    if shards is None:
        frac_tokens = tokens.mean(dim=(0, 1))
        frac_gates = gates.mean(dim=(0, 1))
    else:
        count = gates.shape[0] * gates.shape[1]
        frac_tokens = llama.mesh_mean(tokens.sum(dim=(0, 1)), count,
                                      shards.mesh, shards.data_axes)
        frac_gates = llama.mesh_mean(gates.sum(dim=(0, 1)), count,
                                     shards.mesh, shards.data_axes)
    return n_experts * (frac_tokens * frac_gates).sum()


def top_k_gating(router_logits: torch.Tensor, top_k: int, capacity: int,
                 shards=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """router_logits (B, S, E) -> (dispatch (B, S, E, C) f32 0/1, combine
    (B, S, E, C) f32, aux_loss f32 scalar).  GShard top-k with a
    per-batch-row capacity: a token's slot in an expert is its rank
    along the sequence among the tokens routed there, after the slots
    taken by earlier choices; a token past the capacity is dropped (its
    combine weight is zero: the residual carries it).  Choices are taken
    by argmax, first index on ties, as jnp.argmax.  Under sp (shards)
    the rows are this rank's sequence block and the ranks are counted
    along the whole sequence."""
    gates = torch.softmax(router_logits.float(), dim=-1)
    batch, _, n_experts = gates.shape
    aux_loss = _load_balance(gates, n_experts, shards)

    slots = torch.arange(capacity, device=gates.device, dtype=torch.float32)
    dispatch = combine = 0.0
    remaining = gates.detach()       # argmax only: no gradient through it
    position_in_expert = torch.zeros((batch, n_experts), device=gates.device)
    for _ in range(top_k):
        onehot = _one_hot(remaining.argmax(-1), n_experts)      # (B, S, E)
        gate_k = (gates * onehot).sum(-1)                       # (B, S)
        prior = onehot.cumsum(1) - onehot
        before, fill = _sp_counts(onehot.sum(1), shards)
        pos = (prior * onehot).sum(-1) + \
            ((position_in_expert + before)[:, None, :] * onehot).sum(-1)
        position_in_expert = position_in_expert + fill
        # pos >= capacity matches no slot: the all-zero row of a drop.
        pos_oh = (pos.unsqueeze(-1) == slots).float()           # (B, S, C)
        part = onehot.unsqueeze(-1) * pos_oh.unsqueeze(-2)
        dispatch = dispatch + part
        combine = combine + gate_k[..., None, None] * part
        remaining = remaining * (1.0 - onehot)
    # Renormalize the combine weights over the k chosen experts.
    denom = combine.sum(dim=(-2, -1), keepdim=True)
    combine = combine / torch.clamp_min(denom, 1e-9)
    return dispatch, combine, aux_loss


def _sp_counts(counts: torch.Tensor, shards):
    """(the counts of the sp ranks before this one, the counts of all)
    of each row's tokens an expert, (B, E): whole numbers in f32, so
    their sums are exact in any order.  Without sp: (0, counts)."""
    if shards is None or shards.sp == 1:
        return 0.0, counts
    every = collectives.all_gather(counts, shards.mesh, 'sp')
    before = (collectives.rank_order_sum(every[:shards.sp_index])
              if shards.sp_index else torch.zeros_like(counts))
    return before, collectives.rank_order_sum(every)


def _expert_weights(moe_params: Params, shards):
    """The router and this rank's expert banks, fsdp dims gathered."""
    if shards is None:
        return moe_params
    return {k: shards.weight(f'layers/moe/{k}', w, lead=1)
            for k, w in moe_params.items()}


def _local_experts(x: torch.Tensor, combine: torch.Tensor, shards,
                   dim: int):
    """x for the rank's experts (its gradient, partial over ep and tp,
    added back) and the combine weights sliced to them along `dim`."""
    if shards is None:
        return x, combine
    mesh = shards.mesh
    return (collectives.sum_backward(x, mesh, ('ep', 'tp')),
            collectives.split_gather(combine, mesh, 'ep', dim))


def moe_block_dense(x: torch.Tensor, moe_params: Params, config: MoeConfig,
                    shards=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dropless top-k: x (B, S, d) -> (y (B, S, d), aux_loss).

    Softmax over all experts, the top_k chosen renormalized to sum to 1
    (HF Mixtral's routing), every expert run on every token with fixed
    shapes, the unchosen zeroed by the combine.  Decode streams every
    bank regardless once batch x top_k covers the experts, so the extra
    FLOPs cost the weight-bound step nothing."""
    batch, seq, d = x.shape
    n_experts = config.n_experts
    moe_params = _expert_weights(moe_params, shards)
    gates = torch.softmax((x @ moe_params['router']).float(), dim=-1)
    top_w, top_idx = torch.topk(gates, config.top_k, dim=-1)   # (B, S, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    combine = (_one_hot(top_idx, n_experts)
               * top_w.unsqueeze(-1)).sum(-2)                   # (B, S, E)
    x_e, combine = _local_experts(x, combine, shards, 2)
    n_local = combine.shape[-1]
    # 'bsd,edf->ebsf' as one (E,)-batched product over the stored banks:
    # x is broadcast across the experts, no bank is copied.
    xs = x_e.reshape(1, batch * seq, d)
    up = torch.matmul(xs, moe_params['w_up'])                  # (E, BS, ff)
    gate = llama.gate_activation(torch.matmul(xs, moe_params['w_gate']),
                                 config.mlp_act)
    expert_out = _sum_over(torch.bmm(gate * up, moe_params['w_down']),
                           shards, 'tp')                       # (E, BS, d)
    # 'bse,ebsd->bsd': a (1, E) x (E, d) product per token.
    y = torch.bmm(combine.to(x.dtype).reshape(batch * seq, 1, n_local),
                  expert_out.transpose(0, 1)).reshape(batch, seq, d)
    return _sum_over(y, shards, 'ep'), _load_balance(gates, n_experts,
                                                      shards)


def _sum_over(x: torch.Tensor, shards, axis: str) -> torch.Tensor:
    """x added over `axis` in rank order (Megatron's g): the expert
    outputs over tp, whose ranks split each expert's ff, before the
    combine weighs them; the combined outputs over ep."""
    if shards is None:
        return x
    return collectives.sum_forward(x, shards.mesh, axis)


def moe_block(x: torch.Tensor, moe_params: Params, config: MoeConfig,
              shards=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss) under config.router_impl;
    under a mesh (shards: llama.Shards) over this rank's experts."""
    if config.router_impl == 'dense':
        return moe_block_dense(x, moe_params, config, shards)
    if config.router_impl != 'capacity':
        raise ValueError(
            f"router_impl must be 'capacity' or 'dense', "
            f'got {config.router_impl!r}')
    batch, seq, d = x.shape
    n_experts = config.n_experts
    moe_params = _expert_weights(moe_params, shards)
    # From the global sequence: under sp each rank holds S / sp rows.
    seq_all = seq * (1 if shards is None else shards.sp)
    capacity = max(1, int(config.top_k * seq_all * config.capacity_factor /
                          n_experts))
    dispatch, combine, aux = top_k_gating(x @ moe_params['router'],
                                          config.top_k, capacity, shards)
    x, combine = _local_experts(x, combine, shards, 2)
    if shards is not None:
        n_experts = combine.shape[2]
        lo = shards.mesh.axis_index('ep') * n_experts
        dispatch = dispatch[:, :, lo:lo + n_experts]
    slots = n_experts * capacity
    # Dispatch 'bsec,bsd->ebcd': (E C, S) x (S, d) per batch row.
    expert_in = torch.bmm(
        dispatch.to(x.dtype).reshape(batch, seq, slots).transpose(1, 2), x)
    expert_in = expert_in.reshape(batch, n_experts, capacity, d).transpose(
        0, 1).reshape(n_experts, batch * capacity, d)
    gate = torch.nn.functional.silu(
        torch.bmm(expert_in, moe_params['w_gate']).float()).to(x.dtype)
    up = torch.bmm(expert_in, moe_params['w_up'])
    expert_out = _sum_over(torch.bmm(gate * up, moe_params['w_down']),
                           shards, 'tp')                      # (E, B C, d)
    # Combine 'bsec,ebcd->bsd': (S, E C) x (E C, d) per batch row.
    expert_out = expert_out.reshape(n_experts, batch, capacity, d).transpose(
        0, 1).reshape(batch, slots, d)
    y = torch.bmm(combine.to(x.dtype).reshape(batch, seq, slots), expert_out)
    return _sum_over(y, shards, 'ep'), aux


def _layer(h: torch.Tensor, aux_acc: torch.Tensor, layer_params: Params, *,
           config: MoeConfig, cos: torch.Tensor, sin: torch.Tensor,
           shards=None) -> Tuple[torch.Tensor, torch.Tensor]:
    h = llama.attention_block(h, layer_params, config, cos, sin, shards)
    x = rmsnorm_ops.rms_norm(h, layer_params['ln2'], eps=config.norm_eps)
    y, aux = moe_block(x, layer_params['moe'], config, shards)
    return h + y, aux_acc + aux


def hidden_states(params: Params, tokens: torch.Tensor, config: MoeConfig,
                  mesh=None,
                  rules: sharding.PartitionRules = sharding.MOE_RULES
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (post-final-norm hidden states (B, S, d), the
    router aux loss averaged over the layers), so the blockwise CE of SFT
    can apply the head chunk-wise.  config.remat checkpoints each layer
    with no policy (the JAX package's ``jax.checkpoint`` of the layer;
    config.remat_policy does not apply here).  Under a mesh, tokens are
    this rank's rows and params its blocks under `rules`."""
    shards = None if mesh is None else llama.Shards(mesh, rules)
    return _trunk(params, tokens, config, shards)


def _trunk(params: Params, tokens: torch.Tensor, config: MoeConfig, shards
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    cos, sin = llama.rank_rope(config, tokens.shape[1], tokens.device,
                               shards)
    h = llama.embed_tokens(params, tokens, config, shards)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layer_fn = functools.partial(_layer, config=config, cos=cos, sin=sin,
                                 shards=shards)
    for lp in llama.unbind_layers(params, config.n_layers):
        if config.remat:
            h, aux = checkpoint_lib.checkpoint(layer_fn, h, aux, lp,
                                               use_reentrant=False)
        else:
            h, aux = layer_fn(h, aux, lp)
    h = rmsnorm_ops.rms_norm(h, params['final_norm'], eps=config.norm_eps)
    return h, aux / config.n_layers


def forward(params: Params, tokens: torch.Tensor, config: MoeConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, vocab) f32, aux_loss)."""
    h, aux = hidden_states(params, tokens, config)
    return (h @ params['lm_head']).float(), aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: MoeConfig, mesh=None,
            rules: sharding.PartitionRules = sharding.MOE_RULES
            ) -> torch.Tensor:
    """Next-token cross entropy over the full logits plus
    router_aux_weight x the router aux loss.  batch: {'tokens': (B, S)};
    under a mesh this rank's rows, and the loss the global batch's on
    every rank (the head's vocabulary blocks over tp)."""
    tokens = batch['tokens']
    if mesh is not None:
        shards = llama.Shards(mesh, rules)
        inputs, targets = llama.rank_tokens(tokens, shards)
        h, aux = _trunk(params, inputs, config, shards)
        lp = losses_ops.token_logprobs_from_hidden(
            *llama.head_block(h, params, shards), targets, mesh)
        return (-llama.mesh_mean(lp.sum(), lp.numel(), mesh)
                + config.router_aux_weight * aux)
    logits, aux = forward(params, tokens[:, :-1], config)
    ll = llama.token_logprobs(logits, tokens[:, 1:])
    return -torch.mean(ll) + config.router_aux_weight * aux
