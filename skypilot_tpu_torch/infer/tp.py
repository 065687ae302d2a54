"""Tensor-parallel sharding for the serving engines.

Counterpart of skypilot_tpu/infer/tp.py.  The JAX package serves a
model larger than one chip by running the same jitted functions over
megatron-sharded operands on a ('tp', 'tpq') mesh, and GSPMD inserts
the psums.  The port runs one process a rank (parallel/mesh.py): each
rank holds only its block of every weight and of the KV arena, and
``infer/llama_infer.py`` calls the combines explicitly where GSPMD puts
them:

- wq/wk/wv split on the head output axis and wo on its input axis:
  each rank attends with its own heads, one combine after wo;
- w_gate/w_up split on ff and w_down on its input: one combine after
  w_down (the same for every expert of a Mixtral bank, whose tiny
  router is replicated);
- embed split on d_model (each rank looks its tokens up in its column
  block; a gather over d rebuilds the rows) and lm_head on the vocab (a
  gather of the logits before sampling);
- the KV arena on the kv-head axis.

A combine is a gather and a local sum in flat mesh-rank order
(parallel/collectives.py), so every rank holds bitwise the same hidden
states and logits, whatever the backend: the sampled tokens the host
reads are the same on every rank (the reference's ``replicate``
contract).

'tpq' is the GQA OVERSHARD axis: when tp exceeds the KV heads, query
heads, MLP and vocab split over tp x tpq while each KV head (and its
arena block) is replicated over the tpq subgroup; rank (i, j) holds the
query heads of KV group i.  Under a 'dp' axis (outermost) the weights
and the arena are replicated over dp and the pooled steps split their
slot rows over it (``slot_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel.sharding import (P, PartitionRules,
                                                  shard_tensor)

MODEL_AXES = ('tp', 'tpq')

INFER_TP_RULES = PartitionRules([
    (r'embed', P(None, ('tp', 'tpq'))),                 # (vocab, d)
    (r'attn/bk|attn/bv', P(None, 'tp')),                # (L, kv*hd) qwen2
    (r'attn/bq', P(None, ('tp', 'tpq'))),               # (L, heads*hd)
    (r'attn/wk|attn/wv', P(None, None, 'tp')),          # (L, d, kv*hd)
    (r'attn/wq', P(None, None, ('tp', 'tpq'))),         # (L, d, heads*hd)
    (r'attn/wo', P(None, ('tp', 'tpq'), None)),         # (L, heads*hd, d)
    (r'mlp/w_gate|mlp/w_up', P(None, None, ('tp', 'tpq'))),  # (L, d, ff)
    (r'mlp/w_down', P(None, ('tp', 'tpq'), None)),      # (L, ff, d)
    # Every expert ff-sharded as the dense MLP; the router replicated.
    (r'moe/router', P()),                               # (L, d, E)
    (r'moe/w_gate|moe/w_up', P(None, None, None, ('tp', 'tpq'))),
    (r'moe/w_down', P(None, None, ('tp', 'tpq'), None)),
    (r'norm|ln', P()),
    (r'lm_head', P(None, ('tp', 'tpq'))),               # (d, vocab)
])

# Arena (L, num_blocks, block_size, KV, hd) and contiguous cache (L, B,
# S, KV, hd): the kv-head axis on 'tp', replicated over 'tpq' and 'dp'.
CACHE_SPEC = P(None, None, None, 'tp', None)
CACHE_SCALE_SPEC = P(None, None, None, 'tp')     # int8 scales (.., KV)
POOL_ARENA_SPEC = CACHE_SPEC
POOL_ARENA_SCALE_SPEC = CACHE_SCALE_SPEC
# Block tables and the rest of the host allocator's state: whole on
# every rank (block ids index the arena's unsharded block axis).
TABLE_SPEC = P()


def tp_factors(config, tp: int) -> Tuple[int, int]:
    """(tp_kv, tp_q): the KV-head sharding degree and the GQA overshard
    degree, tp = tp_kv * tp_q."""
    tp_kv = min(tp, config.n_kv_heads)
    return tp_kv, tp // max(tp_kv, 1)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def dp_degree(mesh) -> int:
    """Size of the mesh's 'dp' axis (1 without one, or without a mesh)."""
    if mesh is None:
        return 1
    return mesh.shape.get('dp', 1)


def model_size(mesh) -> int:
    """Ranks a model is split over: tp x tpq."""
    return 1 if mesh is None else mesh.axis_size(
        tuple(a for a in MODEL_AXES if a in mesh.axis_names))


def validate_tp(config, tp: int) -> None:
    """Fail at construction when the model's axes do not divide over tp."""
    problems = []
    tp_kv, tp_q = tp_factors(config, tp)
    if tp_kv * tp_q != tp or config.n_kv_heads % tp_kv:
        problems.append(f'n_kv_heads={config.n_kv_heads} (tp must be a '
                        f'multiple or divisor of it)')
    if config.n_heads % tp:
        problems.append(f'n_heads={config.n_heads}')
    if config.d_ff % tp:
        problems.append(f'd_ff={config.d_ff}')
    if config.d_model % tp:
        problems.append(f'd_model={config.d_model}')
    if config.vocab_size % tp:
        problems.append(f'vocab_size={config.vocab_size}')
    if problems:
        raise ValueError(
            f'Model axes not divisible by tp={tp}: '
            + ', '.join(problems))


def validate_mesh(config, mesh) -> None:
    """After dividing out 'dp', the 'tp' axis must equal the model's KV
    sharding degree."""
    sizes = mesh_axis_sizes(mesh)
    dp = sizes.get('dp', 1)
    tp_total = mesh.size // max(dp, 1)
    validate_tp(config, tp_total)
    tp_kv, _ = tp_factors(config, tp_total)
    if sizes.get('tp') != tp_kv:
        raise ValueError(
            f'mesh tp axis {sizes} '
            f'does not match the model: need tp={tp_kv} x tpq='
            f'{tp_total // tp_kv} for n_kv_heads={config.n_kv_heads} — '
            f'build the mesh with make_tp_mesh(tp, n_kv_heads=...)')


def _tp_mesh_from_ranks(ranks: Sequence[int], tp: int,
                        n_kv_heads: Optional[int], dp: int = 1,
                        rank: Optional[int] = None):
    import numpy as np
    tp_kv = min(tp, n_kv_heads) if n_kv_heads else tp
    if tp % max(tp_kv, 1):
        raise ValueError(f'tp={tp} not a multiple of tp_kv={tp_kv}')
    tp_q = tp // max(tp_kv, 1)
    if dp <= 1:
        return mesh_lib.Mesh(
            np.asarray(ranks[:tp]).reshape(tp_kv, tp_q), ('tp', 'tpq'),
            rank=rank)
    # dp outermost: each replica is a contiguous block of tp ranks.
    return mesh_lib.Mesh(
        np.asarray(ranks[:dp * tp]).reshape(dp, tp_kv, tp_q),
        ('dp', 'tp', 'tpq'), rank=rank)


def make_tp_mesh(tp: int, n_kv_heads: Optional[int] = None, ranks=None,
                 dp: int = 1, rank: Optional[int] = None):
    """('tp', 'tpq') mesh, or ('dp', 'tp', 'tpq') when dp > 1, over the
    world's first dp * tp ranks (or `ranks`).  n_kv_heads: the model's
    KV heads; tp beyond them goes to the 'tpq' overshard axis.  Every
    rank of the world must call it (group creation is collective), and
    the world must hold exactly dp * tp ranks."""
    import torch.distributed as dist
    if ranks is None:
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        ranks = list(range(world))
    ranks = mesh_lib.ici_order(list(ranks))
    if len(ranks) != dp * tp:
        raise ValueError(
            f'dp={dp} x tp={tp} needs {dp * tp} ranks, the world has '
            f'{len(ranks)}')
    return _tp_mesh_from_ranks(ranks, tp, n_kv_heads, dp=dp, rank=rank)


def param_spec(path: str) -> P:
    """The spec of a leaf at `path`; an int8 weight's 'q' takes its
    weight's spec, and its per-out-channel 's' that spec without the
    input axis (whole where the input axis is split)."""
    if path.endswith('/q'):
        return INFER_TP_RULES.spec_for(path[:-2])
    if path.endswith('/s'):
        spec = INFER_TP_RULES.spec_for(path[:-2])
        if len(spec) >= 2:
            return P(*(tuple(spec[:-2]) + (spec[-1],)))
        return spec
    return INFER_TP_RULES.spec_for(path)


def shard_params(params, mesh, device=None) -> Dict[str, Any]:
    """This rank's blocks of a full parameter tree under INFER_TP_RULES,
    on `device` (default: where each leaf is).  An int8 tree
    (quant.quantize_weights of the FULL tree) keeps its full-column
    scales where the input axis is split: a shard's absmax would not be
    the column's."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f'{path}/{k}' if path else str(k))
                    for k, v in node.items()}
        out = shard_tensor(node, param_spec(path), mesh)
        return out if device is None else out.to(device)
    return walk(params, '')


def init_sharded_params(config, generator: torch.Generator, mesh,
                        device=None, init=None) -> Dict[str, Any]:
    """Random parameters drawn directly into this rank's blocks: the
    draws of ``llama.init_params`` (``moe.init_params`` for a MoeConfig)
    in their order on `generator`, each layer's slab sliced to the
    rank's block before it is stored, so a rank holds its shard and at
    most one drawn slab, never the model.  For the same seed the blocks
    of all ranks put together are the full init."""
    from skypilot_tpu_torch.models import llama, moe
    if init is None:
        init = moe.init_params if hasattr(config, 'n_experts') else \
            llama.init_params

    def shard(path: str, x: torch.Tensor, lead: int) -> torch.Tensor:
        spec = param_spec(path)
        return shard_tensor(x, P(*spec[lead:]), mesh)
    return init(config, generator, device, shard=shard)


def local_config(config, mesh):
    """The config of one rank's attention block: its query and KV heads
    (head_dim pinned), for the arena and the prefill scratch caches."""
    if mesh is None:
        return config
    n_model = model_size(mesh)
    tp_kv = mesh.shape.get('tp', 1)
    return dataclasses.replace(
        config, n_heads=config.n_heads // n_model,
        n_kv_heads=config.n_kv_heads // tp_kv,
        head_dim_override=config.head_dim)


def slot_rows(mesh, batch: int) -> Tuple[int, int]:
    """[lo, hi): the slot rows this rank's dp replica decodes (all of
    them without a dp axis)."""
    dp = dp_degree(mesh)
    if dp == 1:
        return 0, batch
    if batch % dp:
        raise ValueError(f'batch_size={batch} does not divide over '
                         f'dp={dp}')
    per = batch // dp
    lo = mesh.axis_index('dp') * per
    return lo, lo + per

