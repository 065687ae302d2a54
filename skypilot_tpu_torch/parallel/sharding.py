"""Parameter and activation sharding rules.

Counterpart of skypilot_tpu/parallel/sharding.py: ordered (regex,
spec) rules over a parameter tree's '/'-joined paths, first match wins,
replicated by default.  A spec is a :class:`P`, one entry a dimension:
None (whole), an axis name, or a tuple of axis names (the dimension
split over their product, major to minor).  Where the JAX package
device-puts a tree under ``NamedSharding``s, the port slices each
tensor to this rank's block (:func:`shard_tensor`, :func:`shard_params`),
and :func:`gather_params` puts a sharded tree back together as global
numpy arrays (the tests' and the checkpoints' view).  The training
meshes use ``LLAMA_RULES`` and ``MOE_RULES`` as the reference's Trainer
does: a leaf split over 'fsdp' is gathered where it is used (its
gradient reduce-scattered back), over 'tp' or 'ep' it is computed on in
its block.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Sequence, Tuple

import numpy as np


class P(tuple):
    """A partition spec: ``P(None, ('tp', 'tpq'))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f'P{tuple.__repr__(self)}'


class PartitionRules:
    """Ordered (regex, P) rules; the first whose regex is found in a
    path wins; no match replicates."""

    def __init__(self, rules: Sequence[Tuple[str, P]]) -> None:
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path: str) -> P:
        for pat, spec in self._rules:
            if pat.search(path):
                return spec
        return P()

    def tree_specs(self, params) -> Dict[str, Any]:
        """A tree of specs of `params`' shape (nested dicts; the paths
        the reference's ``_key_str`` builds: dict keys joined by '/')."""
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, f'{path}/{k}' if path else str(k))
                        for k, v in node.items()}
            return self.spec_for(path)
        return walk(params, '')


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_bounds(spec: P, shape: Sequence[int], mesh) -> list:
    """This rank's [lo, hi) along each dimension of `shape` under
    `spec` (a spec shorter than the shape leaves the rest whole).  A
    dimension split over axes of total size n is cut into n equal
    blocks; the rank takes the one at its flat index over those axes."""
    bounds = []
    for dim, size in enumerate(shape):
        axes = _entry_axes(spec[dim]) if dim < len(spec) else ()
        n = mesh.axis_size(axes) if axes else 1
        if size % n:
            raise ValueError(f'dimension {dim} of {tuple(shape)} does not '
                             f'divide over {axes} ({n})')
        step = size // n
        lo = mesh.axis_index(axes) * step if axes else 0
        bounds.append((lo, lo + step))
    return bounds


def spec_axes(spec: P) -> Tuple[str, ...]:
    """Every axis name a spec splits a dimension over."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def local_shape(spec: P, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    return tuple(hi - lo for lo, hi in block_bounds(spec, shape, mesh))


def shard_tensor(x, spec: P, mesh):
    """This rank's block of the full tensor `x` under `spec`, as a
    contiguous tensor (the counterpart of ``shard_params``' per-leaf
    device_put; the caller moves it where it lives)."""
    index = tuple(slice(lo, hi) for lo, hi in
                  block_bounds(spec, x.shape, mesh))
    return x[index].contiguous()


def global_shape(spec: P, local: Sequence[int], mesh) -> Tuple[int, ...]:
    """The global shape of a block of shape `local` under `spec`."""
    return tuple(size * (mesh.axis_size(_entry_axes(spec[dim]))
                         if dim < len(spec) and spec[dim] else 1)
                 for dim, size in enumerate(local))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's ``NamedSharding``): where
    this rank's block of a leaf lies, and whether this rank is the one
    owner of that block (its coordinate is 0 on every mesh axis the
    spec does not split over: a replicated block has one owner)."""
    mesh: Any
    spec: P

    def bounds(self, shape: Sequence[int]) -> list:
        return block_bounds(self.spec, shape, self.mesh)

    @property
    def owner(self) -> bool:
        split = set(spec_axes(self.spec))
        return all(c == 0 for a, c in zip(self.mesh.axis_names,
                                          self.mesh.coords)
                   if a not in split)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def shard_params(params, mesh, rules: PartitionRules, device=None):
    """This rank's block of every leaf of a global tree (numpy arrays or
    tensors), as contiguous tensors on `device` (default: the leaf's
    own; numpy goes to the CPU): the reference's device_put under the
    rules' shardings."""
    import torch

    def cut(x, spec):
        t = torch.as_tensor(np.array(x)) if isinstance(x, np.ndarray) \
            else x
        return shard_tensor(t, spec, mesh).to(device or t.device)
    return _tree_map(cut, params, rules.tree_specs(params))


def init_shard(mesh, rules: PartitionRules):
    """The `shard` callback of ``llama.init_params``/``moe.init_params``:
    each drawn slab cut to this rank's block under the rules, so a rank
    stores its blocks and holds at most one drawn slab.  For one seed the
    blocks of all ranks put together are the full init."""
    def shard(path: str, x, lead: int):
        return shard_tensor(x, P(*rules.spec_for(path)[lead:]), mesh)
    return shard


def param_shardings(params, mesh, rules: PartitionRules):
    """A tree of :class:`NamedSharding` of `params`' shape."""
    return _tree_map(lambda s: NamedSharding(mesh, s),
                     rules.tree_specs(params))


def gather_tensor(x, spec: P, mesh):
    """The global tensor of which x is this rank's block under `spec`,
    on every rank (a gather over each split dimension's axes; no
    gradient)."""
    from skypilot_tpu_torch.parallel import collectives
    for dim, entry in enumerate(spec[:x.ndim]):
        axes = _entry_axes(entry)
        if axes and mesh.axis_size(axes) > 1:
            x = collectives.gather_dim(x.contiguous(), mesh, axes, dim)
    return x


def gather_params(params, mesh, rules: PartitionRules):
    """The global tree of a sharded one, as numpy arrays (bf16 leaves
    as f32) on every rank: the inverse of :func:`shard_params`."""
    import torch

    def whole(x, spec):
        x = gather_tensor(x.detach(), spec, mesh).cpu()
        # A copy: a leaf split over no axis of size > 1 comes back as
        # the parameter itself, which the trainer updates in place.
        return np.array((x.float() if x.dtype == torch.bfloat16 else x)
                        .numpy())
    return _tree_map(whole, params, rules.tree_specs(params))


# Megatron-style rules for the Llama tree: tp on the head/ff dimension,
# fsdp on d_model.
LLAMA_RULES = PartitionRules([
    (r'embed', P('tp', 'fsdp')),                 # (vocab, d)
    (r'attn/bq|attn/bk|attn/bv', P(None, 'tp')),  # (L, heads*hd) qwen2
    (r'attn/wq|attn/wk|attn/wv', P(None, 'fsdp', 'tp')),   # (L, d, heads*hd)
    (r'attn/wo', P(None, 'tp', 'fsdp')),         # (L, heads*hd, d)
    (r'mlp/w_gate|mlp/w_up', P(None, 'fsdp', 'tp')),       # (L, d, ff)
    (r'mlp/w_down', P(None, 'tp', 'fsdp')),      # (L, ff, d)
    (r'norm|ln', P()),                           # replicate norms
    (r'lm_head', P('fsdp', 'tp')),               # (d, vocab)
])

# MoE rules: the expert banks shard E over 'ep', d/ff like the dense MLP.
MOE_RULES = PartitionRules([
    (r'embed', P('tp', 'fsdp')),
    (r'attn/wq|attn/wk|attn/wv', P(None, 'fsdp', 'tp')),
    (r'attn/wo', P(None, 'tp', 'fsdp')),
    (r'moe/router', P(None, 'fsdp', None)),       # (L, d, E)
    (r'moe/w_gate|moe/w_up', P(None, 'ep', 'fsdp', 'tp')),  # (L, E, d, ff)
    (r'moe/w_down', P(None, 'ep', 'tp', 'fsdp')),           # (L, E, ff, d)
    (r'norm|ln', P()),
    (r'lm_head', P('fsdp', 'tp')),
])

# Activation specs: tokens shard on batch only; hidden states and
# logits on batch and sequence (and vocab on tp).
BATCH_SPEC = P(('dp', 'fsdp'))                   # tokens (B, S+1)
HIDDEN_SPEC = P(('dp', 'fsdp'), 'sp', None)      # hidden (B, S, d)
LOGITS_SPEC = P(('dp', 'fsdp'), 'sp', 'tp')      # logits (B, S, vocab)
