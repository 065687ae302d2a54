"""Parameter and activation sharding rules.

Counterpart of skypilot_tpu/parallel/sharding.py: ordered (regex,
spec) rules over a parameter tree's '/'-joined paths, first match wins,
replicated by default.  A spec is a :class:`P`, one entry a dimension:
None (whole), an axis name, or a tuple of axis names (the dimension
split over their product, major to minor).  Where the JAX package
device-puts a tree under ``NamedSharding``s, the port slices each
tensor to this rank's block (:func:`shard_tensor`); the training users
of ``LLAMA_RULES`` and ``MOE_RULES`` come with the port's training
meshes.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple


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


def local_shape(spec: P, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    return tuple(hi - lo for lo, hi in block_bounds(spec, shape, mesh))


def shard_tensor(x, spec: P, mesh):
    """This rank's block of the full tensor `x` under `spec`, as a
    contiguous tensor (the counterpart of ``shard_params``' per-leaf
    device_put; the caller moves it where it lives)."""
    index = tuple(slice(lo, hi) for lo, hi in
                  block_bounds(spec, x.shape, mesh))
    return x[index].contiguous()


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
