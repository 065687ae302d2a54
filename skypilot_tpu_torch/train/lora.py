"""LoRA: low-rank adapter finetuning over the stacked-layer parameter
tree.

Counterpart of skypilot_tpu/train/lora.py.  Adapters are a tree that
mirrors the base parameters: for each targeted linear weight W (.., in,
out) it holds {'a': (.., in, r), 'b': (.., r, out)} with B zero, so
W_eff = W + (alpha / r) * A @ B starts exactly at the base model.

- The trainable tree given to the Trainer is the adapter tree alone, so
  gradients, AdamW moments and checkpoints are adapter-sized.
- The frozen base is closed over by the wrapped loss and never requires
  a gradient.
- ``apply_lora`` materializes W_eff on every call (one weight-sized
  buffer per adapted stack, and its gradient in the backward), and
  leaves the model code untouched.
- Adapters are f32 (the finetune's master weights).  The A @ B product
  is scaled in f32, cast to the base dtype and added in it, as the JAX
  package does.

Targets are regexes over the JAX package's path strings
(``layers/attn/wq``, ...), so one pattern picks the same leaves in both
packages.  A stacked (L, in, out) weight gets (L, in, r) / (L, r, out)
adapters and the product batches over L.

On a training mesh the adapters are replicated (``LORA_RULES``, as the
reference's) and the base is this rank's blocks under the model's rules
(``LLAMA_RULES``/``MOE_RULES``).  ``apply_lora(..., mesh=, rules=)``
cuts each delta to the block: A's rows and B's columns (and any lead
dimension a rule splits) as the base leaf's spec cuts them, so the block
gets W_blk + s * A[rows] @ B[:, cols], the block of GSPMD's W + s * A @
B.  A rank's adapter gradient is then a partial sum over every axis
that splits the leaf: the Trainer adds it over the data axes (dp, fsdp,
sp), and A and B pass through Megatron's f over the others (tp, ep).
``merge_lora(..., mesh=, rules=)`` puts the merged blocks back together
into the whole tree on rank 0, bitwise one card's merge.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train.trainer import DATA_AXES, tree_leaves, tree_map

# Adapters are tiny (rank x (in + out) a target): replicated over the
# mesh, as the reference's LORA_RULES.
LORA_RULES = sharding.PartitionRules([(r'.*', sharding.P())])

# Preset target sets (torchtune's lora.yaml exposes the same choice as
# lora_attn_modules / apply_lora_to_mlp).
TARGET_PRESETS = {
    'attn': r'attn/(wq|wk|wv|wo)$',
    'attn-qv': r'attn/(wq|wv)$',
    'all-linear': r'(attn/(wq|wk|wv|wo)|mlp/(w_gate|w_up|w_down))$',
}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: float = 32.0
    # A TARGET_PRESETS key, or a raw regex over param paths.
    targets: str = 'attn'

    @property
    def target_pattern(self) -> str:
        return TARGET_PRESETS.get(self.targets, self.targets)

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()
                        ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _path_str(path: Tuple[str, ...]) -> str:
    return '/'.join(path)


def _set_nested(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _get_nested(tree: Dict[str, Any], path: Tuple[str, ...]):
    node = tree
    for k in path:
        if not isinstance(node, Mapping) or k not in node:
            return None
        node = node[k]
    return node


def init_lora(params: Any, lora_config: LoraConfig,
              generator: torch.Generator, mesh=None,
              rules: sharding.PartitionRules = sharding.LLAMA_RULES
              ) -> Dict[str, Any]:
    """Adapter tree for every targeted weight, f32 on each weight's
    device.  A ~ N(0, 1/in_dim) (fan-in scaled), drawn on `generator`
    target by target in path order; B = 0, so step 0 is exactly the
    base model.  Under a mesh, params are this rank's blocks under
    `rules` and the adapters are whole (the global leaf's shape), the
    same on every rank and as on one card for the same generator."""
    pattern = re.compile(lora_config.target_pattern)
    flat = list(_flatten_with_paths(params))
    targets = [(path, leaf) for path, leaf in flat
               if pattern.search(_path_str(path))]
    if not targets:
        raise ValueError(
            f'LoRA targets pattern {lora_config.target_pattern!r} '
            f'matched no params (paths: '
            f'{[_path_str(p) for p, _ in flat][:8]}...)')
    out: Dict[str, Any] = {}
    for path, leaf in targets:
        if leaf.ndim < 2:
            raise ValueError(f'LoRA target {_path_str(path)} is not a '
                             f'matrix: shape {tuple(leaf.shape)}')
        shape = tuple(leaf.shape)
        if mesh is not None:
            shape = sharding.global_shape(
                sharding.P(*_leaf_spec(rules, path, leaf.ndim)), shape, mesh)
        lead, (in_dim, out_dim) = shape[:-2], shape[-2:]
        a = torch.randn(lead + (in_dim, lora_config.rank),
                        generator=generator, dtype=torch.float32,
                        device=generator.device) * (in_dim ** -0.5)
        b = torch.zeros(lead + (lora_config.rank, out_dim),
                        dtype=torch.float32, device=leaf.device)
        _set_nested(out, path, {'a': a.to(leaf.device), 'b': b})
    return out


def adapters_from_numpy(tree: Mapping[str, Any], device=None
                        ) -> Dict[str, Any]:
    """An adapter tree of nested dicts of numpy arrays (the JAX tree after
    ``np.asarray``) -> f32 tensors on `device` (default: the CUDA card).
    ``llama.params_from_numpy`` casts to the model dtype and is not for
    adapters."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        arr = np.array(node, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device)

    return convert(tree)


def _leaf_spec(rules, path: Tuple[str, ...], ndim: int) -> tuple:
    spec = tuple(rules.spec_for(_path_str(path)))
    return spec + (None,) * (ndim - len(spec))


def _cut(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of x under spec (a differentiable slice)."""
    return x[tuple(slice(lo, hi) for lo, hi in
                   sharding.block_bounds(sharding.P(*spec), x.shape, mesh))]


def _block_adapters(ad, spec: tuple, mesh):
    """(A, B) cut to the block of a base leaf under `spec`: A's lead
    dims and rows, B's lead dims and columns.  Both first pass through
    Megatron's f over the axes that split the leaf and hold no other
    tokens, whose ranks each add a partial to the adapters' gradient."""
    lead, rows, cols = spec[:-2], spec[-2], spec[-1]
    axes = tuple(a for a in sharding.spec_axes(sharding.P(*spec))
                 if a not in DATA_AXES)
    a, b = (collectives.sum_backward(ad[k], mesh, axes) for k in 'ab')
    return (_cut(a, lead + (rows, None), mesh),
            _cut(b, lead + (None, cols), mesh))


def apply_lora(params: Any, lora: Dict[str, Any],
               lora_config: LoraConfig, mesh=None,
               rules: sharding.PartitionRules = sharding.LLAMA_RULES) -> Any:
    """Effective params: W + (alpha/r) * A @ B for adapted weights, the
    base leaf itself otherwise.  Differentiable in the adapters.  Under
    a mesh, params are this rank's blocks under `rules` and each delta
    is the block's, A[rows] @ B[:, cols]."""
    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        ad = _get_nested(lora, path)
        if ad is None:
            return node
        a, b = ad['a'], ad['b']
        if mesh is not None:
            a, b = _block_adapters(ad, _leaf_spec(rules, path, node.ndim),
                                   mesh)
        delta = torch.matmul(a, b)
        return node + (lora_config.scaling * delta).to(node.dtype)
    return walk(params, ())


@torch.no_grad()
def merge_lora(params: Any, lora: Dict[str, Any],
               lora_config: LoraConfig, mesh=None,
               rules: sharding.PartitionRules = sharding.LLAMA_RULES) -> Any:
    """Merged params for export and serving, outside autograd: new
    tensors for the adapted weights; the other leaves are the base's own
    tensors, detached (no copy).  Under a mesh (params this rank's
    blocks under `rules`) rank 0 returns the whole merged tree on the
    CPU and every other rank None: each delta computed whole, as one
    card computes it, cut to the rank's block and added, and the blocks
    gathered leaf by leaf, which rank 0 alone keeps (bitwise one card's
    merge)."""
    if mesh is None:
        return tree_map(torch.Tensor.detach,
                        apply_lora(params, lora, lora_config))
    lead = mesh.rank == 0

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        spec = _leaf_spec(rules, path, node.ndim)
        ad = _get_nested(lora, path)
        if ad is not None:
            delta = lora_config.scaling * torch.matmul(ad['a'], ad['b'])
            node = node + _cut(delta, spec, mesh).to(node.dtype)
        whole = sharding.gather_tensor(node.detach(), sharding.P(*spec),
                                       mesh)
        return whole.cpu() if lead else None
    merged = walk(params, ())
    return merged if lead else None


def wrap_loss(base_loss_fn, base_params: Any, lora_config: LoraConfig,
              mesh=None,
              rules: sharding.PartitionRules = sharding.LLAMA_RULES):
    """loss(lora, batch) over the ADAPTER tree, for the Trainer: the base
    params ride as closed-over frozen tensors (no gradients, no
    optimizer state, no checkpoint bytes); under a mesh, this rank's
    blocks of them under `rules`."""
    def loss(lora, batch):
        return base_loss_fn(apply_lora(base_params, lora, lora_config,
                                       mesh, rules), batch)
    return loss


def num_params(lora: Dict[str, Any]) -> int:
    return sum(x.numel() for x in tree_leaves(lora))


def split_shapes(lora: Dict[str, Any]) -> Tuple[int, int]:
    """(n_adapters, n_params) for logging."""
    leaves = tree_leaves(lora)
    return len(leaves) // 2, sum(x.numel() for x in leaves)
