"""Matrix products of the inference path.

Counterpart of skypilot_tpu/infer/quant.py.  This slice serves weights in
the model dtype; the int8 weight-only scheme (``{'q', 's'}`` weights)
comes with ROADMAP.md Queue A item 7.
"""
from __future__ import annotations

from typing import Any

import torch


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and 'q' in w and 's' in w


def matmul(x: torch.Tensor, w: Any, out_dtype=None) -> torch.Tensor:
    """x @ w for a plain weight, cast to out_dtype when given.  A plain
    large product: it stays torch.matmul, as the JAX package left it to
    XLA."""
    if is_quantized(w):
        raise NotImplementedError(
            'int8 weights ({"q", "s"}) are not ported yet: ROADMAP.md '
            'Queue A item 7')
    y = x @ w
    return y.to(out_dtype) if out_dtype is not None else y
