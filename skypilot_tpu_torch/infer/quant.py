"""Matrix products of the inference path and the int8 weight-only scheme.

Counterpart of skypilot_tpu/infer/quant.py: each linear weight W
(.., in, out) may be served as {'q': int8, 's': f32 per-out-channel}
with s = absmax(W[..., :, c]) / 127, so q * s ~= W.  The product is
(x @ q) * s: x @ q kept in f32 (as the reference's dot_general with
preferred_element_type=f32), the scale applied in f32 to the small
result, then one cast.  Embeddings and norms stay in the model dtype.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import torch

# Linear weights streamed in full every decode step (the JAX package's
# _QUANT_PATH over the same parameter tree).
_QUANT_PATH = re.compile(
    r'(attn/(wq|wk|wv|wo)|mlp/(w_gate|w_up|w_down)|lm_head)$')


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and 'q' in w and 's' in w


def quantize_array(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(.., in, out) weight -> {'q': int8, 's': f32 per-out-channel}.
    A stacked (L, in, out) weight is quantized one layer at a time, so
    the f32 copy never holds more than one layer."""
    if w.dim() == 3:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32,
                        device=w.device)
        for i in range(w.shape[0]):
            layer = quantize_array(w[i])
            q[i], s[i] = layer['q'], layer['s']
        return {'q': q, 's': s}
    a = w.float()
    s = torch.clamp_min(a.abs().amax(dim=-2) / 127.0, 1e-12)
    q = torch.clamp(torch.round(a / s[..., None, :]), -127, 127)
    return {'q': q.to(torch.int8), 's': s}


def quantize_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a llama-family parameter tree with every linear weight
    quantized (the JAX package's quantize_weights); other leaves are
    shared, not copied."""
    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, f'{path}/{k}' if path else k)
                    for k, v in node.items()}
        return quantize_array(node) if _QUANT_PATH.search(path) else node
    return convert(params, '')


def _int8_product(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x @ q for an int8 (in, out) q, in f32 and never rounded to x's
    dtype: each term (a bf16 or f32 value times an int8) is exact in f32
    and the sum is taken in f32.  On the card a bf16 x multiplies a bf16
    copy of q with an f32 result (torch.mm's out_dtype), so the weight
    stream stays bf16; on the CPU, whose mm has no out_dtype, both sides
    go to f32."""
    if x.dtype == torch.float32 or x.device.type == 'cpu':
        return x.float() @ q.float()
    y = torch.mm(x.reshape(-1, x.shape[-1]), q.to(x.dtype),
                 out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], q.shape[-1])


def matmul(x: torch.Tensor, w: Any, out_dtype=None) -> torch.Tensor:
    """x @ w for a plain weight or a quantized {'q', 's'} one, cast to
    out_dtype when given (else x's dtype).  A plain large product: it
    stays torch.matmul, as the JAX package left it to XLA."""
    if is_quantized(w):
        y = _int8_product(x, w['q']) * w['s'].float()
        return y.to(out_dtype or x.dtype)
    y = x @ w
    return y.to(out_dtype) if out_dtype is not None else y
