"""Rotary position embeddings (plain PyTorch: elementwise work).

Counterpart of skypilot_tpu/ops/rope.py, same (B, S, H, D) layout and
f32 math.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch


def _llama3_scale(inv_freq: torch.Tensor,
                  scaling: Dict[str, Any]) -> torch.Tensor:
    """Llama-3.1 'llama3' rope scaling: low frequencies divide by
    `factor`, high frequencies pass through, and the band between
    interpolates smoothly (HF modeling_rope_utils
    _compute_llama3_parameters)."""
    factor = float(scaling['factor'])
    low_freq_factor = float(scaling.get('low_freq_factor', 1.0))
    high_freq_factor = float(scaling.get('high_freq_factor', 4.0))
    old_len = float(scaling.get('original_max_position_embeddings', 8192))
    low_freq_wavelen = old_len / low_freq_factor
    high_freq_wavelen = old_len / high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (old_len / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    interpolated = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(wavelen > low_freq_wavelen, inv_freq / factor,
                       torch.where(wavelen < high_freq_wavelen, inv_freq,
                                   interpolated))


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float = 500000.0,
                     scaling: Optional[Dict[str, Any]] = None,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (max_seq_len, head_dim // 2), f32.

    scaling: an HF-style rope_scaling dict; rope_type 'llama3' is
    implemented, others raise."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if scaling:
        rope_type = scaling.get('rope_type', scaling.get('type', ''))
        if rope_type != 'llama3':
            raise NotImplementedError(
                f'rope_scaling type {rope_type!r} not implemented '
                f"(supported: 'llama3')")
        inv_freq = _llama3_scale(inv_freq, scaling)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (max_seq, D//2); positions: (B, S) or
    None (rows 0..S-1)."""
    seq_len = x.shape[1]
    if positions is None:
        c = cos[:seq_len][None, :, None, :]
        s = sin[:seq_len][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
