"""Token sampling: greedy / temperature / top-k / top-p (nucleus).

Counterpart of skypilot_tpu/infer/sampling.py.  The Gumbel noise comes
from a ``torch.Generator`` on the logits' device, so a sampled token
stream cannot reproduce JAX's PRNG bits: sampled paths agree with the JAX
package in distribution only.  Greedy paths draw no noise.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def gumbel_argmax(logits: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Exact categorical draw via the Gumbel-max trick:
    argmax(logits + G), G ~ Gumbel(0, 1) iid, samples softmax(logits)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + g, dim=-1).to(torch.int32)


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row, mask the rest."""
    kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
    return torch.where(logits >= kth, logits, _NEG_INF)


def _mask_top_p(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted
    distribution whose cumulative probability reaches p (the top token
    always stays).  p: a float or a (B,) tensor (p >= 1 keeps every
    token of that row)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=logits.device)
    if p.dim() == 1:
        p = p[:, None]
    sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, dims=[-1])
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    thresholds = torch.where(keep_sorted, sorted_logits,
                             torch.inf).min(dim=-1, keepdim=True).values
    return torch.where(logits >= thresholds, logits, _NEG_INF)


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """logits (B, vocab) f32 -> token ids (B,) int32.  temperature 0 is
    greedy argmax (no noise drawn); top_k then top_p filter otherwise."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        logits = _mask_top_k(logits, top_k)
    if top_p is not None and 0.0 < top_p < 1.0:
        logits = _mask_top_p(logits, top_p)
    return gumbel_argmax(logits, generator)


def sample_logits_batched(logits: torch.Tensor,
                          generator: Optional[torch.Generator],
                          temperature: torch.Tensor, top_p: torch.Tensor,
                          top_k: Optional[int] = None,
                          nucleus: bool = True) -> torch.Tensor:
    """Per-row sampling params: temperature (B,) f32 (0 = greedy for
    that row), top_p (B,) f32 (>= 1 disables nucleus for that row).
    top_k is one server-wide value; nucleus=False skips the full-vocab
    sort when no row uses top_p."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.clamp_min(temperature, 1e-6)[:, None]
    scaled = logits / t
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        scaled = _mask_top_k(scaled, top_k)
    if nucleus:
        scaled = _mask_top_p(scaled, top_p)
    sampled = gumbel_argmax(scaled, generator)
    return torch.where(temperature <= 0.0, greedy, sampled)
