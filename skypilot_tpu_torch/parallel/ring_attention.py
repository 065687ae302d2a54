"""Ring attention: exact attention over a sequence-parallel mesh axis.

Counterpart of skypilot_tpu/parallel/ring_attention.py.  Each rank holds
a contiguous sequence block of q, k and v; the k/v blocks travel round
the 'sp' ring (``collectives.ring_permute``: rank i sends to i + 1)
while each rank accumulates its partial attention with the online-
softmax merge, so the (S, S) scores never exist.  The blocks are f32
products in plain torch, as the JAX package computes them with einsums
outside any kernel.  The backward is autograd's through the products,
the merges and the permutes (each permute's transpose is the inverse
hop).

The port has no ``shard_map``: every rank is a process already holding
its blocks, so :func:`ring_attention_manual` (the per-rank body) is what
the model calls, and :func:`ring_attention` takes the reference's global
(B, S, H, D) arrays, cuts this rank's blocks under the reference's
specs and returns this rank's block of the output.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel import sharding

_NEG_INF = -1e30


def _block_attend(q, k, v, q_offset: int, k_offset: int, causal: bool):
    """Partial attention of local q against one k/v block.

    q: (B, Sq, H, D); k/v: (B, Sk, H, D).  Returns (m, l, acc): m, l
    (B, H, Sq, 1) f32; acc (B, H, Sq, D) f32."""
    seq_q, seq_k = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(seq_q, device=q.device)[:, None]
        kpos = k_offset + torch.arange(seq_k, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None, None], s, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    # Fully masked rows: make their contribution exactly zero.
    p = torch.where(m <= _NEG_INF / 2, 0.0, p)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum('bhqk,bkhd->bhqd', p, v.float())
    return m, l, acc


def _merge(m1, l1, acc1, m2, l2, acc2):
    """Merge two online-softmax partials."""
    m = torch.maximum(m1, m2)
    # Guard exp(-inf - -inf): where a side is empty its l is 0 anyway.
    c1 = torch.exp(torch.clamp_min(m1 - m, _NEG_INF))
    c2 = torch.exp(torch.clamp_min(m2 - m, _NEG_INF))
    return m, l1 * c1 + l2 * c2, acc1 * c1 + acc2 * c2


def _ring_attention_local(q, k, v, *, mesh, axis_name: str, causal: bool):
    """Per-rank body.  q (B, S_local, H, D); k/v (B, S_local, KV, D)
    whose KV heads serve q's heads in order (GQA repeat)."""
    axis_size = mesh.axis_size(axis_name)
    my_idx = mesh.axis_index(axis_name)
    batch, seq_local, heads, hd = q.shape
    num_kv = k.shape[2]
    if num_kv != heads:
        k = torch.repeat_interleave(k, heads // num_kv, dim=2)
        v = torch.repeat_interleave(v, heads // num_kv, dim=2)
    q_offset = my_idx * seq_local
    m = torch.full((batch, heads, seq_local, 1), _NEG_INF,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros((batch, heads, seq_local, 1), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((batch, heads, seq_local, hd), dtype=torch.float32,
                      device=q.device)
    kc, vc = k, v
    for t in range(axis_size):
        # At step t this rank holds the block of rank (my_idx - t).
        src = (my_idx - t) % axis_size
        m, l, acc = _merge(m, l, acc, *_block_attend(
            q, kc, vc, q_offset, src * seq_local, causal))
        if t + 1 < axis_size:   # the reference's last hop is never read
            kc = collectives.ring_permute(kc, mesh, axis_name)
            vc = collectives.ring_permute(vc, mesh, axis_name)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention_manual(q, k, v, *, mesh, axis_name: str = 'sp',
                          causal: bool = True):
    """Ring attention on this rank's sequence blocks (B, S_local, H, D),
    k/v holding the KV heads of q's heads: the model's call, and the
    reference's for callers already inside a manual region."""
    return _ring_attention_local(q, k, v, mesh=mesh, axis_name=axis_name,
                                 causal=causal)


def kv_head_block(n_heads: int, n_kv: int, tp: int,
                  tp_index: int) -> Tuple[int, int]:
    """[lo, hi) of the KV heads that the query heads of tp block
    `tp_index` attend to: their own block when KV divides over tp, else
    the heads their groups map to (the KV heads are replicated over tp,
    and each rank takes those its query heads need)."""
    if n_kv % tp == 0:
        per = n_kv // tp
        return tp_index * per, (tp_index + 1) * per
    if n_heads % tp:
        raise ValueError(f'{n_heads} heads do not divide over tp={tp}')
    group = n_heads // n_kv
    per_q = n_heads // tp
    lo = tp_index * per_q // group
    hi = ((tp_index + 1) * per_q - 1) // group + 1
    if per_q % (hi - lo):
        raise ValueError(f'{per_q} query heads a rank do not split evenly '
                         f'over their {hi - lo} KV heads (H={n_heads}, '
                         f'KV={n_kv}, tp={tp})')
    return lo, hi


def ring_attention(q, k, v, mesh, *, axis_name: str = 'sp',
                   causal: bool = True,
                   batch_axes: Sequence[str] = ('dp', 'fsdp'),
                   head_axis: Optional[str] = 'tp'):
    """Exact attention of the global (B, S, H, D) q and (B, S, KV, D)
    k/v (the same on every rank) with the sequence over `axis_name`,
    batch over `batch_axes` and heads over `head_axis`.  Returns this
    rank's block of the output, P(batch_axes, axis_name, head_axis).

    KV heads that do not divide over head_axis are replicated over it,
    as in the reference; each rank then attends with the KV heads its
    query heads map to (the reference's repeat pairs a rank's query
    heads with the first KV heads instead when a rank's heads span
    fewer KV heads than it holds)."""
    batch_axes = tuple(batch_axes)
    spec_q = sharding.P(batch_axes, axis_name, head_axis, None)
    spec_kv = sharding.P(batch_axes, axis_name, None, None)
    q_l = sharding.shard_tensor(q, spec_q, mesh)
    k_l = sharding.shard_tensor(k, spec_kv, mesh)
    v_l = sharding.shard_tensor(v, spec_kv, mesh)
    if head_axis is not None and mesh.axis_size(head_axis) > 1:
        lo, hi = kv_head_block(q.shape[2], k.shape[2],
                               mesh.axis_size(head_axis),
                               mesh.axis_index(head_axis))
        k_l, v_l = k_l[:, :, lo:hi], v_l[:, :, lo:hi]
    return ring_attention_manual(q_l, k_l, v_l, mesh=mesh,
                                 axis_name=axis_name, causal=causal)
