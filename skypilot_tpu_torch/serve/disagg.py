"""The transferable KV image of a prefill -> decode handoff.

Counterpart of the codec of skypilot_tpu/serve/disagg.py (its handoff
scheduler and role-aware autoscaler are fleet policy, not ported here):
``encode_kv_image`` frames the per-node component buffers that
``ContinuousBatcher.export_handoff`` produced (whole arena blocks, so
bf16 rows ship as bf16 and int8 rows with their f32 scales), behind a
fixed prologue (magic, version, header and payload lengths, SHA-256 over
header + payload) and a JSON header.  ``decode_kv_image`` refuses a
truncated or corrupted image with a typed error, so the decode replica
falls back to cold prefill instead of decoding from garbage KV.

The same payload gives the same bytes in both packages.  bfloat16 has no
numpy dtype here (no ml_dtypes): a bf16 tensor ships as its raw 16-bit
pattern under the header dtype name ``'bfloat16'``, exactly the bytes an
ml_dtypes array has.  A payload component may be a torch tensor or a
numpy array; a decoded image holds CPU torch tensors.  Pure host bytes:
no pickle, no device work.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

# magic | version | header_len | payload_len | sha256: a fixed-size
# prologue, so a receiver checks lengths before trusting any field.
_MAGIC = b'SKYTPUKV'
_VERSION = 1
_PROLOGUE = struct.Struct('<8sHIQ32s')


class HandoffImageError(ValueError):
    """The byte string is not a valid KV handoff image."""


class CorruptImageError(HandoffImageError):
    """Framing parsed but the content hash does not match: a torn or
    bit-flipped transfer.  The decode replica must fall back to cold
    prefill, never adopt the bytes."""


@dataclasses.dataclass
class KVImage:
    """A decoded handoff image: the prompt tokens the blocks cover and
    one per-component tensor dict per trie node (the export layout,
    ready for ``ContinuousBatcher.ingest_handoff``)."""
    tokens: List[int]
    tokens_per_node: int
    payload: List[Dict[str, torch.Tensor]]

    @property
    def nodes(self) -> int:
        return len(self.payload)


def _dtype_name(buf) -> str:
    if isinstance(buf, torch.Tensor):
        return str(buf.dtype).replace('torch.', '')
    return np.asarray(buf).dtype.name


def _shape(buf) -> List[int]:
    return [int(d) for d in buf.shape]


def _raw_bytes(buf) -> bytes:
    """The C-order bytes of a tensor or an array (a bf16 tensor's raw
    16-bit patterns)."""
    if isinstance(buf, torch.Tensor):
        t = buf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(buf).tobytes()


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise HandoffImageError(f'unknown component dtype {name!r}')
    return dtype


def encode_kv_image(tokens: Sequence[int], tokens_per_node: int,
                    payload: Sequence[Dict[str, Any]]) -> bytes:
    """Frame an ``export_handoff`` payload as a self-contained image:
    prologue + JSON header (tokens, per-node component names, dtypes
    and shapes in sorted order) + the concatenated C-order node
    buffers."""
    if not payload:
        raise HandoffImageError('empty payload — nothing to hand off')
    comps = sorted(payload[0])
    meta = [{'name': c, 'dtype': _dtype_name(payload[0][c]),
             'shape': _shape(payload[0][c])} for c in comps]
    header = json.dumps({
        'tokens': [int(t) for t in tokens],
        'tokens_per_node': int(tokens_per_node),
        'nodes': len(payload),
        'components': meta,
    }, sort_keys=True, separators=(',', ':')).encode('utf-8')
    chunks: List[bytes] = []
    for bufs in payload:
        if sorted(bufs) != comps:
            raise HandoffImageError(
                f'inconsistent components across nodes: '
                f'{sorted(bufs)} vs {comps}')
        for m, c in zip(meta, comps):
            if _shape(bufs[c]) != m['shape'] or \
                    _dtype_name(bufs[c]) != m['dtype']:
                raise HandoffImageError(
                    f'component {c!r} layout varies across nodes')
            chunks.append(_raw_bytes(bufs[c]))
    body = b''.join(chunks)
    digest = hashlib.sha256(header + body).digest()
    return _PROLOGUE.pack(_MAGIC, _VERSION, len(header), len(body),
                          digest) + header + body


def decode_kv_image(data: bytes) -> KVImage:
    """Parse and verify an image produced by ``encode_kv_image`` (by
    either package).  Raises ``HandoffImageError`` on bad framing or
    truncation and ``CorruptImageError`` on a content-hash mismatch."""
    if len(data) < _PROLOGUE.size:
        raise HandoffImageError(
            f'image truncated: {len(data)} bytes < '
            f'{_PROLOGUE.size}-byte prologue')
    magic, version, header_len, payload_len, digest = \
        _PROLOGUE.unpack_from(data)
    if magic != _MAGIC:
        raise HandoffImageError(f'bad magic {magic!r}')
    if version != _VERSION:
        raise HandoffImageError(f'unsupported image version {version}')
    expect = _PROLOGUE.size + header_len + payload_len
    if len(data) != expect:
        raise HandoffImageError(
            f'image truncated: {len(data)} bytes, framed for {expect}')
    header = data[_PROLOGUE.size:_PROLOGUE.size + header_len]
    body = data[_PROLOGUE.size + header_len:]
    if hashlib.sha256(header + body).digest() != digest:
        raise CorruptImageError(
            'KV image content hash mismatch — torn or corrupted '
            'transfer; refusing to adopt')
    try:
        meta = json.loads(header.decode('utf-8'))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise HandoffImageError(f'unreadable image header: {e}') from e
    comps = meta['components']
    node_nbytes = 0
    for m in comps:
        node_nbytes += (int(np.prod(m['shape']))
                        * _torch_dtype(m['dtype']).itemsize)
    if node_nbytes * meta['nodes'] != payload_len:
        raise HandoffImageError(
            f'payload is {payload_len} bytes but header frames '
            f"{meta['nodes']} nodes x {node_nbytes} bytes")
    # One writable copy of the payload; the tensors are views into it.
    buf = bytearray(body)
    payload: List[Dict[str, torch.Tensor]] = []
    off = 0
    for _ in range(meta['nodes']):
        bufs: Dict[str, torch.Tensor] = {}
        for m in comps:
            dtype = _torch_dtype(m['dtype'])
            n = int(np.prod(m['shape']))
            bufs[m['name']] = torch.frombuffer(
                buf, dtype=dtype, count=n, offset=off).reshape(m['shape'])
            off += n * dtype.itemsize
        payload.append(bufs)
    return KVImage(tokens=list(meta['tokens']),
                   tokens_per_node=int(meta['tokens_per_node']),
                   payload=payload)


def image_nbytes(payload: Sequence[Dict[str, Any]]) -> int:
    """Payload byte size without the framing."""
    total = 0
    for bufs in payload:
        for a in bufs.values():
            if isinstance(a, torch.Tensor):
                total += a.numel() * a.element_size()
            else:
                total += np.asarray(a).nbytes
    return total
