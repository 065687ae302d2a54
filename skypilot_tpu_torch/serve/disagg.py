"""Disaggregated prefill/decode serving: pool roles, the handoff
scheduler, the role-aware autoscaler, and the transferable KV image of a
prefill -> decode handoff.

Counterpart of skypilot_tpu/serve/disagg.py.

- **Roles** (`ROLE_PREFILL` / `ROLE_DECODE`): a prefill replica admits
  cold long prompts, prefills them, ships the request's KV blocks to a
  decode replica and forgets them (release-after-export).
- **HandoffScheduler**: picks the decode replica for an exported image
  on the same consistent-hash ring routing uses
  (`serve/traffic/hashring.py`); the exclusion set keeps an image from
  going back to its producer or to another prefill replica.
- **RoleAwareSLOAutoscaler**: each pool scales on its own signal —
  prefill on cold-prompt TTFT, decode on TPOT samples against
  ``target_p99_tpot_ms`` — through two `SLOAutoscaler`s.
- **KV image**: ``encode_kv_image`` frames the per-node component buffers that
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
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from skypilot_tpu_torch.serve.autoscalers import (AutoscalerDecision,
                                                  SLOAutoscaler)
from skypilot_tpu_torch.serve.traffic.hashring import (ConsistentHashRing,
                                                       DEFAULT_VNODES,
                                                       stable_hash)

ROLE_PREFILL = 'prefill'
ROLE_DECODE = 'decode'

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
    return np.asarray(buf).dtype.name  # a host array; skytpu-allow: SKY105


def _shape(buf) -> List[int]:
    return [int(d) for d in buf.shape]


def _raw_bytes(buf) -> bytes:
    """The C-order bytes of a tensor or an array (a bf16 tensor's raw
    16-bit patterns)."""
    if isinstance(buf, torch.Tensor):
        # The image leaves the card by design.
        t = buf.detach().cpu().contiguous()  # skytpu-allow: SKY105
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()  # host tensor; skytpu-allow: SKY105
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
                total += np.asarray(a).nbytes  # host; skytpu-allow: SKY105
    return total


class HandoffScheduler:
    """Chooses the decode replica that receives an exported KV image.

    Ring placement matches routing's prefix affinity: the image lands
    where future requests sharing the prompt head will hash, so the
    adopted host entries get follow-on hits instead of evicting cold.
    Prefill members join the ring (their arcs keep key placement
    stable as pools resize) but are never handoff targets — the
    exclusion set covers the whole prefill pool plus the exporter, and
    the owner walk's each-member-at-most-once contract makes the walk
    terminate even when the exclusions cover the entire ring."""

    def __init__(self, vnodes: int = DEFAULT_VNODES) -> None:
        self._ring = ConsistentHashRing(vnodes=vnodes)
        self._roles: Dict[str, str] = {}

    @property
    def roles(self) -> Dict[str, str]:
        return dict(self._roles)

    def members(self, role: Optional[str] = None) -> List[str]:
        if role is None:
            return sorted(self._roles)
        return sorted(m for m, r in self._roles.items() if r == role)

    def set_members(self, roles: Dict[str, str]) -> None:
        for member, role in roles.items():
            if role not in (ROLE_PREFILL, ROLE_DECODE):
                raise ValueError(
                    f'unknown pool role {role!r} for {member!r}')
        self._roles = dict(roles)
        self._ring.set_members(list(roles))

    def add_member(self, member: str, role: str) -> None:
        if role not in (ROLE_PREFILL, ROLE_DECODE):
            raise ValueError(f'unknown pool role {role!r}')
        self._roles[member] = role
        self._ring.add_member(member)

    def remove_member(self, member: str) -> None:
        self._roles.pop(member, None)
        self._ring.remove_member(member)

    def choose(self, key: Union[str, bytes, int],
               exporter: Optional[str] = None) -> Optional[str]:
        """The decode replica for a handoff keyed by the prompt's
        fingerprint.  Primary owner when it is an eligible decode
        member; otherwise the first non-excluded owner clockwise.
        None when no decode replica exists (caller falls back to
        single-pool serving on the exporter)."""
        decode = [m for m, r in self._roles.items()
                  if r == ROLE_DECODE and m != exporter]
        if not decode:
            return None
        fp = key if isinstance(key, int) else stable_hash(key)
        primary = self._ring.primary(fp)
        if self._roles.get(primary) == ROLE_DECODE and \
                primary != exporter:
            return primary
        exclude = {m for m, r in self._roles.items()
                   if r == ROLE_PREFILL}
        if exporter is not None:
            exclude.add(exporter)
        return self._ring.prefetch_target(fp, exclude=exclude)


class RoleAwareSLOAutoscaler:
    """Per-pool SLO scaling for a disaggregated fleet.

    Composes two ``SLOAutoscaler`` instances instead of blending both
    phases into one pressure number — a prefill burst must grow the
    prefill pool without also (pointlessly) growing decode, and steady
    decode pressure must not be masked by an idle prefill pool:

    - **prefill** scales on cold-prompt TTFT burn against
      ``target_p99_ttft_ms`` plus its own queue depth — the only work
      it owns is time-to-first-token.
    - **decode** scales on per-token latency: TPOT samples are fed
      through the latency channel against ``target_p99_tpot_ms``
      (reported as ``tpot_ms``), plus decode-pool queue depth and the
      warm-cache downscale guard.

    Pool bounds derive from the spec: prefill holds at least
    ``prefill_replicas``; decode at least ``min_replicas -
    prefill_replicas``; together they never exceed ``max_replicas``.
    """

    def __init__(self, service_name: str, spec) -> None:
        prefill_n = getattr(spec, 'prefill_replicas', None)
        if not prefill_n or prefill_n < 1:
            raise ValueError(
                'RoleAwareSLOAutoscaler needs spec.prefill_replicas '
                f'>= 1, got {prefill_n!r}')
        if spec.target_p99_ttft_ms is None:
            raise ValueError('prefill pool scales on TTFT burn — set '
                             'target_p99_ttft_ms')
        tpot = getattr(spec, 'target_p99_tpot_ms', None)
        if tpot is None:
            raise ValueError('decode pool scales on TPOT — set '
                             'target_p99_tpot_ms')
        max_total = spec.max_replicas or spec.min_replicas
        decode_min = max(1, spec.min_replicas - prefill_n)
        decode_max = max(decode_min, max_total - prefill_n)
        prefill_max = max(prefill_n, max_total - decode_min)
        # Each pool's spec is single-pool from its own point of view:
        # clear the disagg knobs so the derived specs re-validate.
        self.prefill = SLOAutoscaler(
            f'{service_name}-prefill',
            dataclasses.replace(spec, min_replicas=prefill_n,
                                max_replicas=prefill_max,
                                prefill_replicas=None,
                                disagg_cold_prompt_tokens=None))
        self.decode = SLOAutoscaler(
            f'{service_name}-decode',
            dataclasses.replace(spec, min_replicas=decode_min,
                                max_replicas=decode_max,
                                target_p99_ttft_ms=float(tpot),
                                prefill_replicas=None,
                                disagg_cold_prompt_tokens=None))

    def get_decision_interval(self) -> int:
        """Both pools share one cadence (the fleet's decision tick)."""
        return self.prefill.get_decision_interval()

    def collect_request_information(
            self, request_data: Dict[str, Any]) -> None:
        """Consume a role-split report: ``{'prefill': {...},
        'decode': {...}}``.  The prefill dict uses the ordinary
        SLOAutoscaler keys; the decode dict reports ``tpot_ms``
        samples, mapped onto the latency channel here."""
        pre = request_data.get('prefill')
        if pre:
            self.prefill.collect_request_information(pre)
        dec = request_data.get('decode')
        if dec:
            mapped = dict(dec)
            if 'tpot_ms' in mapped:
                mapped['ttft_ms'] = mapped.pop('tpot_ms')
            self.decode.collect_request_information(mapped)

    def generate_scaling_decisions(
            self, prefill_replicas: List[Dict[str, Any]],
            decode_replicas: List[Dict[str, Any]]
    ) -> Dict[str, List[AutoscalerDecision]]:
        return {
            ROLE_PREFILL: self.prefill.generate_scaling_decisions(
                prefill_replicas),
            ROLE_DECODE: self.decode.generate_scaling_decisions(
                decode_replicas),
        }

    def info(self) -> Dict[str, Any]:
        return {ROLE_PREFILL: self.prefill.info(),
                ROLE_DECODE: self.decode.info()}
