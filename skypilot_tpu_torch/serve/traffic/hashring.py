"""Consistent hashing with bounded loads (Mirrokni et al., the
"consistent hashing with bounded loads" scheme behind the
`prefix_affinity` LB policy).

A member owns the arc of the unit ring between its predecessor vnode
and itself; a key is owned by the first vnode clockwise from its hash.
Properties the routing layer relies on:

- **Stability under churn**: adding/removing one member remaps only the
  keys on the arcs that member's vnodes cover — an expected 1/n of the
  keyspace, NOT a full reshuffle.
- **Determinism**: vnode placement hashes `f'{member}#{i}'` with a
  keyed blake2b, so the ring layout is a pure function of the member
  set — every process that sees the same ready-replica set computes
  the same ownership.

The bounded-load *policy* (divert to the next owner when the primary
is over `load_factor x` the mean in-flight load) lives in the caller:
the ring only answers "who owns this key, and who comes next".

Counterpart of skypilot_tpu/serve/traffic/hashring.py: the same digests
and the same vnode layout, so both packages place every key alike.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import (Collection, Iterator, List, Optional, Sequence,
                    Union)

DEFAULT_VNODES = 64


def stable_hash(data: Union[str, bytes]) -> int:
    """64-bit digest that is stable across processes and Python runs
    (`hash()` is salted per-process; routing needs every LB replica to
    agree on key placement)."""
    if isinstance(data, str):
        data = data.encode('utf-8')
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), 'big')


class ConsistentHashRing:
    """Ring of members, each holding `vnodes` virtual points."""

    def __init__(self, vnodes: int = DEFAULT_VNODES) -> None:
        if vnodes <= 0:
            raise ValueError(f'vnodes must be positive, got {vnodes}')
        self.vnodes = vnodes
        self._points: List[int] = []
        self._owners: List[str] = []
        self._members: List[str] = []

    @property
    def members(self) -> List[str]:
        return list(self._members)

    def set_members(self, members: Sequence[str]) -> None:
        """Rebuild the ring for a new member set.  Vnode positions
        depend only on the member name, so unchanged members keep their
        arcs — the churn-stability property."""
        pairs = []
        for member in sorted(set(members)):
            for i in range(self.vnodes):
                pairs.append((stable_hash(f'{member}#{i}'), member))
        pairs.sort()
        self._points = [p for p, _ in pairs]
        self._owners = [m for _, m in pairs]
        self._members = sorted(set(members))

    def add_member(self, member: str) -> None:
        """Insert one member's vnodes in place.  Equivalent to
        `set_members(members + [member])` — vnode positions are a pure
        function of the name — but O(vnodes log n) instead of a full
        rebuild; existing members' arcs are untouched except where the
        new vnodes split them (the bounded ~1/n remap)."""
        if member in self._members:
            return
        for i in range(self.vnodes):
            point = stable_hash(f'{member}#{i}')
            idx = bisect.bisect_left(self._points, point)
            self._points.insert(idx, point)
            self._owners.insert(idx, member)
        bisect.insort(self._members, member)

    def remove_member(self, member: str) -> None:
        """Remove one member's vnodes in place — the replica-death
        path.  Only keys on the departed arcs remap (each to the next
        surviving vnode clockwise); every other key keeps its owner,
        so survivors' prefix caches stay warm.  Unknown members are a
        no-op: death detection can race a drain that already rebuilt
        the ring."""
        if member not in self._members:
            return
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != member]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]
        self._members.remove(member)

    def primary(self, key_hash: int) -> str:
        """The member owning `key_hash` (first vnode clockwise)."""
        if not self._points:
            raise ValueError('empty ring')
        idx = bisect.bisect_right(self._points, key_hash) % \
            len(self._points)
        return self._owners[idx]

    def prefetch_target(self, key_hash: int,
                        exclude: Optional[Collection[str]] = None
                        ) -> Optional[str]:
        """The next distinct owner after the primary — where a
        bounded-load divert would send `key_hash`.  Routing warms this
        member's host KV tier (a best-effort prefetch hint) so a
        divert still lands on staged blocks instead of a cold prefill.

        `exclude` removes members that must not receive the bytes —
        disaggregated handoff passes the exporting replica itself plus
        the whole prefill pool, so a KV image never boomerangs back to
        its producer.  The walk terminates even when the exclusion set
        covers the ring: `owners` yields each distinct member at most
        once, so exhausting it returns None rather than spinning.

        None on an empty ring, when the primary is the only member, or
        when every non-primary owner is excluded.
        """
        excluded = frozenset(exclude or ())
        walk = self.owners(key_hash)
        next(walk, None)  # skip the primary — it already has the key.
        for owner in walk:
            if owner not in excluded:
                return owner
        return None

    def owners(self, key_hash: int) -> Iterator[str]:
        """Distinct members in ring order starting at the primary —
        the bounded-load fallback walk order."""
        if not self._points:
            return
        start = bisect.bisect_right(self._points, key_hash) % \
            len(self._points)
        seen = set()
        for off in range(len(self._points)):
            owner = self._owners[(start + off) % len(self._points)]
            if owner not in seen:
                seen.add(owner)
                yield owner
                if len(seen) == len(self._members):
                    return
