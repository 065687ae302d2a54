"""Radix-style prefix KV cache: shared-prompt K/V reuse across requests.

Counterpart of skypilot_tpu/infer/prefix_cache.py.  A host-side trie at
fixed block granularity over prompt-token prefixes, whose nodes own
device K/V.  On admit, the engine longest-prefix-matches the prompt
against the trie, puts the matched blocks in front of the slot's own and
prefills only the *suffix* through the start-offset window path; after
prefill the prompt's head blocks are inserted, so the next request that
shares the head hits.  Reuse is verbatim because the models apply RoPE by
absolute position before K enters the cache.

Two modes:

- POOLED (a ``BlockPool`` given): nodes hold arena block ids with a
  refcount each.  A warm hit is ``splice`` (the ids go into the slot's
  block table, refcounts bumped) and an insert shares the live row's
  blocks: zero device copies.  Eviction returns ids to the free list
  when their last reference drops.
- LEGACY contiguous planes: nodes own standalone tensors.  ``extract``
  copies a block out of a slot's cache rows and ``install`` copies it
  back in place (the cache tensors are written, never rebound, so a
  captured graph that reads them stays valid).  A block is never a view
  of a slot cache, so bucket migrations cannot corrupt it.

Contracts the engines rely on:

- No host syncs: byte accounting reads tensor metadata (``numel() *
  element_size()``); matching and trie bookkeeping are host Python over
  token lists.
- Refcounts: ``match`` takes a reference on every matched node and LRU
  eviction skips nodes with live references, so a block cannot be freed
  between match and install.  Callers ``release()`` the match.
- Single-threaded: every call comes from the scheduler thread.

Both KV layouts work unchanged: a block carries whatever keys the cache
has (``k``/``v``, plus ``k_scale``/``v_scale`` for int8 K/V).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics

Block = Dict[str, torch.Tensor]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def install_prefix(cache: Block, block: Block, slot: int, start: int
                   ) -> Block:
    """Copy one cached block into ``cache[key][:, slot, start:start+B]``
    in place.  K/V are (L, batch, pos, KV, hd), int8 scales (L, batch,
    pos, KV); a block is the same without the batch axis."""
    for key, arr in cache.items():
        src = block[key]
        arr[:, slot, start:start + src.shape[1]].copy_(src)
    return cache


def extract_block(cache: Block, slot: int, start: int, *, block: int
                  ) -> Block:
    """``cache[key][:, slot, start:start+block]`` as new tensors (a copy:
    the result never aliases the slot cache)."""
    return {key: arr[:, slot, start:start + block].clone()
            for key, arr in cache.items()}


class _Node:
    """One trie node: a block of tokens plus its K/V, standalone tensors
    (legacy mode) or a list of pool block ids whose refcounts the node
    holds (pooled mode)."""

    __slots__ = ('key', 'parent', 'children', 'data', 'nbytes', 'refs',
                 'last_used', 'tier')

    def __init__(self, key: Tuple[int, ...], parent: Optional['_Node'],
                 data=None, nbytes: Optional[int] = None):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.data = data
        if nbytes is not None:
            self.nbytes = nbytes
        else:
            self.nbytes = _nbytes(data.values()) if data else 0
        self.refs = 0
        self.last_used = 0
        # Host-tier state (infer/kv_tier.py): 'device' (resident and
        # matchable), 'loading' (a prefetch is filling the blocks; hidden
        # from match and pinned from eviction until it lands), 'failed'
        # (the prefetch errored; detached, parked requests requeue).
        self.tier = 'device'


@dataclasses.dataclass
class PrefixMatch:
    """Result of a longest-prefix match; holds references on the matched
    nodes until ``release()``."""
    tokens: int                   # matched prompt tokens (multiple of block)
    nodes: List[_Node]
    _cache: 'PrefixCache'
    _released: bool = False

    @property
    def hit(self) -> bool:
        return self.tokens > 0

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._cache._release_nodes(self.nodes)


class PrefixCache:
    """Host-side radix trie over prompt prefixes owning device K/V
    blocks, with byte-budgeted LRU eviction and ref-count pinning."""

    def __init__(self, block: int, capacity_bytes: int, pool=None):
        """pool: a block_pool.BlockPool for POOLED mode (nodes hold arena
        block ids; install is ``splice``); None for the legacy planes'
        standalone blocks."""
        if block <= 0:
            raise ValueError(f'prefix block must be positive, got {block}')
        self.block = int(block)
        self.capacity_bytes = int(capacity_bytes)
        self.pool = pool
        if pool is not None:
            if block % pool.block_size:
                raise ValueError(
                    f'prefix block {block} must be a multiple of the '
                    f'pool block_size {pool.block_size}')
            self._ids_per_node = block // pool.block_size
            self._pool_block_nbytes = pool.block_nbytes
        self._root = _Node((), None)
        self._clock = 0
        # Host KV tier (kv_tier.KVTier), set by the owning engine after
        # construction.  None keeps every path below the no-tier one.
        self.tier = None
        # Instance mirrors of the registry counters (the registry is
        # process-global; tests and the smoke run read per-cache deltas).
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.evictions = 0
        self.bytes = 0
        self.node_count = 0

    # -- matching ---------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest-prefix match over full blocks, capped so at least one
        suffix token remains (its prefill gives the first token's
        logits).  Takes a reference on each matched node; pair with
        ``release()``.  A pure lookup: ``commit()`` records metrics."""
        toks = tuple(int(t) for t in tokens)
        max_blocks = max(0, (len(toks) - 1) // self.block)
        nodes: List[_Node] = []
        node = self._root
        for b in range(max_blocks):
            child = node.children.get(
                toks[b * self.block:(b + 1) * self.block])
            if child is None or child.tier != 'device':
                # A 'loading' child is a prefetch in flight: its blocks
                # are not readable yet, so the match stops here (the
                # batcher parks on it through pending_continuation).
                break
            nodes.append(child)
            node = child
        for n in nodes:
            n.refs += 1
            self._touch(n)
        return PrefixMatch(tokens=len(nodes) * self.block, nodes=nodes,
                           _cache=self)

    def commit(self, match: PrefixMatch) -> None:
        """Record hit/miss and tokens saved for a match the engine acts
        on (a lookup that cannot be admitted this tick does not count)."""
        if match.hit:
            self.hits += 1
            self.tokens_saved += match.tokens
            telemetry_metrics.INFER_PREFIX_HITS.inc()
            telemetry_metrics.INFER_PREFIX_TOKENS_SAVED.inc(match.tokens)
        else:
            self.misses += 1
            telemetry_metrics.INFER_PREFIX_MISSES.inc()

    def install(self, cache: Block, slot: int, match: PrefixMatch) -> Block:
        """Copy the matched blocks into ``cache``'s rows of ``slot`` in
        place (legacy mode; the caller grew the cache to cover
        ``match.tokens`` positions).  Pooled engines use ``splice``."""
        for i, node in enumerate(match.nodes):
            cache = install_prefix(cache, node.data, slot, i * self.block)
        return cache

    def splice(self, match: PrefixMatch) -> List[int]:
        """POOLED-mode install: the flat arena block ids of the matched
        nodes, refcount-bumped for the sequence about to reference them
        through its block table.  Host list math, zero device copies.
        The caller owns one release of every returned id."""
        ids: List[int] = []
        for node in match.nodes:
            ids.extend(node.data)
        self.pool.share(ids, prefix=True)
        return ids

    def cached_continuation(self, tokens: Sequence[int],
                            limit: int) -> List[int]:
        """Up to ``limit`` CACHED tokens that followed ``tokens`` in an
        earlier request, read off the trie's child keys (the drafter's
        seed).  A host walk: no refcounts, no recency touch.  Ties between
        siblings go to the most recently used child; [] when the trie
        diverges from ``tokens``."""
        toks = tuple(int(t) for t in tokens)
        node = self._root
        depth = 0
        while len(toks) - depth >= self.block:
            child = node.children.get(toks[depth:depth + self.block])
            if child is None:
                return []
            node = child
            depth += self.block
        rem = toks[depth:]
        out: List[int] = []
        while len(out) < limit:
            best = None
            for key, child in node.children.items():
                if key[:len(rem)] != rem:
                    continue
                if best is None or child.last_used > best.last_used:
                    best = child
            if best is None:
                break
            out.extend(best.key[len(rem):])
            rem = ()
            node = best
        return out[:limit]

    # -- insertion --------------------------------------------------------

    def insert(self, tokens: Sequence[int],
               extractor: Optional[Callable[[int], Block]] = None,
               blocks: Optional[Sequence[int]] = None) -> int:
        """Insert ``tokens``' full blocks into the trie.

        Legacy mode: ``extractor(start)`` is called only for blocks not
        cached yet (a copy out of the freshly prefilled slot rows).
        Pooled mode: ``blocks`` is the live sequence's arena block ids
        covering the prompt; a new node SHARES the ids backing its token
        block (refcount bump, no copy).

        Returns the number of new nodes.  May evict LRU unreferenced
        nodes to hold the byte budget, with a very small budget the
        nodes just inserted too (newest recency, so they go last)."""
        toks = tuple(int(t) for t in tokens)
        node = self._root
        created = 0
        for b in range(len(toks) // self.block):
            key = toks[b * self.block:(b + 1) * self.block]
            child = node.children.get(key)
            if child is None:
                if self.pool is not None:
                    lo = b * self._ids_per_node
                    ids = list(blocks[lo:lo + self._ids_per_node])
                    if len(ids) < self._ids_per_node:
                        break  # prompt tail not fully backed; stop here
                    self.pool.share(ids)
                    child = _Node(key, node, ids,
                                  nbytes=(len(ids)
                                          * self._pool_block_nbytes))
                else:
                    child = _Node(key, node, extractor(b * self.block))
                node.children[key] = child
                self.bytes += child.nbytes
                self.node_count += 1
                created += 1
            self._touch(child)
            node = child
        if created:
            telemetry_metrics.INFER_PREFIX_BYTES.set(self.bytes)
            self._evict_to_budget()
        return created

    # -- host-tier hooks (infer/kv_tier.py) --------------------------------

    def _node_prefix(self, node: _Node) -> Tuple[int, ...]:
        """The full token prefix a node covers (the host store's key)."""
        parts: List[Tuple[int, ...]] = []
        while node.parent is not None:
            parts.append(node.key)
            node = node.parent
        return tuple(t for key in reversed(parts) for t in key)

    def pending_continuation(self, tokens: Sequence[int],
                             from_tokens: int) -> List[_Node]:
        """The chain of 'loading' children extending a device match of
        ``from_tokens`` tokens: a prefetch already in flight that the
        batcher can park a request on.  A 'failed' child ends the
        chain."""
        toks = tuple(int(t) for t in tokens)
        max_blocks = max(0, (len(toks) - 1) // self.block)
        node = self._root
        out: List[_Node] = []
        for b in range(max_blocks):
            child = node.children.get(
                toks[b * self.block:(b + 1) * self.block])
            if child is None:
                break
            if child.tier == 'loading':
                out.append(child)
            elif child.tier != 'device' or out:
                # Chains are contiguous: insert_pending only extends
                # device chains.
                break
            node = child
        return out

    def insert_pending(self, tokens: Sequence[int], from_block: int,
                       ids: Sequence[int]) -> List[_Node]:
        """Tier prefetch: 'loading' nodes for ``tokens``' blocks from
        ``from_block`` (the end of the device match), each owning its
        slice of the prefetch ids (the refcount-1 reference
        ``BlockPool.alloc_for_prefetch`` produced).  Invisible to
        ``match`` and pinned from eviction until the tier flips them to
        'device' at drain."""
        toks = tuple(int(t) for t in tokens)
        node = self._root
        for b in range(from_block):
            child = node.children.get(
                toks[b * self.block:(b + 1) * self.block])
            if child is None or child.tier != 'device':
                raise AssertionError(
                    f'insert_pending: device chain broken at block {b}')
            node = child
        n_nodes = len(ids) // self._ids_per_node
        created: List[_Node] = []
        for i in range(n_nodes):
            b = from_block + i
            key = toks[b * self.block:(b + 1) * self.block]
            if key in node.children:
                raise AssertionError(
                    f'insert_pending: block {b} already present')
            chunk = list(ids[i * self._ids_per_node:
                             (i + 1) * self._ids_per_node])
            child = _Node(key, node, chunk,
                          nbytes=len(chunk) * self._pool_block_nbytes)
            child.tier = 'loading'
            node.children[key] = child
            self.bytes += child.nbytes
            self.node_count += 1
            self._touch(child)
            created.append(child)
            node = child
        telemetry_metrics.INFER_PREFIX_BYTES.set(self.bytes)
        return created

    def drop_pending(self, node: _Node) -> None:
        """Detach a 'loading'/'failed' node after a failed prefetch (trie
        bookkeeping only: the tier releases the node's block ids).
        Children first: callers unwind a chain deepest node first."""
        if node.children:
            raise AssertionError('drop_pending of an interior node')
        if node.parent.children.get(node.key) is node:
            del node.parent.children[node.key]
        self.bytes -= node.nbytes
        self.node_count -= 1
        telemetry_metrics.INFER_PREFIX_BYTES.set(self.bytes)

    # -- internals --------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _release_nodes(self, nodes: List[_Node]) -> None:
        for n in nodes:
            n.refs -= 1
            self._touch(n)

    def _lru_victim(self) -> Optional[_Node]:
        """LRU leaf with no children, no live refs and tier 'device', or
        None when everything left is pinned: an in-flight match (or
        prefetch) can always complete."""
        victim = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.refs == 0 and n.tier == 'device' and \
                    (victim is None or n.last_used < victim.last_used):
                victim = n
        return victim

    def forget(self, tokens: Sequence[int], *,
               spill: bool = False) -> int:
        """Drop the deepest droppable suffix of the node chain covering
        ``tokens``: the handoff's release-after-export (``spill=False``:
        the bytes live on the decode replica now, so the nodes neither
        stay nor spill, and their blocks free at once).  Only
        unreferenced 'device' leaves drop, leaf-ward first, stopping at
        the first pinned or interior node.  Returns the nodes dropped."""
        toks = tuple(int(t) for t in tokens)
        node = self._root
        chain: List[_Node] = []
        for b in range(len(toks) // self.block):
            child = node.children.get(
                toks[b * self.block:(b + 1) * self.block])
            if child is None:
                break
            chain.append(child)
            node = child
        dropped = 0
        for n in reversed(chain):
            if n.children or n.refs != 0 or n.tier != 'device':
                break
            self._drop(n, spill=spill)
            dropped += 1
        return dropped

    def _drop(self, victim: _Node, spill: bool = True) -> None:
        del victim.parent.children[victim.key]
        self.bytes -= victim.nbytes
        self.node_count -= 1
        self.evictions += 1
        if self.pool is not None:
            if spill and self.tier is not None and victim.tier == 'device':
                # Host-tier spill: the tier enqueues a gather over the
                # victim's blocks BEFORE they free (the gather output owns
                # the bytes), so the release below is the same either way.
                self.tier.accept_spill(self._node_prefix(victim),
                                       victim.data)
            # The node's reference drops; ids reaching refcount 0 return
            # to the free list, never while a sequence still holds them.
            self.pool.release(victim.data)
        telemetry_metrics.INFER_PREFIX_EVICTIONS.inc()
        telemetry_metrics.INFER_PREFIX_BYTES.set(self.bytes)

    def _evict_to_budget(self) -> None:
        """Evict LRU leaves until under the byte budget; evicting a leaf
        may expose its parent as the next candidate."""
        while self.bytes > self.capacity_bytes:
            victim = self._lru_victim()
            if victim is None:       # everything left is pinned
                break
            self._drop(victim)

    def evict_for_pool(self, need_blocks: int) -> int:
        """POOLED-mode admission pressure valve: evict LRU unreferenced
        nodes until the pool could satisfy ``need_blocks`` more, or no
        evictable node remains.  Nodes whose blocks a live sequence
        shares leave the trie but their blocks stay live until the
        sequence completes.  Returns the number of nodes evicted."""
        if self.pool is None:
            return 0
        evicted = 0
        while self.pool.available() < need_blocks:
            victim = self._lru_victim()
            if victim is None:
                break
            self._drop(victim)
            evicted += 1
        return evicted

    def extract(self, cache: Block, slot: int, start: int) -> Block:
        """A block copied out of a slot's cache rows (``extract_block``)."""
        return extract_block(cache, slot, start, block=self.block)


def make_prefix_cache(config, pool=None) -> Optional[PrefixCache]:
    """A PrefixCache from a GeneratorConfig, or None when disabled
    (``prefix_cache_mb`` unset/0).  pool: the engine's BlockPool for the
    pooled mode; None for the legacy planes' standalone blocks."""
    mb = getattr(config, 'prefix_cache_mb', None)
    if not mb:
        return None
    block = int(getattr(config, 'prefix_block', 0) or 0)
    return PrefixCache(block=block,
                       capacity_bytes=int(float(mb) * 1024 * 1024),
                       pool=pool)
