"""Load balancing policies of the serving fleet.

Counterpart of skypilot_tpu/serve/load_balancing_policies.py: the same
registry, the same selections and the same tie-break draws from the
module ``random`` (the fleet simulator seeds it per run).

Policies are registered by subclassing `LoadBalancingPolicy` with a
`name=` class kwarg; `least_load` is the default (reference :110).

`select_replica` takes an optional request `context` dict (the LB
passes `{'prompt': <token list or text>}` when it can extract one from
the request body).  Stateless policies ignore it; `prefix_affinity`
fingerprints the prompt head and consistent-hashes it onto the replica
whose radix prefix cache (infer/prefix_cache.py) is most likely warm.
"""
from __future__ import annotations

import collections
import math
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Union

from skypilot_tpu_torch.serve.traffic import hashring
from skypilot_tpu_torch.telemetry import metrics as telemetry_metrics

LB_POLICIES: Dict[str, type] = {}
DEFAULT_LB_POLICY: Optional[str] = None


class LoadBalancingPolicy:
    """Maps an incoming request to a ready replica URL."""

    name: str = ''

    def __init__(self) -> None:
        self.ready_replicas: List[str] = []

    def __init_subclass__(cls, name: Optional[str] = None,
                          default: bool = False):
        # name=None: an abstract base (e.g. the in-flight tracking
        # mixin), not a selectable policy.
        if name is None:
            return
        LB_POLICIES[name] = cls
        cls.name = name
        if default:
            global DEFAULT_LB_POLICY
            assert DEFAULT_LB_POLICY is None, 'Only one default policy.'
            DEFAULT_LB_POLICY = name

    @classmethod
    def make(cls, policy_name: Optional[str] = None) -> 'LoadBalancingPolicy':
        name = policy_name or DEFAULT_LB_POLICY
        if name not in LB_POLICIES:
            raise ValueError(f'Unknown load balancing policy: {name}')
        return LB_POLICIES[name]()

    def set_ready_replicas(self, ready_replicas: List[str]) -> None:
        raise NotImplementedError

    def select_replica(self, context: Optional[Dict[str, Any]] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        """Pick a replica for one request.  `exclude` removes replicas
        from consideration for THIS selection only (the LB's failover
        retry loop passes the replicas that already failed the request,
        so a retry never lands back on the same one)."""
        raise NotImplementedError

    def _count_selection(self, url: Optional[str]) -> None:
        """Per-policy selection counter (skytpu_serve_lb_selections_total)
        — every select_replica implementation reports through this."""
        if url is not None:
            telemetry_metrics.SERVE_LB_SELECTIONS.labels(
                policy=self.name).inc()

    def pre_execute_hook(self, replica_url: str) -> None:
        pass

    def post_execute_hook(self, replica_url: str) -> None:
        pass


class RoundRobinPolicy(LoadBalancingPolicy, name='round_robin'):
    """Cycle through replicas (reference :85); shuffled on membership change
    so the first replica doesn't absorb every scale-up burst."""

    def __init__(self) -> None:
        super().__init__()
        self.index = 0
        self.lock = threading.Lock()

    def set_ready_replicas(self, ready_replicas: List[str]) -> None:
        with self.lock:
            if set(self.ready_replicas) == set(ready_replicas):
                return
            replicas = list(ready_replicas)
            random.shuffle(replicas)
            self.ready_replicas = replicas
            self.index = 0

    def select_replica(self, context: Optional[Dict[str, Any]] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        with self.lock:
            if not self.ready_replicas:
                return None
            # At most one full cycle: every candidate excluded -> None.
            for _ in range(len(self.ready_replicas)):
                url = self.ready_replicas[self.index]
                self.index = (self.index + 1) % len(self.ready_replicas)
                if not exclude or url not in exclude:
                    self._count_selection(url)
                    return url
            return None


class _InflightTrackingPolicy(LoadBalancingPolicy):
    """Shared in-flight accounting: load_map counts requests between
    pre/post execute hooks and mirrors into the per-replica in-flight
    gauge (skytpu_serve_replica_inflight)."""

    def __init__(self) -> None:
        super().__init__()
        self.load_map: Dict[str, int] = collections.defaultdict(int)
        self.lock = threading.Lock()

    def set_ready_replicas(self, ready_replicas: List[str]) -> None:
        with self.lock:
            if set(self.ready_replicas) == set(ready_replicas):
                return
            self.ready_replicas = list(ready_replicas)
            for url in list(self.load_map):
                if url not in self.ready_replicas:
                    del self.load_map[url]
            self._members_changed()

    def _members_changed(self) -> None:
        pass

    def _least_loaded(self, exclude: Optional[Set[str]] = None
                      ) -> Optional[str]:
        """Minimum in-flight load; ties broken RANDOMLY — `min` alone
        always returns the first list entry, so every scale-up burst
        would pile onto one replica until its hooks register load."""
        candidates = [u for u in self.ready_replicas
                      if not exclude or u not in exclude]
        if not candidates:
            return None
        min_load = min(self.load_map.get(u, 0) for u in candidates)
        ties = [u for u in candidates
                if self.load_map.get(u, 0) == min_load]
        return random.choice(ties)

    def pre_execute_hook(self, replica_url: str) -> None:
        with self.lock:
            self.load_map[replica_url] += 1
            telemetry_metrics.SERVE_REPLICA_INFLIGHT.labels(
                replica=replica_url).set(self.load_map[replica_url])

    def post_execute_hook(self, replica_url: str) -> None:
        with self.lock:
            self.load_map[replica_url] = max(
                0, self.load_map.get(replica_url, 0) - 1)
            telemetry_metrics.SERVE_REPLICA_INFLIGHT.labels(
                replica=replica_url).set(self.load_map[replica_url])


class LeastLoadPolicy(_InflightTrackingPolicy, name='least_load',
                      default=True):
    """Route to the replica with the fewest in-flight requests."""

    def select_replica(self, context: Optional[Dict[str, Any]] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        with self.lock:
            url = self._least_loaded(exclude)
            self._count_selection(url)
            return url


class PrefixAffinityPolicy(_InflightTrackingPolicy,
                           name='prefix_affinity'):
    """Session/prefix-affinity routing: consistent-hash the prompt head
    onto replicas so shared-system-prompt traffic lands where the radix
    prefix cache is already warm, with a bounded-load fallback.

    - **Fingerprint**: the first `fingerprint_blocks * prefix_block`
      prompt tokens, truncated DOWN to whole `prefix_block` blocks (the
      prefix cache's reuse granularity — a partial block is never
      reusable).  Prompts shorter than one block carry no reusable
      head and fall back to least-load.  Text prompts are
      fingerprinted on a `4 chars ~ 1 token` heuristic window.
    - **Placement**: consistent hashing (serve/traffic/hashring.py) —
      replica churn remaps ~1/n of fingerprints, so a scale-up does
      not cold-start every cache in the fleet.
    - **Bounded load**: a replica is skipped while its in-flight count
      is >= ceil(load_factor * (total_inflight + 1) / n) — the classic
      bounded-loads guard against one hot system prompt hot-spotting
      its owner.  Diverted (and fingerprint-less) selections count as
      affinity misses; selections that land on the primary owner count
      as hits (skytpu_serve_affinity_{hits,misses}_total).
    """

    def __init__(self, prefix_block: int = 64, fingerprint_blocks: int = 2,
                 vnodes: int = hashring.DEFAULT_VNODES,
                 load_factor: float = 1.25) -> None:
        super().__init__()
        if prefix_block <= 0:
            raise ValueError(f'prefix_block must be positive, '
                             f'got {prefix_block}')
        if load_factor < 1.0:
            raise ValueError(f'load_factor must be >= 1, '
                             f'got {load_factor}')
        self.prefix_block = prefix_block
        self.fingerprint_blocks = max(1, fingerprint_blocks)
        self.load_factor = load_factor
        self.ring = hashring.ConsistentHashRing(vnodes=vnodes)
        self.affinity_hits = 0
        self.affinity_misses = 0

    def _members_changed(self) -> None:
        self.ring.set_members(self.ready_replicas)

    def fingerprint(self, prompt: Union[Sequence[int], str, None]
                    ) -> Optional[int]:
        """Stable hash of the prompt head at prefix_block granularity;
        None when there is no whole reusable block."""
        if prompt is None:
            return None
        window = self.fingerprint_blocks * self.prefix_block
        if isinstance(prompt, str):
            # ~4 chars per token: the LB sees text, the replica tokens.
            window *= 4
            head = prompt[:window]
            if len(head) < 4 * self.prefix_block:
                return None
            return hashring.stable_hash(head)
        blocks = min(self.fingerprint_blocks,
                     len(prompt) // self.prefix_block)
        if blocks == 0:
            return None
        head = prompt[:blocks * self.prefix_block]
        return hashring.stable_hash(
            ','.join(str(int(t)) for t in head))

    def _miss(self) -> None:
        self.affinity_misses += 1
        telemetry_metrics.SERVE_AFFINITY_MISSES.inc()

    def _hit(self) -> None:
        self.affinity_hits += 1
        telemetry_metrics.SERVE_AFFINITY_HITS.inc()

    def select_replica(self, context: Optional[Dict[str, Any]] = None,
                       exclude: Optional[Set[str]] = None
                       ) -> Optional[str]:
        with self.lock:
            candidates = [u for u in self.ready_replicas
                          if not exclude or u not in exclude]
            if not candidates:
                return None
            fp = self.fingerprint((context or {}).get('prompt'))
            if fp is None:
                url = self._least_loaded(exclude)
                self._miss()
                self._count_selection(url)
                return url
            total = sum(self.load_map.get(u, 0) for u in candidates)
            bound = math.ceil(self.load_factor * (total + 1)
                              / len(candidates))
            primary = None
            chosen = None
            for url in self.ring.owners(fp):
                if primary is None:
                    # The true owner, even when excluded: a retry that
                    # must divert off it still counts as a miss.
                    primary = url
                if exclude and url in exclude:
                    continue
                if self.load_map.get(url, 0) < bound:
                    chosen = url
                    break
            if chosen is None:
                # Every owner over bound (can't happen with the ceil
                # bound unless load_map is stale) — least-load fallback.
                chosen = self._least_loaded(exclude)
            if chosen == primary:
                self._hit()
            else:
                self._miss()
            self._count_selection(chosen)
            return chosen
