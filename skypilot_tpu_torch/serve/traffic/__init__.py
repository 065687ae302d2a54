"""Serve-traffic subsystem of the port: prefix-affinity routing
primitives, a seeded open-loop traffic generator, and a virtual-time
fleet simulator.

- `hashring`: consistent hashing with bounded loads — the placement
  primitive behind the `prefix_affinity` load-balancing policy
  (serve/load_balancing_policies.py registers the policy itself).
- `generator`: a fully seeded arrival-process generator (Poisson base
  rate modulated by Gamma-length burst episodes, heavy-tailed
  prompt/output lengths, a session model with shared prompt heads).
- `simulator`: an open-loop fleet simulator whose replicas are the
  port's `ContinuousBatcher`s (on the card, or on the CPU when asked)
  and whose time is virtual (a deterministic token-cost model),
  emitting the SERVE_SUMMARY fields.

Counterpart of skypilot_tpu/serve/traffic/, with the same re-exports.
`simulator` imports torch and the inference engine; it is loaded
lazily so `from skypilot_tpu_torch.serve.traffic import generator`
stays cheap.
"""
from skypilot_tpu_torch.serve.traffic.generator import (Arrival,
                                                        TrafficConfig,
                                                        generate_trace)
from skypilot_tpu_torch.serve.traffic.hashring import (ConsistentHashRing,
                                                       stable_hash)

__all__ = ['Arrival', 'ConsistentHashRing', 'FleetSimulator', 'SimConfig',
           'TrafficConfig', 'generate_trace', 'stable_hash']


def __getattr__(name):
    if name in ('FleetSimulator', 'SimConfig'):
        from skypilot_tpu_torch.serve.traffic import simulator
        return getattr(simulator, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
