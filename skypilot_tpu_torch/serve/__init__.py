"""The serving fleet of the port: load-balancing policies, the SLO
monitor, autoscalers, failover (circuit breaker, session journal),
disaggregated prefill/decode (the handoff scheduler, the role-aware
autoscaler, the KV image codec), the replica states, and the
traffic subsystem (hash ring, trace generator, FleetSimulator) under
``traffic``.

Counterpart of the data-plane half of skypilot_tpu/serve/; its
controller, service spec, replica managers and load-balancer process are
orchestration and are not part of the port.
"""
