"""Data-plane observability of the port: metric families on the port's
own prometheus registry (``metrics``), trace-context propagation
(``trace``), lifecycle spans and step-phase attribution (``spans``), the
per-tenant cost ledger (``accounting``), opt-in profiler windows
(``profiler``), JSONL step telemetry (``steplog``) and the fleet doctor
with its flight recorder (``doctor``).

Counterpart of skypilot_tpu/telemetry/, which exports ``metrics``,
``steplog`` and ``trace`` the same way.
"""
from skypilot_tpu_torch.telemetry import metrics, steplog, trace

__all__ = ['metrics', 'steplog', 'trace']
