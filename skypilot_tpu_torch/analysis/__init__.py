"""skytpu-lint over the port: its static analysis and its compile-budget
audit.  Counterpart of skypilot_tpu/analysis/, a copy that imports
nothing of the JAX package.

The port rests on invariants that a one-line diff can silently undo,
and that fail as a slow serving path, not an exception: one counted
host sync a decode chunk (``engine.host_fetch``), chunk bodies that a
CUDA graph can replay (they decide nothing on the host from device
values), injected clocks in the serving plane, threads that are joined.

- ``linter``: an AST pass (stdlib ``ast``) over the port's own source:
  host syncs and host decisions in CUDA-graph-captured code (SKY101-
  104), transfers and synchronizing uploads in the decode data plane
  outside ``engine.host_fetch`` (SKY105), f64 (SKY106), blocking calls
  in async handlers, swallowed recovery errors, metric families and
  wall clocks out of place (SKY2xx-4xx).
- ``graph`` and ``concurrency``: the whole-program call graph and the
  SKY5xx rules over it (cross-thread state, lock order, leaked
  threads, blocking calls on ``ContinuousBatcher.step``'s path).
- ``baseline``: a checked-in suppression file
  (``analysis/baseline.json``) so pre-existing findings don't fail CI
  but NEW ones do.
- ``audit``: the runtime compile-budget audit of the hot paths' CUDA
  graphs, host reads, f64 and arenas.

CLI: ``python -m skypilot_tpu_torch.analysis`` (see ``__main__``),
wired into tier-1 via ``tests/test_torch_lint.py`` and
``tests/test_torch_audit.py`` and into tooling via
``scripts/torch_lint.sh``.
"""
from skypilot_tpu_torch.analysis.baseline import (BASELINE_PATH,
                                                  load_baseline,
                                                  update_baseline)
from skypilot_tpu_torch.analysis.linter import (RULES, Violation, lint_file,
                                                lint_paths, lint_source)

__all__ = [
    'RULES', 'Violation', 'lint_source', 'lint_file', 'lint_paths',
    'BASELINE_PATH', 'load_baseline', 'update_baseline',
]
