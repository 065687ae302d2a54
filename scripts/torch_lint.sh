#!/usr/bin/env bash
# CI entry point for skytpu-lint over the PyTorch/CUDA port: JSON-mode
# static analysis of skypilot_tpu_torch/, failing on NEW violations
# (skypilot_tpu_torch/analysis/baseline.json suppresses the pre-existing
# set).  The counterpart of scripts/lint.sh's first step.
#
# Usage:
#   scripts/torch_lint.sh                  # lint only (no card needed)
#   scripts/torch_lint.sh --audit --device cpu
#                                          # + the compile-budget audit
#                                          #   on the host (~10 s)
set -euo pipefail

cd "$(dirname "$0")/.."

# --graph-stats doubles as a self-check: the run fails if the
# whole-program call graph is degenerate (zero functions, call edges,
# or thread entries), i.e. the SKY5xx concurrency pass went blind.
python -m skypilot_tpu_torch.analysis --json --graph-stats "$@"
