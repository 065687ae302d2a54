"""Runtime analysis of the port: the compile-budget audit (audit.py).

Counterpart of skypilot_tpu/analysis/.  Only the audit is ported: the
JAX package's linter, call graph, concurrency rules and baseline analyse
that package's own source, and no path of the port needs them.
"""
