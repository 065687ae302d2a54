"""Kernels of the port (csrc/*.cu) with their plain PyTorch versions."""
