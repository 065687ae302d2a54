"""PyTorch/CUDA port of the skypilot_tpu serving path.

The JAX package ``skypilot_tpu`` stays the reference; this package mirrors
its module layout (``ops/``, ``models/``, ``infer/``) and imports none of
it.  Its entry points run on a CUDA device unless the caller passes
``device='cpu'``, where every hand-written kernel's plain PyTorch version
runs instead.
"""
