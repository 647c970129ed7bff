"""PyTorch + CUDA port of the Storm dataplane (the JAX package ``repro`` is
the reference it is held against).  See ``core/__init__.py`` for the
module map; kernels are hand-written CUDA under ``csrc/``."""
