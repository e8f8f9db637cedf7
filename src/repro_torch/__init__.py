"""PyTorch/CUDA port of the 2DReach RangeReach system.

Builds a 2DReach index on the host (NumPy) and serves RangeReach /
RangeCount / RangeCollect on an NVIDIA GPU through a hand-written CUDA
kernel.  The JAX package ``repro`` is the reference it is tested
against; this package imports neither ``jax`` nor ``repro``.
"""
