"""repro_torch: RRFP — readiness-driven pipeline-parallel training in PyTorch.

The PyTorch/CUDA port of the JAX package ``repro``: the same runtime, the
same models and the same training path, with the TPU kernels rewritten by
hand for Hopper.  It imports neither ``jax`` nor ``repro``.
"""
__version__ = "0.1.0"
