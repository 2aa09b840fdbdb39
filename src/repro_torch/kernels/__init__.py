"""Hand-written Hopper kernels for the model hot spots + dispatch wrappers.

Each kernel module holds the kernel's launcher, a plain PyTorch version of
the same function and a launch counter; ``ops.py`` is the public API used by
the models.  A wrapper given a CPU tensor runs the plain version (a meta
tensor too, which only propagates shapes); given a CUDA tensor it launches
the kernel or raises.
"""
