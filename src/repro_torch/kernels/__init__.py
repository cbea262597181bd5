"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` is the entry point: it dispatches on the tensor's device and counts
launches. The CUDA sources live in ``../csrc``; ``build`` compiles them.
"""
