"""PyTorch/CUDA port of the ``repro`` model stack, for an NVIDIA H100.

The JAX package ``repro`` stays the reference. This package imports ``torch``
and never ``jax`` or anything of ``repro``: what it needs of the pure-Python
layers (``configs``, ``core``, ``data``, ``obs.trace``, ``runtime.fault``,
``provision``, ``pool``) it keeps as its own copies.
"""
