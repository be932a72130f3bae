"""PyTorch/CUDA port of ``nnal_tpu`` for NVIDIA Hopper.

Mirrors ``nnal_tpu``'s layout; imports ``torch`` and never ``jax`` or
``nnal_tpu``.  The two Pallas kernels of the JAX package are CUDA C++
kernels under ``csrc/`` (bound in ``ops/``).
"""
