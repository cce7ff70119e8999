"""EventAD in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``eventad_tpu`` (JAX, the reference) with the same layout:
``config``, ``data/``, ``ops/``, ``models/``.  The package imports torch and
never jax; importing it builds no kernel (the CUDA library is compiled at
its first launch, ``ops/kernels.py``).
"""
