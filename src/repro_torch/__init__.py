"""MoLe delivery on PyTorch and CUDA: the port of the JAX package ``repro``.

Laid out module for module like ``repro`` (``core``, ``kernels``,
``runtime``, ``launch``).  It imports ``torch`` and numpy only — never
``jax`` and nothing of ``repro`` — and its TPU kernels are hand-written CUDA
kernels for Hopper (``kernels/csrc``).  Entry points run on the card unless
the caller asks for the CPU.
"""
