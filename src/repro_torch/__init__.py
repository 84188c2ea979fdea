"""PyTorch/CUDA port of the ``repro`` training system, for NVIDIA Hopper.

Mirrors ``src/repro`` module for module (``core``, ``kernels``, ``nn``,
``models``, ``train``, ``data``). Every Pallas kernel on the ported path is
a hand-written CUDA kernel under ``csrc/``, built with ``nvcc`` on first use
(``kernels/build.py``); each kernel has a plain PyTorch version in
``kernels/ref.py`` that CPU tensors go to. This package imports neither
``jax`` nor ``repro``.
"""
