"""Kernels of the port: each a hand-written CUDA source under ``csrc/``
with its plain PyTorch version beside it in the same module."""
