"""Kernels of the port: each a hand-written CUDA source under ``csrc/``
with its plain PyTorch version beside it in the same module. Also the
plain training attention, ``dense_attention``, as the JAX package
exports it."""

from frl_distributed_ml_scaffold_tpu_torch.ops.ring_attention import (
    dense_attention,
)

__all__ = ["dense_attention"]
