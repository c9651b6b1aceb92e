"""Checkpoints of the train state (``manager.py``): the port's own
format, with the JAX package's commit-marker protocol."""

from frl_distributed_ml_scaffold_tpu_torch.checkpoint.manager import (
    Checkpointer,
)

__all__ = ["Checkpointer"]
