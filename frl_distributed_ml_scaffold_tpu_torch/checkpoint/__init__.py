"""Checkpoints of the train state (``manager.py``): the port's own
format, with the JAX package's commit-marker protocol; and flax's
msgpack params files (``flax_msgpack.py``), which
``trainer.init_params_path`` starts a run from."""

from frl_distributed_ml_scaffold_tpu_torch.checkpoint.manager import (
    Checkpointer,
)

__all__ = ["Checkpointer"]
