"""Typed dataclass config tree, dotted-path overrides and the recipes of
the serving slice."""

from frl_distributed_ml_scaffold_tpu_torch.config.core import apply_overrides
from frl_distributed_ml_scaffold_tpu_torch.config.recipes import get_config
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    ExperimentConfig,
    GPTConfig,
    MoEConfig,
    PrecisionConfig,
    ServingConfig,
)

__all__ = [
    "ExperimentConfig",
    "GPTConfig",
    "MoEConfig",
    "PrecisionConfig",
    "ServingConfig",
    "apply_overrides",
    "get_config",
]
