"""Typed dataclass config tree, dotted-path overrides and the recipes
the port runs (serving and training)."""

from frl_distributed_ml_scaffold_tpu_torch.config.core import apply_overrides
from frl_distributed_ml_scaffold_tpu_torch.config.recipes import get_config
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    DataConfig,
    ExperimentConfig,
    GPTConfig,
    MeshConfig,
    MoEConfig,
    OptimizerConfig,
    ParallelConfig,
    PrecisionConfig,
    ResNetConfig,
    ServingConfig,
    TrainerConfig,
)

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "GPTConfig",
    "MeshConfig",
    "MoEConfig",
    "OptimizerConfig",
    "ParallelConfig",
    "PrecisionConfig",
    "ResNetConfig",
    "ServingConfig",
    "TrainerConfig",
    "apply_overrides",
    "get_config",
]
