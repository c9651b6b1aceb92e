"""Typed dataclass config tree, dotted-path overrides and the recipes
the port runs (serving and training)."""

from frl_distributed_ml_scaffold_tpu_torch.config.core import (
    apply_overrides,
    config_to_dict,
    pretty_config,
)
from frl_distributed_ml_scaffold_tpu_torch.config.recipes import (
    get_config,
    list_configs,
)
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    CheckpointConfig,
    DataConfig,
    ElasticConfig,
    ExperimentConfig,
    GPTConfig,
    MeshConfig,
    MLPConfig,
    MoEConfig,
    OptimizerConfig,
    ParallelConfig,
    PrecisionConfig,
    ResNetConfig,
    ServingConfig,
    TrainerConfig,
    VideoConfig,
    ViTConfig,
)

__all__ = [
    "CheckpointConfig",
    "DataConfig",
    "ElasticConfig",
    "ExperimentConfig",
    "GPTConfig",
    "MeshConfig",
    "MLPConfig",
    "MoEConfig",
    "OptimizerConfig",
    "ParallelConfig",
    "PrecisionConfig",
    "ResNetConfig",
    "ServingConfig",
    "TrainerConfig",
    "VideoConfig",
    "ViTConfig",
    "apply_overrides",
    "config_to_dict",
    "get_config",
    "list_configs",
    "pretty_config",
]
