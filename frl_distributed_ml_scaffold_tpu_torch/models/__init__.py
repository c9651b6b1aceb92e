"""Models of the port: the five BASELINE families (MLP, ResNet, ViT,
GPT-2 with decode mode, the video classifier), their weights and
generation.

``create_model(model_cfg, policy, **kw)`` dispatches on the config's
``family`` tag as the JAX package's does. ``kw`` goes to the model's
constructor (``device``; ``in_channels`` for a ResNet, ViT or video
classifier; ``in_features`` for an MLP).
"""

from __future__ import annotations

from typing import Any

from frl_distributed_ml_scaffold_tpu_torch.precision import Policy


def create_model(model_cfg: Any, policy: Policy, **kw):
    family = getattr(model_cfg, "family", None)
    if family == "mlp":
        from frl_distributed_ml_scaffold_tpu_torch.models.mlp import MLP

        return MLP(model_cfg, policy, **kw)
    if family == "resnet":
        from frl_distributed_ml_scaffold_tpu_torch.models.resnet import ResNet

        return ResNet(model_cfg, policy, **kw)
    if family == "vit":
        from frl_distributed_ml_scaffold_tpu_torch.models.vit import ViT

        return ViT(model_cfg, policy, **kw)
    if family == "gpt":
        from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT

        return GPT(model_cfg, policy, **kw)
    if family == "video":
        from frl_distributed_ml_scaffold_tpu_torch.models.video import (
            VideoClassifier,
        )

        return VideoClassifier(model_cfg, policy, **kw)
    raise KeyError(f"unknown model family {family!r}")
