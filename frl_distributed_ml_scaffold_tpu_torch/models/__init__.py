"""Models of the port: the five BASELINE families (MLP, ResNet, ViT,
GPT-2 with decode mode, the video classifier), their weights and
generation.

``create_model(model_cfg, policy, **kw)`` dispatches on the config's
``family`` tag as the JAX package's does. ``kw`` goes to the model's
constructor (``device``; ``in_channels`` for a ResNet, ViT or video
classifier; ``in_features`` for an MLP). ``jax_leaf_of(model_cfg)``
maps the family's parameter names to the JAX leaves they belong to.
"""

from __future__ import annotations

from typing import Any, Callable

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


def _own_leaf(name: str) -> str:
    return name


def jax_leaf_of(model_cfg: Any) -> Callable[[str], str]:
    """The JAX leaf each parameter name of ``model_cfg``'s family belongs
    to, for an optimizer that reduces over a whole leaf (Adafactor's
    block RMS and parameter scale). The JAX GPT scans its blocks, so a
    layer's block parameters share one stacked leaf there
    (``gpt.stacked_name``); the other families' parameters, and a plain
    dict of parameters (``model_cfg`` None), are each their own leaf."""
    if getattr(model_cfg, "family", None) == "gpt":
        from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
            stacked_name,
        )

        return stacked_name
    return _own_leaf
