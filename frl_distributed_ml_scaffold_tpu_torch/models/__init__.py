"""Models of the port: GPT-2 (decode mode and training), ResNet, their
weights and generation.

``create_model(model_cfg, policy, **kw)`` dispatches on the config's
``family`` tag as the JAX package's does, for ``gpt`` and ``resnet``; the
other families raise, naming their ROADMAP item. ``kw`` goes to the
model's constructor (``device``; ``in_channels`` for a ResNet).
"""

from __future__ import annotations

from typing import Any

from frl_distributed_ml_scaffold_tpu_torch.precision import Policy


def create_model(model_cfg: Any, policy: Policy, **kw):
    family = getattr(model_cfg, "family", None)
    if family == "gpt":
        from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT

        return GPT(model_cfg, policy, **kw)
    if family == "resnet":
        from frl_distributed_ml_scaffold_tpu_torch.models.resnet import ResNet

        return ResNet(model_cfg, policy, **kw)
    if family in ("mlp", "vit", "video"):
        raise NotImplementedError(
            f"model family {family!r} is not ported yet (ROADMAP queue A "
            "item 9)")
    raise KeyError(f"unknown model family {family!r}")
