"""Video-clip classifier (BASELINE config 5, the Ego4D-style recipe): the
port of the JAX package's ``models/video.py``.

A tubelet ViT: the clip's non-overlapping (t, h, w) tubelets, flattened
in ``(t, h, w, c)`` order, embedded by one product (the JAX model's
``nn.Conv`` whose stride is its kernel), the tokens row-major over the
``(T', H', W')`` grid; a learned position embedding, the ViT's encoder
blocks, the final LayerNorm, mean pooling and a Dense head, with the
ViT's numerics (``models/vit.py``).
"""

from __future__ import annotations

import math

from frl_distributed_ml_scaffold_tpu_torch.config.schema import VideoConfig
from frl_distributed_ml_scaffold_tpu_torch.models.vit import (
    TokenClassifier,
    patchify,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy


class VideoClassifier(TokenClassifier):
    """Over clips [B, T, H, W, C] of ``in_channels`` channels.
    ``device=None`` means ``cuda`` and raises without a card. Weights are
    uninitialised: load them (``models/convert.py``)."""

    def __init__(self, config: VideoConfig, policy: Policy, *,
                 in_channels: int = 3, tp_overlap=None, device=None):
        tt, th, tw = config.tubelet_size
        tokens = ((config.num_frames // tt) * (config.image_size // th)
                  * (config.image_size // tw))
        super().__init__(config, policy,
                         patch_features=math.prod(config.tubelet_size)
                         * in_channels,
                         tokens=tokens, cls_token=False, device=device)
        self.attach(tp_overlap=tp_overlap)

    def forward(self, x, *, train: bool = False, rng: int | None = None):
        """``x`` [B, T, H, W, C] -> logits [B, classes]."""
        x = patchify(x.to(self.policy.compute_dtype),
                     tuple(self.config.tubelet_size))
        return self.classify(x, pool="mean", train=train, rng=rng)
