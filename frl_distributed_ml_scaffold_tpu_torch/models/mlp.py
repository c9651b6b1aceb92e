"""MLP classifier (BASELINE config 1, the MNIST smoke-test model): the
port of the JAX package's ``models/mlp.py``.

The input flattened, ``Dense -> relu`` per hidden width, a Dense head;
products in the compute dtype, logits in ``output_dtype``. The flax
model infers its input width at init; this one is told it
(``in_features``, 784 for MNIST's 28 x 28 x 1). Training with
``dropout > 0`` is not ported and raises (the recipe trains with 0).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from frl_distributed_ml_scaffold_tpu_torch import resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import MLPConfig
from frl_distributed_ml_scaffold_tpu_torch.models.vit import refuse_dropout
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy


class MLP(nn.Module):
    """``dense.i`` is flax's ``Dense_i``. ``device=None`` means ``cuda``
    and raises without a card. Weights are uninitialised: load them
    (``models/convert.py``)."""

    def __init__(self, config: MLPConfig, policy: Policy, *,
                 in_features: int = 784, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.config, self.policy = config, policy
        widths = [in_features, *config.hidden_sizes, config.num_classes]
        self.dense = nn.ModuleList(
            nn.Linear(a, b, device=dev, dtype=policy.param_dtype)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x, *, train: bool = False):
        """``x`` [B, ...] -> logits [B, classes]."""
        refuse_dropout(self.config.dropout, train)
        cd = self.policy.compute_dtype
        x = x.reshape(x.shape[0], -1).to(cd)
        for i, lin in enumerate(self.dense):
            x = F.linear(x, lin.weight.to(cd), lin.bias.to(cd))
            if i < len(self.dense) - 1:
                x = F.relu(x)
        return x.to(self.policy.output_dtype)
