"""Mixed-precision policies as torch dtypes.

The same three policies as the JAX package: params stored in
``param_dtype`` and cast to ``compute_dtype`` where they are used;
LayerNorm and softmax always run in fp32 (models/gpt.py). The training
step casts whole parameter dicts with ``cast_to_compute`` /
``cast_to_param`` (trainer/train_step.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from frl_distributed_ml_scaffold_tpu_torch.config.schema import PrecisionConfig


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32  # loss/logits dtype
    reduce_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree: Any) -> Any:
        return _cast_floats(tree, self.compute_dtype)

    def cast_to_param(self, tree: Any) -> Any:
        return _cast_floats(tree, self.param_dtype)

    def cast_to_output(self, tree: Any) -> Any:
        return _cast_floats(tree, self.output_dtype)


def _cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of a dict / list / tuple tree cast to
    ``dtype`` (a tensor already of that dtype is returned as it is);
    integer tensors and other leaves pass through."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


_POLICIES = {
    # Full fp32: the numerics reference.
    "fp32": Policy(),
    # Pure bf16: params also bf16.
    "bf16": Policy(
        param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        output_dtype=torch.bfloat16,
        reduce_dtype=torch.float32,
    ),
    # fp32 master params, bf16 compute.
    "bf16_mixed": Policy(
        param_dtype=torch.float32,
        compute_dtype=torch.bfloat16,
        output_dtype=torch.float32,
        reduce_dtype=torch.float32,
    ),
}


def get_policy(cfg: PrecisionConfig | str) -> Policy:
    name = cfg if isinstance(cfg, str) else cfg.policy
    if name not in _POLICIES:
        raise KeyError(
            f"unknown precision policy {name!r}; have {sorted(_POLICIES)}"
        )
    return _POLICIES[name]
