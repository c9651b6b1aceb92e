"""Mixed-precision policies as torch dtypes.

The same three policies as the JAX package: params stored in
``param_dtype`` and cast to ``compute_dtype`` where they are used;
LayerNorm and softmax always run in fp32 (models/gpt.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from frl_distributed_ml_scaffold_tpu_torch.config.schema import PrecisionConfig


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32  # loss/logits dtype
    reduce_dtype: torch.dtype = torch.float32


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
