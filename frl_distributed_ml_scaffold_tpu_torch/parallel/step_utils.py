"""Pieces of a training step that the trainer's step (``trainer/
train_step.py``) and the pipeline schedules (``pipeline.py``,
``mpmd_pipeline.py``) share: the ``remat="dots"`` policy, moving a
host batch to the device, and the loss's mean over the batch axes."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import CheckpointPolicy

from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import LOSS_AXES

# The matrix products whose outputs ``remat="dots"`` saves.
DOTS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.baddbmm.default,
})


def save_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``: keep the
    matrix products' outputs, recompute everything else."""
    if op in DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def to_device(batch: dict, dev: torch.device) -> dict:
    return {
        k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
            v, np.ndarray) else v).to(dev, non_blocking=True)
        for k, v in batch.items()
    }


def batch_mean(values: list[torch.Tensor], layout: Any,
               scale: float) -> list[torch.Tensor]:
    """Each of ``values`` (0-d fp32 local sums) times ``scale``, summed
    over the batch axes and ``seq`` in one all-reduce and divided by
    their size (``layout`` a ``StateLayout`` or None)."""
    group = None if layout is None else layout.env.group(LOSS_AXES)
    if group is None:
        return [v * scale for v in values]
    packed = torch.stack(values)
    dist.all_reduce(packed, group=group)
    packed *= scale / layout.env.loss_axis_size
    return list(packed.unbind())
