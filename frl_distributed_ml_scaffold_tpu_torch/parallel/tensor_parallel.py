"""The collectives inside the forward, as autograd functions over the
current mesh (``dist/mesh.py`` ``mesh_context``), and the coordinates the
models read from it.

Megatron's two functions for a column-parallel product followed by a
row-parallel one over the ``model`` axis:

- ``copy_to_model``: the identity forward, an all-reduce of the gradient
  over ``model`` in the backward (the input of the column-parallel
  q / k / v and ``fc_in``, whose gradient every rank computes a part of);
- ``reduce_from_model``: an all-reduce over ``model`` forward, the
  identity backward (the partial sums of the row-parallel ``out`` and
  ``fc_out``).

``copy_to`` / ``reduce_from`` are the same pair over any axis: the MoE
block runs it over ``expert`` (``models/moe.py``), whose ranks see the
same rows and each compute their own experts.

``all_reduce_batch``: a sum over the batch axes whose backward is the
same sum, for the statistics of sync-BN: the gradient of the sum of
every rank's loss reaches each rank's rows through it.

Without a current mesh, or over an axis of size 1, each is the identity
and launches nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    BATCH_AXES,
    current_mesh_env,
)


def _group(axes):
    env = current_mesh_env()
    return None if env is None else env.group(axes)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group), None


def copy_to(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The identity forward, a sum over ``axis`` backward."""
    group = _group(axis)
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from(x: torch.Tensor, axis: str) -> torch.Tensor:
    """A sum over ``axis`` forward, the identity backward."""
    group = _group(axis)
    return x if group is None else _ReduceFromModel.apply(x, group)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return copy_to(x, "model")


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return reduce_from(x, "model")


def all_reduce_batch(x: torch.Tensor) -> torch.Tensor:
    group = _group(BATCH_AXES)
    return x if group is None else _AllReduceSum.apply(x, group)


def batch_group():
    """The group over the batch axes of the current mesh, or None."""
    return _group(BATCH_AXES)


def shard_of(axes) -> tuple[int, int]:
    """(this rank's index, the member count) along ``axes`` of the current
    mesh; (0, 1) without one."""
    env = current_mesh_env()
    if env is None:
        return 0, 1
    return env.axis_index(axes), env.axis_size(axes)


def batch_shard() -> tuple[int, int]:
    """This rank's share of the batch: (index, count) over the batch
    axes."""
    return shard_of(BATCH_AXES)


def model_shard() -> tuple[int, int]:
    """(index, count) along ``model``."""
    return shard_of("model")


def seq_shard() -> tuple[int, int]:
    """(index, count) along ``seq``: this rank's block of every row's
    tokens under sequence parallelism."""
    return shard_of("seq")
