"""Ulysses sequence parallelism: the port of the JAX package's
``ops/ulysses.py``.

Under ``seq = n`` rank r holds every row's tokens ``[r T/n, (r+1)
T/n)``. One ``all_to_all`` over ``seq`` (``dist/collectives.py``) turns
the token split into a head split: (B, T/n, H, D) becomes (B, T, H/n, D),
every token of ``H/n`` heads. The attention over them is the port's
``flash_attention`` (the forward, dQ and dK/dV kernels at full T on the
card), and a second ``all_to_all`` turns the heads back into tokens. The
backward runs the two exchanges the other way round. Heads are this
rank's after the ``model`` split, so they must divide over ``seq``.
Over a ``seq`` axis of size 1, or without a mesh, it is
``dense_attention``, as in the reference.
"""

from __future__ import annotations

import torch

from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import current_mesh_env
from frl_distributed_ml_scaffold_tpu_torch.ops.ring_attention import (
    dense_attention,
)


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` over ``axis``, chunks of ``split`` to the members and
    what arrives concatenated along ``concat``; the backward the other
    way."""

    @staticmethod
    def forward(ctx, x, axis, split, concat):
        from frl_distributed_ml_scaffold_tpu_torch.dist.collectives import (
            all_to_all,
        )

        ctx.args = (axis, split, concat)
        return all_to_all(x, axis, split_axis=split, concat_axis=concat)

    @staticmethod
    def backward(ctx, dy):
        from frl_distributed_ml_scaffold_tpu_torch.dist.collectives import (
            all_to_all,
        )

        axis, split, concat = ctx.args
        return (all_to_all(dy, axis, split_axis=concat, concat_axis=split),
                None, None, None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis_name: str = "seq", causal: bool = True
                      ) -> torch.Tensor:
    """(B, T/n, H, D) attention over this rank's block of the tokens, the
    tokens split over ``axis_name`` of the current mesh and ``H`` this
    rank's heads (module docstring); differentiable."""
    from frl_distributed_ml_scaffold_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    env = current_mesh_env()
    if env is None or env.axis_size(axis_name) == 1:
        return dense_attention(q, k, v, causal=causal)
    n = env.axis_size(axis_name)
    tp = env.axis_size("model")
    heads = q.shape[2] * tp  # q holds this rank's heads of the model split
    if heads % tp != 0 or (heads // tp) % n != 0:
        raise ValueError(
            f"ulysses needs num_heads/model_axis ({heads}/{tp}) "
            f"divisible by seq axis ({n}); use ring attention instead"
        )

    def to_heads(x):  # (B, T/n, H, D) -> (B, T, H/n, D)
        return _AllToAll.apply(x, axis_name, 2, 1)

    out = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal)
    return _AllToAll.apply(out, axis_name, 1, 2)  # back to the tokens
