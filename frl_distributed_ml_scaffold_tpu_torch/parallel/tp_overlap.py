"""Tensor parallelism on the collective-matmul rings: the port of the JAX
package's ``parallel/tp_overlap.py``.

Under ``parallel.tp_overlap`` the four per-block ``model`` products
(q / k / v, ``out``, ``fc_in``, ``fc_out``) run as the bidirectional
rings of ``ops/collective_matmul.py`` in place of the Megatron pair
(``parallel/tensor_parallel.py`` ``copy_to_model`` /
``reduce_from_model``):

- between the rings the residual stream is sharded over ``model``:
  along the tokens for the GPT stack (``chunk_axis=1``, Megatron
  sequence parallelism) and along the batch for ViT and the video
  classifier (``chunk_axis=0``: their token count does not divide);
- the column-parallel products take it through ``all_gather_matmul``
  (the q / k / v trio shares one ring: the first returns the gathered
  copy, and k and v take a local product of it, ``quantized_matmul``
  under ``lowp``);
- the row-parallel products give it back through
  ``matmul_reduce_scatter``.

The model enters the sharded stream with ``scatter`` (this rank's
chunk; the backward all-gathers the gradient, so the embedding's
gradient is whole on every rank) and leaves it with ``gather`` before
the head (the backward keeps this rank's chunk, every rank computing
the same loss). The parameters used on the sharded stream (the
LayerNorms, ``out`` and ``fc_out``'s biases) then take a part of their
gradient on each ``model`` rank: the step sums them over ``model``
(``parallel/layout.py`` ``StateLayout.with_overlap``).

``make_tp_hooks`` builds the hooks for a resolved mesh with the
reference's checks, word for word; a mesh whose ``model`` axis is 1
raises, as there is no ring to build.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from frl_distributed_ml_scaffold_tpu_torch.dist import collectives
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import current_mesh_env
from frl_distributed_ml_scaffold_tpu_torch.ops.collective_matmul import (
    all_gather_matmul,
    matmul_reduce_scatter,
)
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
    quantized_matmul,
)

#: Model families with collective-matmul hooks wired up.
SUPPORTED_FAMILIES = ("gpt", "vit", "video")

#: The parameters of a block whose gradient each ``model``
#: rank takes a part of (used on the sharded stream), in every family.
STREAM_PARAMS = (r"^blocks\.\d+\.ln[12]\.(weight|bias)$",
                 r"^blocks\.\d+\.attn\.out\.bias$",
                 r"^blocks\.\d+\.mlp\.fc_out\.bias$")


class _Scatter(torch.autograd.Function):
    """This rank's chunk along ``dim`` over ``axis``; the backward
    all-gathers the gradient (every rank's chunk of it)."""

    @staticmethod
    def forward(ctx, x, axis, dim, env):
        n, i = env.axis_size(axis), env.axis_index(axis)
        ctx.meta = (axis, dim, env, x.shape[dim])
        c = x.shape[dim] // n
        return x.narrow(dim, i * c, c).contiguous()

    @staticmethod
    def backward(ctx, dy):
        axis, dim, env, full = ctx.meta
        return (collectives.all_gather_dim(dy.contiguous(), axis, dim, full,
                                           env=env), None, None, None)


class _Gather(torch.autograd.Function):
    """The whole tensor along ``dim`` from every rank's chunk over
    ``axis``; the backward keeps this rank's chunk of the gradient (each
    rank computed the same whole loss from it)."""

    @staticmethod
    def forward(ctx, x, axis, dim, env):
        n, i = env.axis_size(axis), env.axis_index(axis)
        ctx.meta = (dim, i, x.shape[dim])
        return collectives.all_gather_dim(x.contiguous(), axis, dim,
                                          n * x.shape[dim], env=env)

    @staticmethod
    def backward(ctx, dy):
        dim, i, c = ctx.meta
        return dy.narrow(dim, i * c, c), None, None, None


@dataclass(frozen=True)
class TpHooks:
    """The collective-matmul schedule of one model family.
    ``chunk_axis``: the activation dim the residual stream shards over
    ``axis`` (1, tokens, for GPT; 0, batch, for ViT / video). ``lowp``:
    the rings' low-precision format, or None."""

    axis: str = "model"
    chunk_axis: int = 1
    lowp: str | None = None

    def _env(self):
        env = current_mesh_env()
        if env is None or env.axis_size(self.axis) <= 1:
            return None
        return env

    # ------------------------------------------------------ the stream

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Enter the sharded stream: this rank's chunk of ``x``."""
        env = self._env()
        if env is None:
            return x
        n = env.axis_size(self.axis)
        if x.shape[self.chunk_axis] % n:
            raise ValueError(
                f"parallel.tp_overlap: dim {self.chunk_axis} of "
                f"{tuple(x.shape)} does not divide by mesh.{self.axis}={n}")
        return _Scatter.apply(x, self.axis, self.chunk_axis, env)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Leave the sharded stream: the whole ``x`` on every rank."""
        env = self._env()
        if env is None:
            return x
        return _Gather.apply(x, self.axis, self.chunk_axis, env)

    # ------------------------------------------------------ the products

    def column(self, x, weight, bias=None):
        """Column-parallel product of the sharded stream ``x`` and this
        rank's ``weight [M_local, K]`` (``[out, in]``): the gather ring.
        Returns ``[.., gathered, .., M_local]``."""
        env = self._env()
        if env is None:
            y = torch.matmul(x, weight.t())
        else:
            y = all_gather_matmul(x, weight.t(), self.axis, self.chunk_axis,
                                  lowp=self.lowp, env=env)
        return y if bias is None else y + bias

    def row(self, y, weight, bias=None):
        """Row-parallel product of ``y`` (gathered, this rank's feature
        slice) and ``weight [K, M_local]``: the rotating ring, giving
        this rank's chunk of the sharded stream."""
        env = self._env()
        if env is None:
            z = torch.matmul(y, weight.t())
        else:
            z = matmul_reduce_scatter(y, weight.t(), self.axis,
                                      self.chunk_axis, lowp=self.lowp,
                                      env=env)
        return z if bias is None else z + bias

    def qkv(self, x, linears, dtype):
        """The q / k / v trio of one attention call on one ring: the
        first product streams ``x`` and returns the gathered copy, the
        other two take a local product of it (quantized under
        ``lowp``). ``linears``: the three ``nn.Linear`` (this rank's
        column split); returns their outputs."""
        env = self._env()
        ws = [lin.weight.to(dtype) for lin in linears]
        bs = [lin.bias.to(dtype) for lin in linears]
        if env is None:
            return [torch.matmul(x, w.t()) + b for w, b in zip(ws, bs)]
        y, full = all_gather_matmul(x, ws[0].t(), self.axis, self.chunk_axis,
                                    return_full=True, lowp=self.lowp,
                                    env=env)
        outs = [y + bs[0]]
        for w, b in zip(ws[1:], bs[1:]):
            if self.lowp is not None:
                outs.append(quantized_matmul(full, w.t(), self.lowp) + b)
            else:
                outs.append(torch.matmul(full, w.t()) + b)
        return outs


# ------------------------------------------------------------- validation


def validate_ring_schedule(cfg, *, lowp: str | None = None) -> None:
    """Refuse the configs the collective-matmul schedule cannot honor
    (the reference's checks and words)."""
    family = getattr(cfg.model, "family", None)
    if family not in SUPPORTED_FAMILIES:
        raise ValueError(
            f"parallel.tp_overlap=true: model family {family!r} has no "
            f"collective-matmul hooks (supported: {SUPPORTED_FAMILIES})"
        )
    if (
        getattr(cfg.model, "pipeline_stages", 1) > 1
        and getattr(cfg.model, "pipeline_impl", "spmd") != "mpmd"
    ):
        raise ValueError(
            "parallel.tp_overlap composes with data/fsdp/model meshes but "
            "not with the SPMD pipeline backend (the stage-vmap path owns "
            "its own block schedule); set model.pipeline_stages=1 or "
            "model.pipeline_impl='mpmd'"
        )
    if cfg.parallel.sequence != "none" or cfg.mesh.seq > 1:
        raise ValueError(
            "parallel.tp_overlap owns the token dim's model-axis sharding; "
            "it does not compose with sequence parallelism "
            "(parallel.sequence, mesh.seq)"
        )
    if getattr(cfg.model, "attention", "dense") not in ("dense", "flash"):
        raise ValueError(
            "parallel.tp_overlap requires attention='dense'|'flash' "
            f"(got {cfg.model.attention!r}: ring/ulysses reshard the token "
            "dim themselves)"
        )
    moe = getattr(cfg.model, "moe", None)
    if moe is not None and moe.num_experts > 0:
        raise ValueError(
            "parallel.tp_overlap: the MoE MLP has no collective-matmul "
            "hooks (its dispatch owns the token exchange); set "
            "model.moe.num_experts=0"
        )
    if lowp is not None:
        from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
            lowp_dtype,
        )

        lowp_dtype(lowp)  # KeyError (with the vocabulary) on typos


def make_tp_hooks(cfg, env) -> TpHooks:
    """The hooks for a resolved mesh, with the checks only the mesh can
    make (axis size, divisibility; the reference's words). ``lowp``
    comes from the config's resolved schedule."""
    from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
        resolve_lowp,
    )
    from frl_distributed_ml_scaffold_tpu_torch.parallel.schedule import (
        schedule_from_config,
    )

    sched = schedule_from_config(cfg)
    ring = sched.ring_gather() if sched is not None else None
    lowp = (
        ring.lowp if ring is not None
        else resolve_lowp(getattr(cfg.parallel, "low_precision", "none"))
    )
    validate_ring_schedule(cfg, lowp=lowp)
    m = env.axis_size("model")
    if m <= 1:
        raise ValueError(
            "parallel.tp_overlap=true requires mesh.model > 1 (the "
            f"resolved model axis is {m}); there is no TP communication "
            "to hide on this mesh"
        )
    family = cfg.model.family
    d = cfg.model.hidden_dim
    if d % m != 0 or (d * cfg.model.mlp_ratio) % m != 0:
        raise ValueError(
            f"parallel.tp_overlap: model.hidden_dim={d} (and mlp width "
            f"{d * cfg.model.mlp_ratio}) must divide by mesh.model={m} — "
            "the collective-matmul rings split the Megatron feature dims "
            "exactly, without GSPMD's padding"
        )
    if family == "gpt":
        if cfg.model.seq_len % m != 0:
            raise ValueError(
                f"parallel.tp_overlap: model.seq_len={cfg.model.seq_len} "
                f"must divide by mesh.model={m} (the residual stream is "
                "sequence-sharded over the model axis)"
            )
        return TpHooks(axis="model", chunk_axis=1, lowp=lowp)
    per_shard = (
        env.axis_size("data") * env.axis_size("fsdp") * m
        * cfg.trainer.grad_accum
    )
    if cfg.data.global_batch_size % per_shard != 0:
        raise ValueError(
            "parallel.tp_overlap: "
            f"data.global_batch_size={cfg.data.global_batch_size} must "
            f"divide by data*fsdp*model*grad_accum={per_shard} (the "
            f"{family} residual stream is batch-sharded over the model axis)"
        )
    return TpHooks(axis="model", chunk_axis=0, lowp=lowp)


def stream_param_names(names) -> frozenset[str]:
    """The parameters of ``names`` that the blocks use on the sharded
    stream (``STREAM_PARAMS``)."""
    return frozenset(n for n in names
                     if any(re.search(p, n) for p in STREAM_PARAMS))
