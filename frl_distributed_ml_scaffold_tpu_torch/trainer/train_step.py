"""The training step: the port of the JAX package's
``trainer/train_step.py`` (``make_train_step``, ``make_eval_step``).

One call of the step function takes one optimizer step:

- the fp32 master params are cast to the policy's compute dtype
  (``cast_to_compute``) once per microbatch, as fresh leaves that the
  backward differentiates, so gradients are taken with respect to the
  compute-dtype params exactly as the JAX step's ``value_and_grad`` over
  ``params_c`` takes them;
- ``grad_accum`` microbatches run forward and backward one after the
  other, their gradients summed into an fp32 accumulator; the loss,
  metrics and gradients are averaged;
- ``trainer.remat``: ``none``; ``full``, the loss under
  ``torch.utils.checkpoint`` (non-reentrant), every activation
  recomputed in the backward; ``dots``, the same with a
  selective-checkpoint policy that saves the outputs of matrix products
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and recomputes the rest, the
  counterpart of ``jax.checkpoint_policies.checkpoint_dots``. A custom
  kernel inside (flash attention) is recomputed under both, so its
  forward launches twice per layer and microbatch;
- the gradients are cast to the param dtype; ``grad_norm`` is their
  global norm BEFORE the clip; then the clip, AdamW (in place) and, with
  ``ema_decay > 0``, the EMA.

Non-parameter collections (``extras``: the ResNet's BatchNorm running
statistics) thread through the microbatches: each microbatch's forward
reads the statistics the previous one returned, as the JAX step's scan
carries them, and the state keeps the last.

The port runs on one card. ZeRO-1 (``parallel.opt_sharding=zero1``) on
one card is the replicated layout: the optimizer state is sharded over
an fsdp axis of size 1, i.e. kept whole, which is what this step does.
FSDP (``parallel.param_sharding=fsdp`` with ``mesh.fsdp=-1``, the ViT-B
and video recipes' layout) on one card is the same: an fsdp axis of one
device holds every param whole.
A mesh of more than one device, ``offload_opt_state`` and
``grad_shardings`` raise, naming ROADMAP queue A item 7. The fused AdamW
(``optimizer.name=fused_adamw``) is refused under sharded state, or a
model, expert or pipe axis above 1, with the JAX trainer's message, as
the JAX trainer refuses it when it builds its step.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from frl_distributed_ml_scaffold_tpu_torch import resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    MeshConfig,
    ParallelConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.models.dropout import mix_seed
from frl_distributed_ml_scaffold_tpu_torch.ops.fused_adamw import FusedAdamW
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy
from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
    global_norm,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState

LossFn = Callable[..., tuple[torch.Tensor, tuple[dict, Any]]]

# The matrix products whose outputs ``remat="dots"`` saves.
_DOTS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.baddbmm.default,
})


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(loss_fn: LossFn, remat: str) -> LossFn:
    if remat == "none":
        return loss_fn
    if remat == "full":
        kw = {}
    elif remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise KeyError(f"unknown remat mode {remat!r}")

    def wrapped(params, extras, batch, rng, train):
        return checkpoint(loss_fn, params, extras, batch, rng, train,
                          use_reentrant=False, **kw)

    return wrapped


def _check_one_device(mesh: MeshConfig | None) -> None:
    if mesh is None:
        return
    big = {k: n for k, n in mesh.axis_sizes().items() if n > 1}
    if big or mesh.dcn_data > 1:
        raise NotImplementedError(
            f"mesh axes {big or {'dcn_data': mesh.dcn_data}} span more than "
            "one device; the port trains on one card (ROADMAP queue A item "
            "7, sharding)"
        )


def _check_fused_optimizer(tx, parallel: ParallelConfig | None,
                           mesh: MeshConfig | None) -> None:
    """The JAX trainer's refusal of ``fused_adamw`` where its state would
    be sharded (``trainer/loop.py``)."""
    if not isinstance(tx, FusedAdamW):
        return
    parallel = parallel or ParallelConfig()
    mesh = mesh or MeshConfig()
    if (parallel.opt_sharding != "like_params"
            or parallel.param_sharding != "replicated"
            or mesh.model > 1 or mesh.expert > 1 or mesh.pipe > 1):
        raise ValueError(
            "optimizer.name=fused_adamw requires replicated state "
            "(parallel.param_sharding=replicated, "
            "opt_sharding=like_params) on a mesh with model=1, "
            "expert=1 and pipe=1; use adamw for sharded-state configs"
        )


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {
        k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
            v, np.ndarray) else v).to(dev, non_blocking=True)
        for k, v in batch.items()
    }


def make_grad_fn(loss_fn: LossFn, policy: Policy, *, grad_accum: int = 1,
                 remat: str = "none", seed: int = 0, device=None):
    """``grad_fn(params, extras, batch, step=0) -> (loss, metrics,
    extras, grads)``: the step's forward and backward without the
    update. Microbatch i of step ``step`` hands the loss the dropout seed
    ``mix_seed(seed, step, i)``, as the JAX step folds the step into its
    key and splits it per microbatch.
    ``params`` are the fp32 master params (left untouched); ``grads`` are
    averaged over the ``grad_accum`` microbatches and cast to the param
    dtype; ``loss`` and ``metrics`` are averaged 0-d fp32 tensors."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = resolve_device(device)
    wrapped = _remat_wrap(loss_fn, remat)

    def grad_fn(params: dict, extras: dict, batch: Any, step: int = 0):
        batch = _to_device(batch, dev)
        for k, x in batch.items():
            if x.shape[0] % grad_accum:
                raise ValueError(
                    f"batch dim {x.shape[0]} of {k!r} not divisible by "
                    f"grad_accum={grad_accum}"
                )
        micro = [{k: x.chunk(grad_accum)[i] for k, x in batch.items()}
                 for i in range(grad_accum)]
        acc = {k: torch.zeros(p.shape, dtype=policy.reduce_dtype,
                              device=p.device)
               for k, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        metric_sums: dict[str, torch.Tensor] = {}
        for i, mb in enumerate(micro):
            # Fresh compute-dtype leaves: the gradients are taken with
            # respect to them, as the JAX step differentiates params_c.
            params_c = policy.cast_to_compute(
                {k: p.detach() for k, p in params.items()})
            for p in params_c.values():
                p.requires_grad_()
            loss, (metrics, extras) = wrapped(params_c, extras, mb,
                                              mix_seed(seed, step, i), True)
            grads = torch.autograd.grad(loss, list(params_c.values()))
            for k, g in zip(params_c, grads):
                acc[k].add_(g.to(policy.reduce_dtype))
            loss_sum += loss.detach().float()
            for k, m in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + m.float()
            del params_c, grads
        inv = 1.0 / grad_accum
        grads = policy.cast_to_param({k: g.mul_(inv) for k, g in acc.items()})
        metrics = {k: m * inv for k, m in metric_sums.items()}
        return loss_sum * inv, metrics, extras, grads

    return grad_fn


def make_train_step(
    loss_fn: LossFn,
    tx,
    policy: Policy,
    *,
    seed: int = 0,
    grad_accum: int = 1,
    remat: str = "none",
    ema_decay: float = 0.0,
    offload_opt_state: bool = False,
    grad_shardings: Any = None,
    mesh: MeshConfig | None = None,
    parallel: ParallelConfig | None = None,
    device=None,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """The step function ``step(state, batch) -> (state, metrics)``,
    which updates ``state`` in place and returns it. ``batch`` is a dict
    of numpy arrays or tensors (moved to ``device``: ``None`` means
    ``cuda`` and raises without a card). ``seed`` (``trainer.seed``)
    seeds training dropout, one seed per step and microbatch
    (``make_grad_fn``). ``metrics`` are 0-d fp32 tensors on the device:
    the averaged loss and task metrics, and ``grad_norm`` before the
    clip. ``parallel`` and ``mesh`` are the run's sections: what the port
    cannot lay out on one card raises."""
    _check_fused_optimizer(tx, parallel, mesh)
    if offload_opt_state or grad_shardings is not None:
        raise NotImplementedError(
            "offload_opt_state and grad_shardings are not ported yet "
            "(ROADMAP queue A item 7, sharding)"
        )
    _check_one_device(mesh)
    grad_fn = make_grad_fn(loss_fn, policy, grad_accum=grad_accum,
                           remat=remat, seed=seed, device=device)

    def step_fn(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        loss, metrics, state.extras, grads = grad_fn(
            state.params, state.extras, batch, state.step)
        norm = global_norm(grads.values())
        tx.update(grads, state.opt_state, state.params, norm=norm)
        if ema_decay > 0.0:
            for k, e in state.ema_params.items():
                e.mul_(ema_decay).add_(state.params[k].to(e.dtype),
                                       alpha=1.0 - ema_decay)
        state.step += 1
        return state, {**metrics, "loss": loss, "grad_norm": norm}

    return step_fn


def make_eval_step(loss_fn: LossFn, policy: Policy, *, seed: int = 0,
                   device=None):
    """Forward-only metrics step (``device`` as in ``make_train_step``)."""
    del seed
    dev = resolve_device(device)

    def eval_fn(state: TrainState, batch: Any) -> dict:
        params_c = policy.cast_to_compute(state.params)
        with torch.no_grad():
            loss, (metrics, _) = loss_fn(params_c, state.extras,
                                         _to_device(batch, dev), None, False)
        out = dict(metrics)
        out["loss"] = loss.float()
        return out

    return eval_fn
