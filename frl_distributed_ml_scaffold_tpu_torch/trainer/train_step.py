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

With a ``layout`` (``parallel/layout.py``; the ``Trainer`` builds it
from the run's mesh, ``parallel`` and the model's partition rules) the
step runs on every rank of the mesh, each on its rows of the global
batch and its shards of the state:

- the params are gathered from their stored spec to the compute spec
  once per step (an all-gather over ``fsdp``; a ``model`` split the
  model reads whole is gathered too), and the forward and backward run
  on plain local tensors, the model's own tensor-parallel products and
  sync-BN taking part in their collectives; under the overlap schedule
  the blocks' FSDP shards are not gathered here (the model gathers them
  block by block and its backward reduce-scatters their gradients), and
  the gradients of the parameters used on the ``model``-sharded stream
  are summed over ``model`` at the end (``StateLayout.with_overlap``);
- each microbatch's gradient is reduce-scattered into the accumulator
  under FSDP, which stays in the params' spec; otherwise it accumulates
  locally and is reduced once; then it is summed over the batch axes
  into the optimizer state's spec and divided by the batch-axis size,
  the gradient of the global batch's mean loss;
- the loss and the metrics are the global batch's means (one all-reduce
  over the batch axes);
- ``grad_norm`` sums each shard's squares over the axes its tensor is
  split on, so a replicated tensor counts once;
- the optimizer updates this rank's part of the params (its ``zero1``
  slice of a replicated param, a view), and a param whose state is
  split finer than it is all-gathered back.

``offload_opt_state`` keeps the optimizer state in pinned host memory:
each update brings one leaf's state in (a ``non_blocking`` copy), updates
it and writes it back the same way, so the card holds one leaf's state
at a time, not the tree's (a group of leaves for Adafactor, which
reduces over a JAX leaf's group). The state a step is handed on the card
(a fresh or a restored one) moves to pinned host memory at its first
update. The update is the same arithmetic on the same card, so the
losses are those of the resident state, bit for bit. On the CPU it
raises a ``ValueError``, as the JAX trainer refuses a backend without
``pinned_host`` memory. Adafactor over split state (``layout``) reduces
over whole leaves (``trainer/optimizers.py``).

A mesh of more than one device needs a ``layout``. ``grad_shardings``
raises: the accumulator's spec is the layout's. The fused AdamW
(``optimizer.name=fused_adamw``) is refused under sharded state, or a
model, expert or pipe axis above 1, with the JAX trainer's message, as
the JAX trainer refuses it when it builds its step. Axes ``seq``,
``expert`` and ``pipe`` above 1 raise, naming ROADMAP A12.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
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
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    BATCH_AXES,
    mesh_context,
    resolve_axis_sizes,
)
from frl_distributed_ml_scaffold_tpu_torch.models.dropout import mix_seed
from frl_distributed_ml_scaffold_tpu_torch.ops.fused_adamw import FusedAdamW
from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import StateLayout
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy
from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
    Adafactor,
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


def check_mesh(mesh: MeshConfig | None, layout: StateLayout | None) -> None:
    """Refuse the axes the step does not port (``seq``, ``expert``,
    ``pipe`` above 1) and a mesh of more than one device without a
    layout."""
    if mesh is None:
        return
    sizes = mesh.axis_sizes()
    big = {k: sizes[k] for k in ("seq", "expert", "pipe") if sizes[k] > 1}
    if big:
        raise NotImplementedError(
            f"mesh axes {big}: sequence, expert and pipeline parallelism "
            "are not ported yet (ROADMAP A12)")
    n = 1 if layout is None else layout.env.num_devices
    resolve_axis_sizes(mesh, n)  # raises when the mesh needs more devices


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


def _batch_mean(values: list[torch.Tensor], layout: StateLayout | None,
                scale: float) -> list[torch.Tensor]:
    """Each of ``values`` (0-d fp32 local sums) times ``scale``, summed
    over the batch axes in one all-reduce and divided by their size."""
    group = None if layout is None else layout.env.group(BATCH_AXES)
    if group is None:
        return [v * scale for v in values]
    packed = torch.stack(values)
    dist.all_reduce(packed, group=group)
    packed *= scale / layout.env.batch_axis_size
    return list(packed.unbind())


OFFLOAD_REFUSAL = (
    "trainer.offload_opt_state=true keeps the optimizer state in pinned "
    "host memory and streams it to the card for each update (platform="
    "{platform!r}); the CPU has no pinned_host memory apart from the one "
    "it computes in: run it on a card"
)


def check_offload(device) -> None:
    """The refusal of ``offload_opt_state`` off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(OFFLOAD_REFUSAL.format(platform=dev.type))


def offload_state(opt_state: dict) -> dict:
    """``opt_state`` with every tensor in pinned host memory (in place:
    the same dicts; tensors already there stay)."""
    for key, v in opt_state.items():
        if isinstance(v, dict):
            for k, t in v.items():
                if t.device.type != "cpu" or not t.is_pinned():
                    v[k] = t.to("cpu").pin_memory()
    return opt_state


def _offloaded_update(tx, grads: dict, opt_state: dict, params: dict,
                      norm: torch.Tensor, dev: torch.device) -> None:
    """``tx.update`` over a pinned host-memory state (module docstring):
    one group of leaves at a time in, updated, and back out."""
    offload_state(opt_state)
    leaf_of = getattr(tx, "leaf_of", None) or (lambda k: k)
    groups: dict[str, list[str]] = {}
    for k in params:
        groups.setdefault(leaf_of(k), []).append(k)
    count = opt_state["count"]
    for names in groups.values():
        sub = {key: ({k: v[k].to(dev, non_blocking=True) for k in names}
                     if isinstance(v, dict) else v)
               for key, v in opt_state.items()}
        tx.update({k: grads[k] for k in names}, sub,
                  {k: params[k] for k in names}, norm=norm)
        for key, v in sub.items():
            if not isinstance(v, dict):
                continue
            for k, t in v.items():
                host = opt_state[key][k]
                if host.dtype != t.dtype or host.shape != t.shape:
                    # Adafactor's moments take the param dtype.
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                    opt_state[key][k] = host
                host.copy_(t, non_blocking=True)
        del sub
    opt_state["count"] = count + 1
    # The host copies are complete before anything reads them.
    torch.cuda.current_stream(dev).synchronize()


def make_grad_fn(loss_fn: LossFn, policy: Policy, *, grad_accum: int = 1,
                 remat: str = "none", seed: int = 0,
                 layout: StateLayout | None = None, device=None):
    """``grad_fn(params, extras, batch, step=0) -> (loss, metrics,
    extras, grads)``: the step's forward and backward without the
    update. Microbatch i of step ``step`` hands the loss the dropout seed
    ``mix_seed(seed, step, i)``, as the JAX step folds the step into its
    key and splits it per microbatch.
    ``params`` are the fp32 master params (left untouched); ``grads`` are
    averaged over the ``grad_accum`` microbatches and cast to the param
    dtype; ``loss`` and ``metrics`` are averaged 0-d fp32 tensors. With a
    ``layout``, ``params`` are this rank's shards, ``batch`` its rows,
    ``grads`` the global batch's, under the optimizer state's spec, and
    ``loss`` and ``metrics`` the global batch's (module docstring)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = resolve_device(device)
    wrapped = _remat_wrap(loss_fn, remat)
    scatter = ({} if layout is None else
               {k: layout.scatter_axes(k) for k in layout.shapes})

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
        if layout is None:
            full, acc_shape = params, {k: p.shape for k, p in params.items()}
        else:
            full = {k: layout.gather(k, p, layout.param[k], layout.compute[k])
                    for k, p in params.items()}
            acc_shape = {k: layout.local_shape(k, layout.accum[k])
                         for k in params}
        acc = {k: torch.zeros(acc_shape[k], dtype=policy.reduce_dtype,
                              device=p.device)
               for k, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        metric_sums: dict[str, torch.Tensor] = {}
        for i, mb in enumerate(micro):
            # Fresh compute-dtype leaves: the gradients are taken with
            # respect to them, as the JAX step differentiates params_c.
            params_c = policy.cast_to_compute(
                {k: p.detach() for k, p in full.items()})
            for p in params_c.values():
                p.requires_grad_()
            loss, (metrics, extras) = wrapped(params_c, extras, mb,
                                              mix_seed(seed, step, i), True)
            grads = torch.autograd.grad(loss, list(params_c.values()))
            for k, g in zip(params_c, grads):
                g = g.to(policy.reduce_dtype)
                if layout is not None and scatter[k]:
                    g = layout.reduce(k, g, layout.compute[k],
                                      layout.accum[k], scatter[k])
                acc[k].add_(g)
            loss_sum += loss.detach().float()
            for k, m in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + m.float()
            del params_c, grads
        del full
        inv = 1.0 / grad_accum
        names = list(metric_sums)
        loss, *ms = _batch_mean([loss_sum] + [metric_sums[k] for k in names],
                                layout, inv)
        metrics = dict(zip(names, ms))
        if layout is not None:
            inv /= layout.env.batch_axis_size
            acc = {k: layout.reduce(k, g, layout.accum[k], layout.opt[k],
                                    layout.step_sum_axes(k))
                   for k, g in acc.items()}
        grads = policy.cast_to_param({k: g.mul_(inv) for k, g in acc.items()})
        return loss, metrics, extras, grads

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
    layout: StateLayout | None = None,
    device=None,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """The step function ``step(state, batch) -> (state, metrics)``,
    which updates ``state`` in place and returns it. ``batch`` is a dict
    of numpy arrays or tensors (moved to ``device``: ``None`` means
    ``cuda`` and raises without a card). ``seed`` (``trainer.seed``)
    seeds training dropout, one seed per step and microbatch
    (``make_grad_fn``). ``metrics`` are 0-d fp32 tensors on the device:
    the averaged loss and task metrics, and ``grad_norm`` before the
    clip. ``parallel`` and ``mesh`` are the run's sections, ``layout``
    the state's specs over the run's mesh (module docstring)."""
    _check_fused_optimizer(tx, parallel, mesh)
    if offload_opt_state:
        check_offload(resolve_device(device))
    if grad_shardings is not None:
        raise ValueError(
            "grad_shardings: the port's accumulator takes the layout's "
            "specs (the params' under parallel.param_sharding=fsdp); pass "
            "layout="
        )
    check_mesh(mesh, layout)
    if isinstance(tx, Adafactor) and layout is not None:
        tx.layout = None if layout.trivial else layout
    grad_fn = make_grad_fn(loss_fn, policy, grad_accum=grad_accum,
                           remat=remat, seed=seed, layout=layout,
                           device=device)
    env = None if layout is None else layout.env
    regather = ([] if layout is None else
                [k for k in layout.shapes if layout.opt[k] != layout.param[k]])

    def step_fn(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        with mesh_context(env):
            loss, metrics, state.extras, grads = grad_fn(
                state.params, state.extras, batch, state.step)
        if layout is None:
            norm, params = global_norm(grads.values()), state.params
        else:
            norm = layout.global_sq_norm(grads, layout.opt).sqrt()
            params = {k: layout.narrow(k, p, layout.param[k], layout.opt[k])
                      for k, p in state.params.items()}
        if offload_opt_state:
            _offloaded_update(tx, grads, state.opt_state, params, norm,
                              norm.device)
        else:
            tx.update(grads, state.opt_state, params, norm=norm)
        for k in regather:
            layout.gather(k, params[k], layout.opt[k], layout.param[k],
                          out=state.params[k])
        if ema_decay > 0.0:
            for k, e in state.ema_params.items():
                e.mul_(ema_decay).add_(state.params[k].to(e.dtype),
                                       alpha=1.0 - ema_decay)
        state.step += 1
        return state, {**metrics, "loss": loss, "grad_norm": norm}

    return step_fn


def make_eval_step(loss_fn: LossFn, policy: Policy, *, seed: int = 0,
                   layout: StateLayout | None = None, device=None):
    """Forward-only metrics step (``device`` as in ``make_train_step``);
    with a ``layout``, on this rank's rows, the metrics the global
    batch's means."""
    del seed
    dev = resolve_device(device)
    env = None if layout is None else layout.env

    def eval_fn(state: TrainState, batch: Any) -> dict:
        params = state.params
        if layout is not None:
            params = {k: layout.gather(k, p, layout.param[k],
                                       layout.compute[k])
                      for k, p in params.items()}
        params_c = policy.cast_to_compute(params)
        with torch.no_grad(), mesh_context(env):
            loss, (metrics, _) = loss_fn(params_c, state.extras,
                                         _to_device(batch, dev), None, False)
        names = list(metrics)
        loss, *ms = _batch_mean([loss.float()] + [metrics[k].float()
                                                  for k in names], layout, 1.0)
        out = dict(zip(names, ms))
        out["loss"] = loss
        return out

    return eval_fn
