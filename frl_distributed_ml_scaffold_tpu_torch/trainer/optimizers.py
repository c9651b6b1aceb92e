"""Optimizer and LR schedule: the port of the JAX package's
``trainer/optimizers.py`` for ``adamw`` and ``sgd`` (each with the
optional global-norm clip) and ``fused_adamw`` under the ``constant``,
``cosine``, ``linear`` and ``wsd`` schedules with linear warmup.

The updates are optax's, written out:

- ``clip_by_global_norm(max)``: ``g`` unchanged while the global norm is
  below ``max``, else ``(g / norm) * max``, with no epsilon (not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm);
- ``adamw``: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
  bias-corrected at the incremented count, ``u = mu_hat / (sqrt(nu_hat)
  + eps) + wd * p`` on EVERY leaf (``optax.adamw`` runs with no mask),
  then ``p += -lr(count) * u`` with the schedule read at the count
  BEFORE it increments, so a warmup's first step (lr 0) leaves the
  params unchanged;
- ``sgd``: ``add_decayed_weights(wd)`` (``g + wd * p``, when wd != 0),
  then optax's nesterov ``trace`` (``t = g + m t``, ``u = g + m t``),
  then ``p += -lr(count) * u``, the count read as above;
- ``fused_adamw``: ``ops/fused_adamw.py`` ``FusedAdamW``, one pass per
  leaf (the hand-written kernel on the card); with a grad clip it is
  refused, as the JAX factory refuses it.

The updates work in place on fp32 tensors (params and optimizer state):
the JAX step donates its state, and in place is what keeps one copy of
them live. The other optimizers raise, naming ROADMAP queue A item 10.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    OptimizerConfig,
    TrainerConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.ops.fused_adamw import FusedAdamW

Schedule = Callable[[int], float]


def _constant(value: float) -> Schedule:
    return lambda count: value


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: the polynomial schedule of power 1."""
    if steps <= 0:
        return _constant(init)

    def schedule(count):
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return schedule


def _cosine(init: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""

    def schedule(count):
        c = min(count, decay_steps)
        return init * (0.5 * (1 + math.cos(math.pi * c / decay_steps)))

    return schedule


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """optax.join_schedules: each schedule sees the steps since its
    boundary."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def make_schedule(cfg: OptimizerConfig, total_steps: int) -> Schedule:
    """The learning rate at each optimizer count, as the JAX package's
    ``make_schedule`` builds it from optax's schedules."""
    base = cfg.learning_rate
    decay_steps = max(total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        sched = _constant(base)
    elif cfg.schedule == "cosine":
        sched = _cosine(base, decay_steps)
    elif cfg.schedule == "linear":
        sched = _linear(base, 0.0, decay_steps)
    elif cfg.schedule == "wsd":
        decay = max(int(decay_steps * cfg.wsd_decay_fraction), 1)
        stable = max(decay_steps - decay, 0)
        sched = _join([_constant(base), _linear(base, 0.0, decay)], [stable])
    else:
        raise KeyError(f"unknown schedule {cfg.schedule!r}")
    if cfg.warmup_steps > 0:
        warmup = _linear(0.0, base, cfg.warmup_steps)
        return _join([warmup, sched], [cfg.warmup_steps])
    return sched


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (fp32), as
    ``optax.global_norm``."""
    sq = [t.float().square().sum() for t in tensors]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(grads: dict, clip: float | None,
                        norm: torch.Tensor | None = None) -> dict:
    """optax's ``clip_by_global_norm``: ``select(norm < clip, g, (g /
    norm) * clip)`` (``norm`` may be passed in); ``clip=None`` returns
    ``grads``."""
    if clip is None:
        return grads
    if norm is None:
        norm = global_norm(grads.values())
    keep = norm < clip
    return {k: torch.where(keep, g, (g / norm) * clip)
            for k, g in grads.items()}


class AdamW:
    """optax's ``chain(clip_by_global_norm(clip), adamw(schedule, ...))``
    over a dict of fp32 parameters, updated in place.

    State: ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``
    (fp32, the parameters' shapes). ``count`` is a host integer: the
    schedule and the bias correction are read from it without a device
    sync."""

    def __init__(self, schedule: Schedule, *, b1: float, b2: float,
                 eps: float, weight_decay: float, clip: float | None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip

    def init(self, params: dict) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    def update(self, grads: dict, state: dict, params: dict,
               norm: torch.Tensor | None = None) -> dict:
        """One step: clip ``grads`` (whose global norm may be passed in),
        then AdamW into ``params`` and the moments, in place. Returns the
        state (the same dicts, count advanced)."""
        grads = clip_by_global_norm(grads, self.clip, norm)
        count = state["count"]
        lr = self.schedule(count)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** (count + 1)
        c2 = 1 - b2 ** (count + 1)
        for k, p in params.items():
            g, mu, nu = grads[k], state["mu"][k], state["nu"][k]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (mu / c1) / ((nu / c2).sqrt() + self.eps)
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state["count"] = count + 1
        return state


class SGD:
    """optax's ``chain(clip_by_global_norm(clip), add_decayed_weights(wd),
    sgd(schedule, momentum, nesterov=True))`` over a dict of fp32
    parameters, updated in place.

    State: ``{"count": int, "trace": {name: tensor}}`` (fp32, the
    parameters' shapes); ``count`` is a host integer."""

    def __init__(self, schedule: Schedule, *, momentum: float,
                 weight_decay: float, clip: float | None):
        self.schedule = schedule
        self.momentum, self.weight_decay, self.clip = (momentum, weight_decay,
                                                       clip)

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads: dict, state: dict, params: dict,
               norm: torch.Tensor | None = None) -> dict:
        """One step into ``params`` and the trace, in place. Returns the
        state (the same dicts, count advanced)."""
        grads = clip_by_global_norm(grads, self.clip, norm)
        count = state["count"]
        lr, mom, wd = self.schedule(count), self.momentum, self.weight_decay
        for k, p in params.items():
            g, t = grads[k], state["trace"][k]
            if wd:
                g = g + wd * p
            t.mul_(mom).add_(g)  # t = g + m t
            p.add_(g + mom * t, alpha=-lr)  # nesterov: u = g + m t
        state["count"] = count + 1
        return state


def make_optimizer(cfg: OptimizerConfig, trainer_cfg: TrainerConfig):
    """``(tx, schedule)`` as the JAX factory returns them; the port builds
    ``adamw``, ``sgd`` and ``fused_adamw``."""
    schedule = make_schedule(cfg, trainer_cfg.total_steps)
    b2 = 0.999 if cfg.b2 is None else cfg.b2
    if cfg.name == "fused_adamw":
        if cfg.grad_clip_norm is not None:
            raise ValueError(
                "optimizer.name=fused_adamw does not compose with "
                "grad_clip_norm (global-norm clipping defeats the "
                "single-pass fusion); use adamw"
            )
        return FusedAdamW(schedule, b1=cfg.b1, b2=b2, eps=cfg.eps,
                          weight_decay=cfg.weight_decay), schedule
    if cfg.name == "adamw":
        return AdamW(schedule, b1=cfg.b1, b2=b2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay,
                     clip=cfg.grad_clip_norm), schedule
    if cfg.name == "sgd":
        return SGD(schedule, momentum=cfg.momentum,
                   weight_decay=cfg.weight_decay,
                   clip=cfg.grad_clip_norm), schedule
    raise NotImplementedError(
        f"optimizer.name={cfg.name!r} is not ported yet (ROADMAP queue A "
        "item 10)"
    )
