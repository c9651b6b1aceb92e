"""Optimizer and LR schedule: the port of the JAX package's
``trainer/optimizers.py``: ``adamw``, ``adam``, ``sgd``, ``lion`` and
``adafactor`` (each with the optional global-norm clip) and
``fused_adamw``, under the ``constant``, ``cosine``, ``linear`` and
``wsd`` schedules with linear warmup.

The updates are optax's, written out:

- ``clip_by_global_norm(max)``: ``g`` unchanged while the global norm is
  below ``max``, else ``(g / norm) * max``, with no epsilon (not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm);
- ``adamw``: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
  bias-corrected at the incremented count, ``u = mu_hat / (sqrt(nu_hat)
  + eps) + wd * p`` on EVERY leaf (``optax.adamw`` runs with no mask),
  then ``p += -lr(count) * u`` with the schedule read at the count
  BEFORE it increments, so a warmup's first step (lr 0) leaves the
  params unchanged; ``adam`` is the same without the ``wd * p`` term;
- ``sgd``: ``add_decayed_weights(wd)`` (``g + wd * p``, when wd != 0),
  then optax's nesterov ``trace`` (``t = g + m t``, ``u = g + m t``),
  then ``p += -lr(count) * u``, the count read as above;
- ``lion`` (b2 0.99 when unset, not the Adam family's 0.999; weight
  decay built in): ``u = sign((1-b1) g + b1 mu) + wd * p``, ``mu = (1-b2)
  g + b2 mu``, ``p += -lr(count) * u``;
- ``adafactor``, optax's defaults (``cfg.eps`` is not passed: the Adam
  epsilon would floor the RMS 22 orders of magnitude too high): with
  ``rho = 1 - (count+1)^-0.8`` and ``s = g^2 + 1e-30``, a leaf whose two
  largest dims (numpy's argsort order) are both at least 128 keeps the
  factored second moment, ``v_row = rho v_row + (1-rho) mean(s, d0)``,
  ``v_col = rho v_col + (1-rho) mean(s, d1)``, ``u = g (v_row /
  mean(v_row))^-1/2 v_col^-1/2``; any other leaf keeps ``v = rho v +
  (1-rho) s``, ``u = g v^-1/2``. Then the block-RMS clip ``u / max(1,
  rms(u))``, ``u *= lr(count)``, ``u *= max(rms(p), 1e-3)`` (the
  parameter scale) and ``p -= u``; with ``weight_decay`` the JAX
  package's decoupled decay follows, ``p -= lr(count) * wd * p``;
- ``fused_adamw``: ``ops/fused_adamw.py`` ``FusedAdamW``, one pass per
  leaf (the hand-written kernel on the card); with a grad clip it is
  refused, as the JAX factory refuses it.

The updates work in place on the params and the optimizer state (the
JAX step donates its state, and in place is what keeps one copy of them
live). ``init`` gives the state the dtype of the tensors it is handed,
as optax's ``init`` does. The ``Trainer`` hands it fp32 templates, as
the JAX trainer builds its state from its fp32 init: a bf16 param
(``trainer.init_params_path`` under ``precision.policy=bf16``) keeps
fp32 moments. A tensor that is not fp32 (the bf16 param there) is
updated in fp32 and rounded once to its own dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    OptimizerConfig,
    TrainerConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.models import jax_leaf_of
from frl_distributed_ml_scaffold_tpu_torch.ops.fused_adamw import FusedAdamW
from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import chunk_bounds

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


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when fp32 (updated in place), else an fp32 copy that
    ``_store`` writes back."""
    return t if t.dtype == torch.float32 else t.float()


def _store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write an fp32 result back into ``dst``, rounding once to its
    dtype; a no-op when ``src`` is ``dst`` (an fp32 leaf, in place)."""
    if src is not dst:
        dst.copy_(src)


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


class AdamW:
    """optax's ``chain(clip_by_global_norm(clip), adamw(schedule, ...))``
    over a dict of parameters, updated in place; with ``weight_decay=0``
    it is ``optax.adam``.

    State: ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``
    (the parameters' shapes and dtypes). ``count`` is a host integer: the
    schedule and the bias correction are read from it without a device
    sync."""

    def __init__(self, schedule: Schedule, *, b1: float, b2: float,
                 eps: float, weight_decay: float, clip: float | None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

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
            g = grads[k].float()
            p32, mu, nu = _f32(p), _f32(state["mu"][k]), _f32(state["nu"][k])
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (mu / c1) / ((nu / c2).sqrt() + self.eps)
            if self.weight_decay:
                u.add_(p32, alpha=self.weight_decay)
            p32.add_(u, alpha=-lr)
            _store(state["mu"][k], mu)
            _store(state["nu"][k], nu)
            _store(p, p32)
        state["count"] = count + 1
        return state


class SGD:
    """optax's ``chain(clip_by_global_norm(clip), add_decayed_weights(wd),
    sgd(schedule, momentum, nesterov=True))`` over a dict of parameters,
    updated in place.

    State: ``{"count": int, "trace": {name: tensor}}`` (the parameters'
    shapes and dtypes); ``count`` is a host integer."""

    def __init__(self, schedule: Schedule, *, momentum: float,
                 weight_decay: float, clip: float | None):
        self.schedule = schedule
        self.momentum, self.weight_decay, self.clip = (momentum, weight_decay,
                                                       clip)

    def init(self, params: dict) -> dict:
        return {"count": 0, "trace": _zeros(params)}

    def update(self, grads: dict, state: dict, params: dict,
               norm: torch.Tensor | None = None) -> dict:
        """One step into ``params`` and the trace, in place. Returns the
        state (the same dicts, count advanced)."""
        grads = clip_by_global_norm(grads, self.clip, norm)
        count = state["count"]
        lr, mom, wd = self.schedule(count), self.momentum, self.weight_decay
        for k, p in params.items():
            g, p32, t = grads[k].float(), _f32(p), _f32(state["trace"][k])
            if wd:
                g = g + wd * p32
            t.mul_(mom).add_(g)  # t = g + m t
            p32.add_(g + mom * t, alpha=-lr)  # nesterov: u = g + m t
            _store(state["trace"][k], t)
            _store(p, p32)
        state["count"] = count + 1
        return state


class Lion:
    """optax's ``chain(clip_by_global_norm(clip), lion(schedule, b1, b2,
    weight_decay))`` over a dict of parameters, updated in place.

    State: ``{"count": int, "mu": {name: tensor}}`` (the parameters'
    shapes and dtypes); ``count`` is a host integer."""

    def __init__(self, schedule: Schedule, *, b1: float, b2: float,
                 weight_decay: float, clip: float | None):
        self.schedule = schedule
        self.b1, self.b2 = b1, b2
        self.weight_decay, self.clip = weight_decay, clip

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu": _zeros(params)}

    def update(self, grads: dict, state: dict, params: dict,
               norm: torch.Tensor | None = None) -> dict:
        """One step into ``params`` and the moment, in place. Returns the
        state (the same dicts, count advanced)."""
        grads = clip_by_global_norm(grads, self.clip, norm)
        count = state["count"]
        lr, b1, b2 = self.schedule(count), self.b1, self.b2
        for k, p in params.items():
            g, p32, mu = grads[k].float(), _f32(p), _f32(state["mu"][k])
            u = torch.sign((1 - b1) * g + b1 * mu)
            mu.mul_(b2).add_(g, alpha=1 - b2)
            u.add_(p32, alpha=self.weight_decay)
            p32.add_(u, alpha=-lr)
            _store(state["mu"][k], mu)
            _store(p, p32)
        state["count"] = count + 1
        return state


# optax.adafactor's defaults, which the JAX factory keeps.
ADAFACTOR_MIN_DIM = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


def _factored_dims(shape) -> tuple[int, int] | None:
    """optax's ``_factored_dims`` at ``min_dim_size_to_factor=128``: the
    two largest axes (d1, d0) in numpy's argsort order, or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """optax's ``chain(clip_by_global_norm(clip), adafactor(schedule))``
    at optax's defaults (module docstring), then, with ``weight_decay``,
    the JAX package's ``_decoupled_decay``: ``p -= lr(count) * wd * p``
    (a raw per-step rate would decay ~1000x too hard for a config tuned
    for AdamW). Updated in place.

    The block-RMS clip and the parameter scale reduce over a whole JAX
    leaf. The JAX GPT scans its blocks, so each of its block leaves
    stacks every layer: ``leaf_of`` maps a port parameter name to the
    JAX leaf it belongs to (``models.jax_leaf_of``), and the two
    reductions run over all the port leaves of one JAX leaf.

    State: ``{"count": int, "v_row", "v_col", "v": {name: tensor}}``. A
    factored leaf keeps ``v_row`` (its shape without d0) and ``v_col``
    (without d1) and a ``(1,)`` placeholder ``v``; any other leaf keeps a
    param-shaped ``v`` and ``(1,)`` placeholders, as optax's
    ``FactoredState`` does. ``init`` gives them the template's dtype;
    every update writes them back in the PARAM's dtype, as optax's
    ``scale_by_factored_rms`` does (``factorized.py``: the new moments
    are mixed in fp32 with the fp32 decay rate and cast with
    ``astype(param.dtype)``, and the row and column factors read the cast
    values): under a bf16 params file the state is fp32 at init and bf16
    from the first update on. The gradient's square, its means and the
    factored product keep the gradient's dtype, as optax computes them.
    The three counts of the JAX chain (the factored moments', the
    schedule's and the decay's) advance together, so one host integer
    stands for them.

    With a ``layout`` (``parallel/layout.py``, set by the ``Trainer``
    over a mesh) the params, gradients and ``v`` are this rank's shards
    under the optimizer state's spec, and ``v_row`` / ``v_col`` are whole
    on every rank, as the JAX state keeps them (no param-shaped leaf to
    take a spec from). The reductions run over the whole leaf: a
    factored mean sums over the split axes of its dim and gathers the
    split dims it keeps, and the block RMS and the parameter scale sum
    each shard's squares over the axes it is split on."""

    layout = None

    def __init__(self, schedule: Schedule, *, leaf_of: Callable[[str], str],
                 weight_decay: float, clip: float | None):
        self.schedule = schedule
        self.leaf_of = leaf_of
        self.weight_decay, self.clip = weight_decay, clip

    def _whole(self, k: str, shape) -> tuple[int, ...]:
        return tuple(shape) if self.layout is None else self.layout.shapes[k]

    def init(self, params: dict) -> dict:
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for k, p in params.items():
            one = functools.partial(torch.zeros, (1,), dtype=p.dtype,
                                    device=p.device)
            whole = self._whole(k, p.shape)
            dims = _factored_dims(whole)
            if dims is None:
                state["v_row"][k], state["v_col"][k] = one(), one()
                state["v"][k] = torch.zeros_like(p)
                continue
            d1, d0 = dims
            row = [n for i, n in enumerate(whole) if i != d0]
            col = [n for i, n in enumerate(whole) if i != d1]
            state["v_row"][k] = torch.zeros(row, dtype=p.dtype,
                                            device=p.device)
            state["v_col"][k] = torch.zeros(col, dtype=p.dtype,
                                            device=p.device)
            state["v"][k] = one()
        return state

    def _split(self, k: str, ndim: int) -> tuple:
        """Leaf ``k``'s spec under the layout (all None without one)."""
        return (None,) * ndim if self.layout is None else self.layout.opt[k]

    def _mean(self, k: str, sq: torch.Tensor, dim: int) -> torch.Tensor:
        """``mean(sq, dim)`` over the whole leaf, in ``sq``'s dtype (fp32
        sums, one rounding, as ``jnp.mean``), whole on every rank."""
        spec, whole = self._split(k, sq.dim()), self._whole(k, sq.shape)
        s = sq.float().sum(dim)
        if spec[dim] is not None:
            dist.all_reduce(s, group=self.layout.env.group(spec[dim]))
        s = s / whole[dim]
        for j, e in enumerate(spec):
            if e is not None and j != dim:
                s = self.layout.gather_dim(s, j - (j > dim), whole[j], e)
        return s.to(sq.dtype)

    def _local(self, k: str, t: torch.Tensor, dims) -> torch.Tensor:
        """This rank's part of a whole factor ``t`` whose dims are the
        leaf's ``dims``."""
        spec = self._split(k, t.dim() + 1)
        for i, j in enumerate(dims):
            if spec[j] is not None:
                env = self.layout.env
                lo, hi = chunk_bounds(t.shape[i], env.axis_size(spec[j]),
                                      env.axis_index(spec[j]))
                t = t.narrow(i, lo, hi - lo)
        return t

    def _scaled(self, k: str, g: torch.Tensor, pd: torch.dtype, state: dict,
                rho: float, omr: float) -> torch.Tensor:
        """Leaf ``k``'s gradient over its factored (or plain) RMS, fp32;
        the second moments written back in the param dtype ``pd``."""
        sq = g.square().add_(ADAFACTOR_EPS)
        dims = _factored_dims(self._whole(k, g.shape))
        if dims is None:
            v = _f32(state["v"][k])
            v.mul_(rho).add_(sq.float(), alpha=omr)
            v = _put(state, "v", k, v.to(pd))
            _put(state, "v_row", k, state["v_row"][k].to(pd))
            _put(state, "v_col", k, state["v_col"][k].to(pd))
            return (g * v.rsqrt()).float()
        d1, d0 = dims
        row, col = _f32(state["v_row"][k]), _f32(state["v_col"][k])
        row.mul_(rho).add_(self._mean(k, sq, d0).float(), alpha=omr)
        col.mul_(rho).add_(self._mean(k, sq, d1).float(), alpha=omr)
        row = _put(state, "v_row", k, row.to(pd))
        col = _put(state, "v_col", k, col.to(pd))
        _put(state, "v", k, state["v"][k].to(pd))
        r1 = d1 - 1 if d1 > d0 else d1
        mean = row.float().mean(r1, keepdim=True).to(pd)
        row_factor = (row / mean).rsqrt()
        n = len(self._whole(k, g.shape))
        row_factor = self._local(k, row_factor, [i for i in range(n)
                                                 if i != d0])
        col_factor = self._local(k, col.rsqrt(), [i for i in range(n)
                                                  if i != d1])
        return ((g * row_factor.unsqueeze(d0))
                * col_factor.unsqueeze(d1)).float()

    def _sq_sum(self, tensors: dict) -> torch.Tensor:
        """The sum of squares of the whole leaves ``tensors`` are (this
        rank's shards of) under the layout."""
        if self.layout is None:
            return sum(t.float().square().sum() for t in tensors.values())
        return self.layout.global_sq_norm(tensors, self.layout.opt)

    def update(self, grads: dict, state: dict, params: dict,
               norm: torch.Tensor | None = None) -> dict:
        """One step into ``params`` and the second moments, in place.
        Returns the state (the same dicts, count advanced)."""
        grads = clip_by_global_norm(grads, self.clip, norm)
        count = state["count"]
        lr, wd = self.schedule(count), self.weight_decay
        # The decay rate and its complement in fp32, as optax takes them.
        rho = np.float32(1) - np.float32(count + 1) ** np.float32(
            -ADAFACTOR_DECAY_RATE)
        rho, omr = float(rho), float(np.float32(1) - rho)
        blocks: dict[str, list[str]] = {}
        for k in params:
            blocks.setdefault(self.leaf_of(k), []).append(k)
        for names in blocks.values():
            # One block at a time: its updates, then the RMS of the
            # updates and of the params over the whole block.
            us = {k: self._scaled(k, grads[k], params[k].dtype, state, rho,
                                  omr)
                  for k in names}
            n = sum(math.prod(self._whole(k, us[k].shape)) for k in names)
            rms_u = (self._sq_sum(us) / n).sqrt()
            rms_p = (self._sq_sum({k: params[k] for k in names}) / n).sqrt()
            scale = (lr / torch.clamp(rms_u / ADAFACTOR_CLIP, min=1.0)
                     * torch.clamp(rms_p, min=ADAFACTOR_MIN_SCALE))
            for k in names:
                p = params[k]
                p32 = _f32(p)
                u = us.pop(k).mul_(scale).neg_()
                if wd:
                    u = u - lr * wd * p32
                p32.add_(u)
                _store(p, p32)
        state["count"] = count + 1
        return state


def _put(state: dict, key: str, k: str, t: torch.Tensor) -> torch.Tensor:
    """``state[key][k] = t`` in place when the dtypes agree (the tensor
    keeps its storage), else as a new tensor of ``t``'s dtype."""
    cur = state[key][k]
    if cur.dtype == t.dtype and cur.shape == t.shape:
        if t is not cur:
            cur.copy_(t)
        return cur
    state[key][k] = t
    return t


def make_optimizer(cfg: OptimizerConfig, trainer_cfg: TrainerConfig,
                   model_cfg: Any):
    """``(tx, schedule)`` as the JAX factory returns them, for the
    parameters of a ``model_cfg`` model (None: a plain dict of
    parameters, each its own JAX leaf). Adafactor reduces over the
    model's JAX leaves (``models.jax_leaf_of``); the elementwise
    optimizers do not read it."""
    schedule = make_schedule(cfg, trainer_cfg.total_steps)
    b2 = 0.999 if cfg.b2 is None else cfg.b2
    clip = cfg.grad_clip_norm
    if cfg.name == "fused_adamw":
        if clip is not None:
            raise ValueError(
                "optimizer.name=fused_adamw does not compose with "
                "grad_clip_norm (global-norm clipping defeats the "
                "single-pass fusion); use adamw"
            )
        return FusedAdamW(schedule, b1=cfg.b1, b2=b2, eps=cfg.eps,
                          weight_decay=cfg.weight_decay), schedule
    if cfg.name in ("adamw", "adam"):
        wd = cfg.weight_decay if cfg.name == "adamw" else 0.0
        return AdamW(schedule, b1=cfg.b1, b2=b2, eps=cfg.eps,
                     weight_decay=wd, clip=clip), schedule
    if cfg.name == "sgd":
        return SGD(schedule, momentum=cfg.momentum,
                   weight_decay=cfg.weight_decay, clip=clip), schedule
    if cfg.name == "lion":
        return Lion(schedule, b1=cfg.b1, b2=0.99 if cfg.b2 is None else cfg.b2,
                    weight_decay=cfg.weight_decay, clip=clip), schedule
    if cfg.name == "adafactor":
        return Adafactor(schedule, leaf_of=jax_leaf_of(model_cfg),
                         weight_decay=cfg.weight_decay, clip=clip), schedule
    raise KeyError(f"unknown optimizer {cfg.name!r}")
