"""Where every tensor of the train state lives over the mesh, and the
collectives that move it between its layouts in a step.

The state is held as plain local tensors, each this rank's shard of its
tensor under a spec (``parallel/partition.py``). Four specs per
parameter:

- ``param``: the params and the EMA (the model rules and the FSDP
  overlay);
- ``opt``: the parameter-shaped optimizer tensors (``zero1`` adds the
  overlay);
- ``compute``: what the forward takes, the param spec without ``fsdp``
  (gathered at the start of the step) and, for the tensors the model
  reads whole (the GPT's tied embedding and head), without ``model``;
  the model's own tensor-parallel products take the rest split over
  ``model`` (``parallel/tensor_parallel.py``);
- ``accum``: the fp32 gradient accumulator, in the param spec under FSDP
  (each microbatch's gradient is reduce-scattered into it, so no
  gathered fp32 copy of the model is kept) and in the compute spec
  otherwise.

Under the overlap schedule (``with_overlap``) the blocks' FSDP
parameters stay split for the forward, which gathers them itself, and
the parameters used on the ``model``-sharded stream are summed over
``model`` too.

Each rank's gradient is that of its own rows' loss (under ``seq``, its
own tokens'). ``reduce`` sums it over the batch axes and ``seq``
(``LOSS_AXES``), as a reduce-scatter where the target splits a dim over
a batch axis and an all-reduce over the rest; a ``model`` split the
compute spec lacks is taken as this rank's slice (every rank along
``model`` computed the same whole gradient). The step divides by the
size of those axes once, so the gradient is that of the global batch's
mean loss, as GSPMD computes it. ``expert`` splits parameters as
``model`` does: its ranks see the same rows and compute the same
gradients of everything but their own experts.

A split dim of size n over k members gives member i the rows ``[i c,
(i+1) c)`` cut at n, ``c = ceil(n / k)`` (the JAX package's bounds).
Over a mesh of one device every spec is whole, every collective the
identity and every shard the tensor itself.

Pipeline parallelism (``pipe`` above 1): the rules' ``stage`` places
each parameter on one pipe rank (``owner``: a stage's layers, under the
MPMD backend also the embedding on stage 0 and ``ln_f`` on the last) or
on every one (None: the SPMD backend's embedding and ``ln_f``, whole on
every stage as the JAX rules leave them). A rank's layout holds its own
parameters and their optimizer state only (``shapes``; ``whole_shapes``
has every name). The gradient of a leaf every stage holds is summed over
``pipe`` too (the stages that do not use it add zeros), and the global
norm sums a stage-held leaf's squares over ``pipe`` and counts a shared
one once. ``gather_state`` fills in the other stages' tensors (a
broadcast from the rank that holds each), ``shard_state`` keeps this
rank's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from frl_distributed_ml_scaffold_tpu_torch.dist import collectives
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    BATCH_AXES,
    LOSS_AXES,
    MeshEnv,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
    PartitionRules,
    Spec,
    jax_leaves,
    normalize,
    opt_state_specs,
    param_specs,
)


# The axes a parameter may be split over. ``expert`` splits like
# ``model``: its ranks hold different experts and see the same rows.
SPLIT_AXES = ("fsdp", "model", "expert")


def chunk_bounds(n: int, k: int, i: int) -> tuple[int, int]:
    """Member ``i`` of ``k``'s rows of a dim of size ``n``."""
    c = -(-n // k)
    return min(i * c, n), min((i + 1) * c, n)


def _drop(spec: Spec, axes) -> Spec:
    return tuple(None if e in axes else e for e in spec)


@dataclasses.dataclass
class StateLayout:
    """The specs of every parameter over ``env`` (module docstring) and
    the moves between them."""

    env: MeshEnv
    shapes: dict[str, tuple[int, ...]]
    param: dict[str, Spec]
    opt: dict[str, Spec]
    compute: dict[str, Spec]
    accum: dict[str, Spec]
    # Under the overlap schedule (``with_overlap``): the axes a
    # parameter's gradient is already summed over when the backward ends,
    # and the axes over which each rank holds only a part of it.
    presummed: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    partial: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    # Under pipe > 1: each name's pipe rank (None: every rank) and the
    # whole model's shapes (``shapes`` holds this rank's names only).
    owner: dict[str, int | None] = dataclasses.field(default_factory=dict)
    whole_shapes: dict[str, tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def build(cls, env: MeshEnv, model_cfg: Any, parallel, shapes: dict,
              rules: PartitionRules | None = None,
              compute_whole: tuple[str, ...] = ()) -> "StateLayout":
        """The layout of a ``model_cfg`` model's parameters (``shapes`` by
        name) under ``parallel`` over ``env``. ``compute_whole`` names the
        parameters the model reads whole."""
        shapes = {k: tuple(int(d) for d in s) for k, s in shapes.items()}
        whole_shapes = dict(shapes)
        owner = {}
        stage = getattr(rules, "stage", None)
        if stage is not None and env.axis_size("pipe") > 1:
            owner = {k: stage(k) for k in shapes}
            me = env.axis_index("pipe")
            shapes = {k: s for k, s in shapes.items()
                      if owner[k] is None or owner[k] == me}
        sizes = env.shape
        leaves = (jax_leaves(model_cfg, shapes) if sizes["fsdp"] > 1
                  else {})
        p = param_specs(shapes, parallel, sizes, leaves, rules)
        # An axis of size 1 splits nothing (the JAX rules name every
        # axis; ``expert = n`` alone leaves their ``model`` entries idle).
        p = {k: tuple(None if e is None or sizes[e] == 1 else e for e in s)
             for k, s in p.items()}
        o = opt_state_specs(p, parallel, sizes, leaves)
        c = {k: (_drop(s, ("fsdp", "model")) if k in compute_whole
                 else _drop(s, ("fsdp",))) for k, s in p.items()}
        a = p if parallel.param_sharding == "fsdp" else c
        for specs in (p, o):
            for k, s in specs.items():
                for e in s:
                    if e is not None and e not in SPLIT_AXES:
                        raise NotImplementedError(
                            f"{k}: spec {s} splits over {e!r}; the step "
                            f"splits params over {SPLIT_AXES} only")
        return cls(env, shapes, p, o, c, dict(a), owner=owner,
                   whole_shapes=whole_shapes)

    def with_overlap(self, gathered=(), stream=()) -> "StateLayout":
        """This layout under the overlap schedule: the parameters of
        ``gathered`` (the blockwise FSDP gathers,
        ``parallel/fsdp_overlap.py``) stay split over ``fsdp`` for the
        forward, which gathers them block by block, and their gradients
        come out of the backward reduce-scattered over ``fsdp``; the
        parameters of ``stream`` (used on the stream the
        collective-matmul rings shard over ``model``,
        ``parallel/tp_overlap.py``) take a part of their gradient on
        each ``model`` rank, summed over ``model`` by the step."""
        compute = dict(self.compute)
        for k in gathered:
            compute[k] = self.param[k]
        return dataclasses.replace(
            self, compute=compute,
            presummed={k: ("fsdp",) for k in gathered},
            partial={k: ("model",) for k in stream})

    def step_sum_axes(self, name: str) -> tuple[str, ...]:
        """The axes the accumulated gradient of ``name`` is summed over
        at the end of the step: the batch axes and ``seq`` its microbatch
        gradients were not reduce-scattered or summed over, and the axes
        each rank holds a part over."""
        done = self.scatter_axes(name) + self.presummed.get(name, ())
        shared = ("pipe",) if self.owner and self.owner[name] is None else ()
        return (tuple(a for a in LOSS_AXES if a not in done)
                + self.partial.get(name, ()) + shared)

    # ------------------------------------------------------------ queries

    @property
    def trivial(self) -> bool:
        """True when every spec is whole and every rank holds every
        parameter (one device, or nothing split)."""
        return not self.owner and not any(
            any(e is not None for e in s)
            for specs in (self.param, self.opt) for s in specs.values())

    def local_shape(self, name: str, spec: Spec) -> tuple[int, ...]:
        out = []
        for n, e in zip(self.shapes[name], spec):
            if e is None:
                out.append(n)
            else:
                lo, hi = chunk_bounds(n, self.env.axis_size(e),
                                      self.env.axis_index(e))
                out.append(hi - lo)
        return tuple(out)

    def _splits(self, src: Spec, dst: Spec):
        """(dim, axis) where ``dst`` splits a dim ``src`` keeps whole."""
        return [(d, b) for d, (a, b) in enumerate(zip(src, dst))
                if b is not None and a is None]

    # -------------------------------------------------------------- moves

    def narrow(self, name: str, x: torch.Tensor, src: Spec, dst: Spec
               ) -> torch.Tensor:
        """This rank's part under ``dst`` of ``x`` under ``src`` (a view;
        no communication)."""
        for d, e in self._splits(src, dst):
            lo, hi = chunk_bounds(self.shapes[name][d], self.env.axis_size(e),
                                  self.env.axis_index(e))
            x = x.narrow(d, lo, hi - lo)
        return x

    def shard(self, name: str, full: torch.Tensor, spec: Spec
              ) -> torch.Tensor:
        """This rank's shard of a whole tensor, as a tensor of its own
        (the whole tensor itself when ``spec`` splits nothing)."""
        whole = (None,) * full.dim()
        if not self._splits(whole, spec):
            return full
        return self.narrow(name, full, whole, spec).clone(
            memory_format=torch.contiguous_format)

    def gather(self, name: str, x: torch.Tensor, src: Spec, dst: Spec,
               out: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` under ``src`` as the tensor under ``dst``: an all-gather
        over every axis that ``src`` splits and ``dst`` does not (into
        ``out`` when given)."""
        moves = self._splits(dst, src)
        if not moves:
            return x
        for d, e in moves:
            x = self.gather_dim(x, d, self.shapes[name][d], e)
        if out is not None:
            out.copy_(x)
            return out
        return x

    def gather_dim(self, x: torch.Tensor, d: int, n: int, axis: str
                   ) -> torch.Tensor:
        """``x``, this rank's chunk of a dim ``d`` of size ``n`` split
        over ``axis``, all-gathered whole along it."""
        return collectives.all_gather_dim(x, axis, d, n, env=self.env)

    def reduce(self, name: str, g: torch.Tensor, src: Spec, dst: Spec,
               sum_axes: tuple[str, ...]) -> torch.Tensor:
        """``g`` under ``src``, a partial sum over ``sum_axes``, as its sum
        under ``dst``: a reduce-scatter where ``dst`` splits a dim over a
        summed axis, a slice where it splits one over another axis, and
        an all-reduce over the summed axes left."""
        left = list(sum_axes)
        for d, e in self._splits(src, dst):
            k, i = self.env.axis_size(e), self.env.axis_index(e)
            if e in left:
                left.remove(e)
                g = collectives.reduce_scatter_dim(g, e, d, env=self.env)
            else:
                lo, hi = chunk_bounds(self.shapes[name][d], k, i)
                g = g.narrow(d, lo, hi - lo)
        group = self.env.group(tuple(left)) if left else None
        if group is not None:
            g = g.contiguous()
            dist.all_reduce(g, group=group)
        return g

    def scatter_axes(self, name: str) -> tuple[str, ...]:
        """The batch axes a microbatch's gradient is reduce-scattered over
        into the accumulator."""
        return tuple(e for _, e in self._splits(self.compute[name],
                                                self.accum[name])
                     if e in BATCH_AXES)

    def global_sq_norm(self, grads: dict[str, torch.Tensor],
                       specs: dict[str, Spec]) -> torch.Tensor:
        """The sum of squares of whole tensors held as shards under
        ``specs``: each shard's sum, all-reduced over the axes its tensor
        is split over (a replicated tensor counts once)."""
        by_axes: dict[tuple, list[torch.Tensor]] = {}
        for k, g in grads.items():
            axes = {e for e in specs[k] if e is not None}
            if self.owner.get(k) is not None:
                axes.add("pipe")  # each stage holds its own
            axes = tuple(sorted(axes))
            by_axes.setdefault(axes, []).append(g.float().square().sum())
        total = None
        for axes, parts in by_axes.items():
            s = torch.stack(parts).sum()
            group = self.env.group(axes) if axes else None
            if group is not None:
                dist.all_reduce(s, group=group)
            total = s if total is None else total + s
        return total

    # ------------------------------------------------------------- trees

    def map_opt(self, fn: Callable[[str, torch.Tensor], torch.Tensor],
                opt_state: dict) -> dict:
        """``opt_state`` with ``fn(name, tensor)`` applied to every
        parameter-shaped tensor (whole or this rank's shard, in the dicts
        keyed by parameter name); the rest (Adafactor's factored moments
        and placeholders, whole on every rank) as they are."""
        out = {}
        for key, v in opt_state.items():
            if isinstance(v, dict) and v and set(v) <= set(self.shapes):
                out[key] = {k: (fn(k, t) if tuple(t.shape) in (
                    self.shapes[k], self.local_shape(k, self.opt[k]))
                    else t) for k, t in v.items()}
            else:
                out[key] = v
        return out

    def opt_template(self, dtype=torch.float32, device=None) -> dict:
        """Empty tensors of the optimizer state's per-rank shapes, for
        ``tx.init``."""
        return {k: torch.empty(self.local_shape(k, s), dtype=dtype,
                               device=device)
                for k, s in self.opt.items()}

    def _pipe_fill(self, tensors: dict) -> dict:
        """``tensors`` (this rank's names, whole) with every other
        stage's filled in, in the whole model's order: each from the pipe
        rank that holds it (a broadcast over ``pipe``)."""
        if not self.owner:
            return tensors
        like = next(iter(tensors.values()))
        out = {}
        for k, shape in self.whole_shapes.items():
            o = self.owner[k]
            if o is None:
                out[k] = tensors[k]
                continue
            t = (tensors[k].contiguous() if k in tensors else torch.empty(
                shape, dtype=like.dtype, device=like.device))
            out[k] = collectives.broadcast(t, "pipe", source=o, env=self.env)
        return out

    def whole_params(self, params: dict) -> dict:
        """Every parameter whole (every rank takes part and gets it)."""
        return self._pipe_fill(
            {k: self.gather(k, p, self.param[k], normalize((), p.dim()))
             for k, p in params.items()})

    def gather_state(self, state):
        """The whole state (every rank takes part; every rank gets it)."""
        if self.trivial:
            return state
        whole = {k: (None,) * len(s) for k, s in self.shapes.items()}
        opt = self.map_opt(
            lambda k, t: self.gather(k, t, self.opt[k], whole[k]),
            state.opt_state)
        if self.owner:
            opt = {key: (self._pipe_fill(v) if isinstance(v, dict) and v
                         and set(v) <= set(self.shapes) else v)
                   for key, v in opt.items()}
        return dataclasses.replace(
            state,
            params=self.whole_params(state.params),
            opt_state=opt,
            ema_params=(None if state.ema_params is None
                        else self.whole_params(state.ema_params)))

    def _mine(self, tree: dict) -> dict:
        return {k: v for k, v in tree.items() if k in self.shapes}

    def shard_state(self, state):
        """This rank's shards of a whole state (its stage's parameters
        under ``pipe``)."""
        if self.trivial:
            return state
        opt = {key: (self._mine(v) if isinstance(v, dict) and v
                     and set(v) <= set(self.whole_shapes or self.shapes)
                     else v) for key, v in state.opt_state.items()}
        return dataclasses.replace(
            state,
            params={k: self.shard(k, p, self.param[k])
                    for k, p in self._mine(state.params).items()},
            opt_state=self.map_opt(lambda k, t: self.shard(k, t, self.opt[k]),
                                   opt),
            ema_params=(None if state.ema_params is None else
                        {k: self.shard(k, p, self.param[k])
                         for k, p in self._mine(state.ema_params).items()}))
