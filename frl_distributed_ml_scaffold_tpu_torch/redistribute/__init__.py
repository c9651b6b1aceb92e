"""The redistribution service: the port of the JAX package's
``redistribute/``. One subsystem for every seam that moves state between
layouts: a plan compiler (``redistribute/plan.py``: chunked transfer
programs with a bounded scratch budget, never a whole copy staged on
every rank), an executor (``redistribute/executor.py``, over
``torch.distributed``) and the cost model the plans carry
(``bytes_moved`` / ``bytes_lower_bound`` / ``peak_scratch_bytes``).

A tree here is flat: a dict from path to this rank's local tensor. Its
layout is described beside it, a path at a time, by ``Abstract`` leaves
(whole shape, dtype, ``Placement``): the plan is computed from those
alone, the same on every rank, and each rank then runs its part of it
with its own tensors. Every rank of the source and of the destination
calls the entry points with the same arguments.

The seams that use it:

- **elastic restore**: ``Checkpointer.restore_or_init`` with
  ``checkpoint.restore_redistribute=true`` (the elastic supervisor's
  reformed command sets it) reads each leaf at
  ``restore_layout_spec``'s even layout, about 1/N of it a rank from the
  file's memory map, and runs the plan to the trainer's layout;
- **train-to-serve**: ``train_to_serve(params, serve_env, rules,
  layout=, model=)`` moves a training layout's shards onto the serving
  TP layout (adopted by ``shard_params_for_serving(layout=)`` and
  ``build_engine(rules=, layout=)``);
- **re-spread**: ``ServingEngine.respread_pool(new_env)`` moves the
  params and the paged pool when the ``model`` axis grows or shrinks,
  around a park and resume of every active slot;
- **a separate prefill partition** (``DisaggServingEngine(prefill_env=)``:
  a device, the decode mesh's own ranks, or other ranks): the worker's
  whole params replica moves through ``to_mesh`` with a whole spec
  (``replica_plan``), and each handoff's seed and window move by a plan
  between the decode side's heads split and the worker's whole trees.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import MeshEnv
from frl_distributed_ml_scaffold_tpu_torch.redistribute.executor import (
    check_sources,
    execute,
)
from frl_distributed_ml_scaffold_tpu_torch.redistribute.plan import (
    Abstract,
    Chunk,
    LeafPlan,
    Placement,
    RedistributionPlan,
    Transition,
    analyze_transition,
    compile_leaf_plan,
    compile_tree_plan,
    restore_layout_spec,
)

__all__ = [
    "Abstract",
    "Chunk",
    "LeafPlan",
    "Placement",
    "RedistributionPlan",
    "Transition",
    "analyze_transition",
    "check_sources",
    "compile_leaf_plan",
    "compile_tree_plan",
    "execute",
    "layout_tree",
    "mesh_shardings",
    "redistribute_tree",
    "restore_layout_spec",
    "serve_shardings",
    "spec_on",
    "to_mesh",
    "train_to_serve",
    "train_to_serve_plan",
]


def redistribute_tree(
    tree: dict[str, torch.Tensor | None],
    src: dict[str, Abstract],
    dst: dict[str, Placement],
    *,
    donate: bool = False,
    scratch_limit_bytes: int | None = None,
    device=None,
) -> tuple[dict[str, torch.Tensor], RedistributionPlan]:
    """Compile and execute in one call; returns ``(new_tree, plan)``."""
    plan = compile_tree_plan(src, dst, scratch_limit_bytes=scratch_limit_bytes)
    return execute(plan, tree, donate=donate, device=device), plan


def spec_on(env: MeshEnv, shape, spec) -> tuple:
    """Carry a spec onto another mesh, degrading a dim at a time: an
    entry whose axes do not divide the dim is dropped to whole for that
    dim (a ``model`` axis of 2 re-spread to 4 keeps its ``model`` entries
    as long as the heads still divide)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        names = (e,) if isinstance(e, str) else tuple(e)
        prod = 1
        for n in names:
            prod *= env.shape.get(n, 0)
        out.append(e if prod and dim % prod == 0 else None)
    return tuple(out)


def mesh_shardings(
    tree: dict[str, Abstract],
    env: MeshEnv,
    *,
    spec_of: Callable[[str, Abstract], Any] | None = None,
) -> dict[str, Placement]:
    """Destination placements for moving ``tree`` onto ``env`` with each
    leaf's spec carried over (``spec_on``): ``spec_of(path, leaf)``
    overrides a leaf's spec (None: keep the source's); a host leaf
    defaults to whole. Split from ``to_mesh`` so a caller compiles its
    plans before it touches any state."""
    out = {}
    for path, leaf in tree.items():
        spec = spec_of(path, leaf) if spec_of is not None else None
        if spec is None:
            spec = (() if leaf.placement is None
                    else leaf.placement.spec)
        out[path] = Placement(env, spec_on(env, leaf.shape, spec))
    return out


def to_mesh(
    tree: dict[str, torch.Tensor | None],
    src: dict[str, Abstract],
    env: MeshEnv,
    *,
    spec_of: Callable[[str, Abstract], Any] | None = None,
    donate: bool = False,
    scratch_limit_bytes: int | None = None,
    device=None,
) -> tuple[dict[str, torch.Tensor], RedistributionPlan]:
    """Move a tree onto another mesh (``mesh_shardings``, compile and
    execute in one call)."""
    return redistribute_tree(
        tree, src, mesh_shardings(src, env, spec_of=spec_of),
        donate=donate, scratch_limit_bytes=scratch_limit_bytes,
        device=device)


def layout_tree(layout, dtypes: dict[str, torch.dtype], which: str = "param"
                ) -> dict[str, Abstract]:
    """The ``Abstract`` leaves of a training ``StateLayout``'s parameters
    (``which``: ``param`` or ``opt`` specs), over its whole model
    (``whole_shapes``; a pipeline stage's names held by their ``owner``
    only)."""
    specs = getattr(layout, which)
    shapes = layout.whole_shapes or layout.shapes
    out = {}
    for name, shape in shapes.items():
        spec = specs.get(name)
        if spec is None:  # another stage's name: its own specs are alike
            spec = (None,) * len(shape)
        out[name] = Abstract.of(
            shape, dtypes[name],
            Placement(layout.env, spec, layout.owner.get(name)))
    return out


def serve_shardings(model, serve_env: MeshEnv, rules=None
                    ) -> dict[str, Placement]:
    """Destination placements of the train-to-serve handoff: the
    model's TP ``rules`` on ``serve_env`` (no FSDP overlay: serving has
    no optimizer), by the derivation ``shard_params_for_serving`` uses
    (``parallel.partition.serving_specs``)."""
    from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
        PartitionRules,
        serving_specs,
    )

    rules = rules if rules is not None else PartitionRules()
    return {k: Placement(serve_env, s)
            for k, s in serving_specs(model, serve_env, rules).items()}


def _dtypes(model) -> dict[str, torch.dtype]:
    return {k: p.dtype for k, p in model.named_parameters()}


def train_to_serve_plan(
    params: dict[str, Abstract],
    serve_env: MeshEnv,
    rules=None,
    *,
    model,
    scratch_limit_bytes: int | None = None,
) -> RedistributionPlan:
    """Compile (only) the train-to-serve handoff plan from ``Abstract``
    leaves: how the perf ledger's ``redistribute:train_to_serve`` row
    and a dry run price a migration that never runs."""
    dst = serve_shardings(model, serve_env, rules)
    return compile_tree_plan(params, {k: dst[k] for k in params},
                             scratch_limit_bytes=scratch_limit_bytes)


def train_to_serve(
    params: dict[str, torch.Tensor],
    serve_env: MeshEnv,
    rules=None,
    *,
    layout,
    model,
    donate: bool = False,
    scratch_limit_bytes: int | None = None,
    device=None,
) -> tuple[dict[str, torch.Tensor], RedistributionPlan]:
    """The train-to-serve param handoff: move a training layout's shards
    (``params``, this rank's tensors under the ``StateLayout``
    ``layout``) onto ``serve_env``'s serving TP layout by the plan
    executor, instead of gathering the whole tree. Every rank of both
    meshes calls it. Returns ``(placed, plan)``: this rank's serving
    tensors (none on a rank outside ``serve_env``) and the plan, whose
    ``bytes_moved`` / ``peak_scratch_bytes`` the perf ledger's
    ``redistribute:train_to_serve`` row prices."""
    src = layout_tree(layout, _dtypes(model))
    plan = train_to_serve_plan(src, serve_env, rules, model=model,
                               scratch_limit_bytes=scratch_limit_bytes)
    return execute(plan, params, donate=donate, device=device), plan
