"""Overlap-scheduled FSDP: each block gathers its own ``fsdp`` shards
just before its compute, and reduce-scatters its gradient back into them
as its backward ends. The port of the JAX package's
``parallel/fsdp_overlap.py``.

The plain FSDP step (``parallel/layout.py``) gathers every parameter at
the start of the step and reduce-scatters every gradient at the end.
Under ``parallel.fsdp_overlap`` the step leaves the blocks' parameters
as shards (``StateLayout.with_overlap``) and the model runs each block
through ``BlockGather``:

- ``begin(k)`` posts the all-gathers of blocks ``k .. k + prefetch``
  that are not posted yet (``dist/collectives.py``
  ``all_gather_start``), so block k+p's gather is in flight while block
  k computes, and waits for block k's. With ``prefetch=0`` each block
  gathers just before it runs. The waits come in block order: block k's
  gather is never waited on before block k - 1 - prefetch has run, the
  window the reference ties with an ``optimization_barrier``.
- ``params(k, shards, names)`` gives block k's whole parameters, each
  the output of an autograd function whose backward reduce-scatters the
  gradient into the shard (the gather's transpose), so a block's
  gradients are scattered as soon as its backward has produced them.
- ``no_save()`` (``block_remat=none``): a region in which the tensors
  autograd saves for the backward are kept, except the block's gathered
  parameters (and views of them), which are saved as a reference to
  their shard and gathered again when the backward reads them, the
  counterpart of the reference's ``save_anything_except_these_names(
  "fsdp_gathered")``. Tensors it keeps go to the saved-tensor hooks
  around it, if any, as they would without it. ``full`` and
  ``save_attn`` checkpoint the block (``torch.utils.checkpoint``) with
  the gather inside, so the recompute gathers again.

``gathers`` and ``regathers`` count the gathers the forward posted and
those the backward (or a recompute) made; ``events`` is the last
forward's order of posts and block runs. The parameters
outside the blocks (embeddings, the head) stay with the step's gather.
"""

from __future__ import annotations

import contextlib

import torch

from frl_distributed_ml_scaffold_tpu_torch.dist import collectives

#: Model families with blockwise apply hooks wired up.
SUPPORTED_FAMILIES = ("gpt", "resnet")


class _GatherParam(torch.autograd.Function):
    """The whole parameter (gathered outside, handed over in a box) as a
    function of its shard; the backward reduce-scatters the gradient
    into the shard."""

    @staticmethod
    def forward(ctx, shard, box, axis, dim, env):
        ctx.meta = (axis, dim, env, shard.shape[dim])
        return box.pop()

    @staticmethod
    def backward(ctx, g):
        axis, dim, env, rows = ctx.meta
        out = collectives.reduce_scatter_dim(g, axis, dim, env=env)
        return out.narrow(dim, 0, rows), None, None, None, None


class _Regather:
    """A saved gathered parameter (or a view of it), kept as its shard:
    the backward gathers it again once for the block (``shared``)."""

    def __init__(self, owner, shard, dim, n, view, shared):
        self.owner, self.shard, self.dim, self.n = owner, shard, dim, n
        self.view, self.shared = view, shared

    def unpack(self):
        key = id(self.shard)
        full = self.shared.get(key)
        if full is None:
            full = collectives.all_gather_dim(
                self.shard, self.owner.axis, self.dim, self.n,
                env=self.owner.layout.env)
            self.owner.regathers += 1
            self.shared[key] = full
        size, stride, offset = self.view
        return full.as_strided(size, stride, offset)


class BlockGather:
    """The blockwise gathers of one model over ``layout``'s specs
    (module docstring). ``prefetch``: how many blocks ahead a gather is
    posted; ``block_remat``: the model's per-block remat mode."""

    def __init__(self, layout, *, prefetch: int = 1, axis: str = "fsdp",
                 block_remat: str = "none"):
        if block_remat not in ("none", "full", "save_attn"):
            raise KeyError(
                f"unknown block_remat {block_remat!r} for the overlap path "
                "(none | full | save_attn)")
        self.layout, self.prefetch, self.axis = layout, prefetch, axis
        self.block_remat = block_remat
        self.regathers = 0
        self.gathers = 0
        # ("post" | "run", block) in the order they happened, the last
        # forward's: the prefetch window as it ran.
        self.events: list[tuple[str, int]] = []
        self._blocks: list = []
        self._pending: dict = {}
        self._ready: dict = {}
        self._gathered: list | None = None  # inside ``no_save``

    # ------------------------------------------------------------ specs

    def split_dim(self, name: str) -> int | None:
        """The dim of ``name`` split over the axis, or None."""
        spec = self.layout.param.get(name, ())
        return spec.index(self.axis) if self.axis in spec else None

    def gathered_names(self) -> frozenset[str]:
        """Every parameter of ``layout`` these hooks gather (a block's,
        split over the axis)."""
        return frozenset(k for k in self.layout.param
                         if k.startswith("blocks.")
                         and self.split_dim(k) is not None)

    # ---------------------------------------------------------- a pass

    def start(self, blocks) -> None:
        """Begin a forward over ``blocks``: for each, ``(prefix,
        {name: shard})`` of its parameters as the forward sees them."""
        self._blocks = list(blocks)
        self._pending, self._ready = {}, {}
        self.events = []

    def _post(self, k: int) -> None:
        if k in self._pending or k in self._ready or k >= len(self._blocks):
            return
        prefix, shards = self._blocks[k]
        posted = {}
        for rel, t in shards.items():
            name = prefix + rel
            d = self.split_dim(name)
            if d is None:
                continue
            posted[rel] = collectives.all_gather_start(
                t.detach(), self.axis, d, self.layout.shapes[name][d],
                env=self.layout.env)
            self.gathers += 1
        self._pending[k] = posted
        self.events.append(("post", k))

    def begin(self, k: int) -> None:
        """Post blocks ``k .. k + prefetch`` and wait for block k's."""
        for j in range(k, k + self.prefetch + 1):
            self._post(j)
        posted = self._pending.pop(k, None)
        if posted is not None:
            self._ready[k] = {rel: p.wait() for rel, p in posted.items()}
        self.events.append(("run", k))

    def params(self, k: int, shards: dict, names=None) -> dict:
        """Block k's parameters (``shards`` by relative name) whole, each
        a function of its shard; ``names`` restricts them. The first
        request takes the posted gather; a recompute gathers again."""
        prefix = self._blocks[k][0]
        ready = self._ready.get(k, {})
        out = {}
        for rel, shard in shards.items():
            if names is not None and rel not in names:
                continue
            name = prefix + rel
            d = self.split_dim(name)
            if d is None:
                out[rel] = shard
                continue
            full = ready.pop(rel, None)
            if full is None:
                full = collectives.all_gather_dim(
                    shard.detach(), self.axis, d, self.layout.shapes[name][d],
                    env=self.layout.env)
                self.regathers += 1
            out[rel] = _GatherParam.apply(shard, [full], self.axis, d,
                                          self.layout.env)
            if self._gathered is not None:
                self._gathered.append((out[rel], shard.detach(), d,
                                       self.layout.shapes[name][d]))
        return out

    @contextlib.contextmanager
    def no_save(self):
        """The region in which gathered parameters are not saved for the
        backward (module docstring)."""
        outer = torch._C._autograd._top_saved_tensors_default_hooks(False)
        gathered, shared = [], {}
        self._gathered = gathered

        def pack(t):
            for full, shard, d, n in gathered:
                if (t.device == full.device
                        and t.untyped_storage().data_ptr()
                        == full.untyped_storage().data_ptr()):
                    return _Regather(self, shard, d, n, (
                        tuple(t.shape), tuple(t.stride()),
                        t.storage_offset()), shared)
            return (True, outer[0](t)) if outer else (False, t)

        def unpack(packed):
            if isinstance(packed, _Regather):
                return packed.unpack()
            wrapped, inner = packed
            return outer[1](inner) if wrapped else inner

        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                yield gathered
        finally:
            self._gathered = None
            gathered.clear()


def validate_block_schedule(cfg, *, prefetch: int) -> None:
    """Refuse the configs a blockwise gather rule cannot honor (the
    reference's checks and words)."""
    family = getattr(cfg.model, "family", None)
    if cfg.parallel.param_sharding != "fsdp":
        raise ValueError(
            "parallel.fsdp_overlap=true requires param_sharding='fsdp' "
            f"(got {cfg.parallel.param_sharding!r}): the overlap schedule "
            "is a rewrite of how fsdp-sharded params are gathered, not a "
            "sharding strategy of its own"
        )
    if family not in SUPPORTED_FAMILIES:
        raise ValueError(
            f"parallel.fsdp_overlap=true: model family {family!r} has no "
            f"blockwise apply hooks (supported: {SUPPORTED_FAMILIES})"
        )
    if (
        getattr(cfg.model, "pipeline_stages", 1) > 1
        and getattr(cfg.model, "pipeline_impl", "spmd") != "mpmd"
    ):
        raise ValueError(
            "parallel.fsdp_overlap composes with dp/fsdp/tp meshes but not "
            "with the SPMD pipeline backend (the stage-vmap path owns its "
            "own block schedule); set model.pipeline_stages=1 or "
            "model.pipeline_impl='mpmd'"
        )
    if getattr(cfg.model, "pipeline_stages", 1) > 1:
        raise NotImplementedError(
            "parallel.fsdp_overlap under model.pipeline_impl='mpmd': the "
            "overlap schedule inside the per-stage programs is not "
            "ported yet "
            "(ROADMAP A12)"
        )
    if prefetch < 0:
        raise ValueError(
            f"parallel.fsdp_prefetch must be >= 0, got {prefetch}"
        )
