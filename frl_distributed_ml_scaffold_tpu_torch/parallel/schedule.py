"""The overlap schedule: one declarative per-axis gather / scatter
schedule for FSDP x TP x low precision, the port of the JAX package's
``parallel/schedule.py``.

A model requests, per axis::

    schedule = OverlapSchedule.build(
        gather("fsdp", granularity="block", prefetch=1),
        scatter("fsdp"),
        gather("model", granularity="ring_chunk", lowp="int8"),
        scatter("model", lowp="int8"),
    )

and one executor (``hooked_model``) lowers it onto the port's
machinery:

- ``granularity="block"``: each block all-gathers its own ``fsdp``
  shards just before its compute, ``prefetch`` blocks ahead, and
  reduce-scatters its gradient into the shards as its backward ends
  (``parallel/fsdp_overlap.py``);
- ``granularity="ring_chunk"``: the four per-block ``model`` products
  become the bidirectional collective-matmul rings
  (``ops/collective_matmul.py`` through ``parallel/tp_overlap.py``),
  the residual stream sharded over the axis between them;
- ``lowp``: low precision is an attribute of the transfer: a ring-chunk
  rule with ``lowp`` streams quantized chunks and their scales on every
  hop, forward and backward.

The knobs (``parallel.fsdp_overlap``, ``fsdp_prefetch``, ``tp_overlap``,
``low_precision``) derive this schedule (``schedule_from_config``); a
``parallel.schedule`` string declares it directly (``parse_schedule``)
and must agree with any knob that is also set. A contradictory
declaration raises a ``ScheduleError`` naming the attribute at fault,
with the reference's words, when the Trainer is built.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import resolve_lowp

#: Transfer granularities a gather/scatter rule may declare.
GRANULARITIES = ("block", "ring_chunk")

#: Reductions a scatter rule may declare (the rings/reduce-scatter are sums).
REDUCE_OPS = ("sum",)

#: Axes with a lowering: blockwise param gathers ride ``fsdp``; collective-
#: matmul rings ride ``model``. Other mesh axes have no overlap machinery.
BLOCK_AXES = ("fsdp",)
RING_AXES = ("model",)


class ScheduleError(ValueError):
    """A malformed or contradictory overlap-schedule declaration.

    ``attribute`` names the schedule attribute at fault (``axis``,
    ``granularity``, ``prefetch``, ``lowp``, ``reduce``, ``schedule`` for
    whole-declaration conflicts) so config tooling can point at the knob
    instead of the user reading a shape error out of a block.
    """

    def __init__(self, attribute: str, message: str):
        self.attribute = attribute
        super().__init__(f"overlap schedule [{attribute}]: {message}")


@dataclass(frozen=True)
class GatherRule:
    """One axis's gather declaration: how this axis's sharded operands
    reach their consumers. ``prefetch`` applies to ``block`` granularity
    (how many blocks ahead a gather may be issued); ``lowp`` to
    ``ring_chunk`` (quantize every chunk transfer)."""

    axis: str
    granularity: str = "block"
    prefetch: int = 1
    lowp: str | None = None


@dataclass(frozen=True)
class ScatterRule:
    """One axis's scatter declaration: how results/gradients return to
    shards — the gather's transpose (explicit reduce_scatter for
    ``block``, the rotating matmul-reduce-scatter ring for
    ``ring_chunk``)."""

    axis: str
    reduce: str = "sum"
    lowp: str | None = None


def gather(
    axis: str,
    *,
    granularity: str = "block",
    prefetch: int = 1,
    lowp: str | None = None,
) -> GatherRule:
    """Declare one axis's gather. Structural errors (unknown granularity,
    negative prefetch, lowp on a non-ring transfer) raise ``ScheduleError``
    here, at declaration time."""
    if granularity not in GRANULARITIES:
        raise ScheduleError(
            "granularity",
            f"unknown granularity {granularity!r} for axis {axis!r} "
            f"(known: {GRANULARITIES})",
        )
    if prefetch < 0:
        raise ScheduleError(
            "prefetch",
            f"parallel.fsdp_prefetch must be >= 0, got {prefetch} "
            f"(axis {axis!r})",
        )
    if granularity != "block" and prefetch != 1:
        raise ScheduleError(
            "prefetch",
            f"prefetch={prefetch} declared on a {granularity!r} gather of "
            f"axis {axis!r}: the prefetch window is a block-granularity "
            "attribute (ring chunks stream hop by hop)",
        )
    lowp = resolve_lowp(lowp)
    if lowp is not None and granularity != "ring_chunk":
        raise ScheduleError(
            "lowp",
            f"lowp={lowp!r} declared on a {granularity!r} gather of axis "
            f"{axis!r}: low precision is a ring-chunk transfer attribute "
            "(blockwise param gathers move master-dtype shards)",
        )
    return GatherRule(axis=axis, granularity=granularity, prefetch=prefetch,
                      lowp=lowp)


def scatter(
    axis: str, *, reduce: str = "sum", lowp: str | None = None
) -> ScatterRule:
    """Declare one axis's scatter (the gather's transpose)."""
    if reduce not in REDUCE_OPS:
        raise ScheduleError(
            "reduce",
            f"unknown reduce {reduce!r} for axis {axis!r} "
            f"(known: {REDUCE_OPS})",
        )
    return ScatterRule(axis=axis, reduce=reduce, lowp=resolve_lowp(lowp))


@dataclass(frozen=True)
class OverlapSchedule:
    """The full declaration: per-axis gather/scatter rules.

    Construct via ``build`` (or ``parse_schedule``) so the cross-rule
    invariants hold; the Trainer derives one from the config
    (``schedule_from_config``) and hands it to ``hooked_model`` — the
    executor that lowers it onto the blockwise-gather and
    collective-matmul machinery.
    """

    gathers: tuple[GatherRule, ...] = ()
    scatters: tuple[ScatterRule, ...] = ()

    # ----------------------------------------------------------- builders

    @staticmethod
    def build(*rules: GatherRule | ScatterRule) -> "OverlapSchedule":
        gs: list[GatherRule] = []
        ss: list[ScatterRule] = []
        for r in rules:
            if isinstance(r, GatherRule):
                gs.append(r)
            elif isinstance(r, ScatterRule):
                ss.append(r)
            else:
                raise ScheduleError(
                    "schedule", f"not a gather/scatter rule: {r!r}"
                )
        sched = OverlapSchedule(gathers=tuple(gs), scatters=tuple(ss))
        sched._check_structure()
        return sched

    def _check_structure(self) -> None:
        for rules, kind in ((self.gathers, "gather"),
                            (self.scatters, "scatter")):
            axes = [r.axis for r in rules]
            dup = {a for a in axes if axes.count(a) > 1}
            if dup:
                raise ScheduleError(
                    "axis",
                    f"duplicate {kind} rules for axes {sorted(dup)} — one "
                    "declaration per axis",
                )
        for g in self.gathers:
            if g.granularity == "block" and g.axis not in BLOCK_AXES:
                raise ScheduleError(
                    "axis",
                    f"blockwise gathers are the param-shard schedule of "
                    f"the fsdp axis; axis {g.axis!r} has no block lowering "
                    f"(block axes: {BLOCK_AXES})",
                )
            if g.granularity == "ring_chunk" and g.axis not in RING_AXES:
                raise ScheduleError(
                    "axis",
                    f"ring-chunk gathers are the collective-matmul "
                    f"schedule of the model axis; axis {g.axis!r} has no "
                    f"ring lowering (ring axes: {RING_AXES})",
                )
        gather_axes = {g.axis for g in self.gathers}
        for s in self.scatters:
            if s.axis not in gather_axes:
                raise ScheduleError(
                    "axis",
                    f"scatter on axis {s.axis!r} without a matching gather "
                    "— a scatter is the transpose of its axis's gather",
                )
        # ``lowp`` is a property of the axis's WIRE: the forward ring and
        # its transpose quantize together (a block gather's lowp is
        # already refused in ``gather``, so a lowp scatter on a block
        # axis lands here as a mismatch).
        for g in self.gathers:
            s = self.scatter_on(g.axis)
            if s is not None and s.lowp != g.lowp:
                raise ScheduleError(
                    "lowp",
                    f"axis {g.axis!r} declares gather lowp={g.lowp!r} but "
                    f"scatter lowp={s.lowp!r} — the forward ring and its "
                    "transpose quantize the same wire",
                )

    # ------------------------------------------------------------ lookups

    def gather_on(self, axis: str) -> GatherRule | None:
        for g in self.gathers:
            if g.axis == axis:
                return g
        return None

    def scatter_on(self, axis: str) -> ScatterRule | None:
        for s in self.scatters:
            if s.axis == axis:
                return s
        return None

    def block_gather(self) -> GatherRule | None:
        """The (at most one) blockwise param-gather rule."""
        for g in self.gathers:
            if g.granularity == "block":
                return g
        return None

    def ring_gather(self) -> GatherRule | None:
        """The (at most one) ring-chunk rule."""
        for g in self.gathers:
            if g.granularity == "ring_chunk":
                return g
        return None

    # --------------------------------------------------------- rendering

    def render(self) -> str:
        """Canonical declaration string (``parse_schedule``'s inverse)."""
        parts = []
        for g in self.gathers:
            attrs = [g.axis, g.granularity]
            if g.granularity == "block":
                attrs.append(f"prefetch={g.prefetch}")
            if g.lowp is not None:
                attrs.append(f"lowp={g.lowp}")
            parts.append(f"gather({','.join(attrs)})")
        for s in self.scatters:
            attrs = [s.axis, f"reduce={s.reduce}"]
            if s.lowp is not None:
                attrs.append(f"lowp={s.lowp}")
            parts.append(f"scatter({','.join(attrs)})")
        return "+".join(parts)

    def short(self) -> str:
        """Compact per-axis summary for table columns, e.g.
        ``fsdp:block(p1)+model:ring(int8)``."""
        parts = []
        for g in self.gathers:
            if g.granularity == "block":
                parts.append(f"{g.axis}:block(p{g.prefetch})")
            else:
                parts.append(
                    f"{g.axis}:ring({g.lowp})" if g.lowp
                    else f"{g.axis}:ring"
                )
        return "+".join(parts) or "gspmd"

    def describe(self) -> dict:
        """JSON-able descriptor — the per-schedule identity the perf
        records carry."""
        return {
            "declared": self.render(),
            "short": self.short(),
            "gathers": [
                {"axis": g.axis, "granularity": g.granularity,
                 "prefetch": g.prefetch, "lowp": g.lowp or "off"}
                for g in self.gathers
            ],
            "scatters": [
                {"axis": s.axis, "reduce": s.reduce, "lowp": s.lowp or "off"}
                for s in self.scatters
            ],
        }


_TERM_RE = re.compile(r"^(gather|scatter)\(([^()]*)\)$")


def parse_schedule(text: str) -> OverlapSchedule:
    """Parse the declaration grammar::

        gather(AXIS[,GRANULARITY][,prefetch=N][,lowp=FMT])
        scatter(AXIS[,reduce=OP][,lowp=FMT])

    joined by ``+`` (whitespace-insensitive), e.g.
    ``gather(fsdp,block,prefetch=1)+scatter(fsdp)+
    gather(model,ring_chunk,lowp=int8)+scatter(model,lowp=int8)``.
    """
    terms = [t for t in re.sub(r"\s+", "", text).split("+") if t]
    if not terms:
        raise ScheduleError("schedule", f"empty schedule string {text!r}")
    rules: list[GatherRule | ScatterRule] = []
    for term in terms:
        m = _TERM_RE.match(term)
        if not m:
            raise ScheduleError(
                "schedule",
                f"cannot parse term {term!r} (expected "
                "gather(axis,...) or scatter(axis,...))",
            )
        kind, body = m.group(1), m.group(2)
        args = [a for a in body.split(",") if a]
        if not args:
            raise ScheduleError(
                "axis", f"{kind}() needs at least an axis name: {term!r}"
            )
        pos: list[str] = []
        kw: dict[str, str] = {}
        for a in args:
            if "=" in a:
                k, v = a.split("=", 1)
                kw[k] = v
            elif kw:
                raise ScheduleError(
                    "schedule",
                    f"positional attr after keyword attr in {term!r}",
                )
            else:
                pos.append(a)
        axis = pos[0]
        if kind == "gather":
            if len(pos) > 2:
                raise ScheduleError(
                    "schedule", f"too many positional attrs in {term!r}"
                )
            granularity = pos[1] if len(pos) > 1 else \
                kw.pop("granularity", "block")
            unknown = set(kw) - {"prefetch", "lowp"}
            if unknown:
                raise ScheduleError(
                    "schedule",
                    f"unknown gather attr(s) {sorted(unknown)} in {term!r}",
                )
            try:
                prefetch = int(kw.get("prefetch", "1"))
            except ValueError:
                raise ScheduleError(
                    "prefetch",
                    f"prefetch must be an integer: {term!r}",
                ) from None
            rules.append(gather(
                axis, granularity=granularity, prefetch=prefetch,
                lowp=kw.get("lowp"),
            ))
        else:
            if len(pos) > 1:
                raise ScheduleError(
                    "schedule", f"too many positional attrs in {term!r}"
                )
            unknown = set(kw) - {"reduce", "lowp"}
            if unknown:
                raise ScheduleError(
                    "schedule",
                    f"unknown scatter attr(s) {sorted(unknown)} in {term!r}",
                )
            rules.append(scatter(
                axis, reduce=kw.get("reduce", "sum"), lowp=kw.get("lowp"),
            ))
    return OverlapSchedule.build(*rules)


# ------------------------------------------------------- config derivation


def schedule_from_config(cfg) -> OverlapSchedule | None:
    """The config's declared schedule, or None when no overlap schedule is
    requested.

    ``parallel.schedule="auto"`` (the default) derives the schedule from
    the legacy knobs — ``fsdp_overlap``/``fsdp_prefetch`` become the
    blockwise fsdp pair, ``tp_overlap``/``low_precision`` the ring-chunk
    model pair — preserving their exact semantics through the adapters.
    An explicit declaration string replaces the derivation and must AGREE
    with any legacy knob that is also set (a contradiction is a
    ``ScheduleError``, not a silent override).

    Build-time contradiction checks live here and in
    ``validate_schedule_config`` — e.g. ``parallel.low_precision``
    without any ring axis refuses loudly instead of silently changing
    nothing.
    """
    p = cfg.parallel
    declared = getattr(p, "schedule", "auto")
    if declared in ("", "auto"):
        return _schedule_from_knobs(p)
    sched = parse_schedule(declared)
    # The declaration replaces the derivation; any legacy knob that IS
    # set must agree with it, per knob (so e.g. low_precision=int8 next
    # to a string that declares the int8 ring is consistent even with
    # tp_overlap left false).
    block, ring = sched.block_gather(), sched.ring_gather()
    if p.fsdp_overlap and (
        block is None or block.prefetch != p.fsdp_prefetch
    ):
        raise ScheduleError(
            "schedule",
            f"parallel.schedule={declared!r} contradicts "
            f"parallel.fsdp_overlap=true/fsdp_prefetch={p.fsdp_prefetch} "
            f"(the knobs derive gather(fsdp,block,prefetch="
            f"{p.fsdp_prefetch})) — declare one or the other",
        )
    if p.tp_overlap and ring is None:
        raise ScheduleError(
            "schedule",
            f"parallel.schedule={declared!r} contradicts "
            "parallel.tp_overlap=true (the knob derives "
            "gather(model,ring_chunk)) — declare one or the other",
        )
    lowp = resolve_lowp(p.low_precision)
    if lowp is not None:
        if ring is None:
            _refuse_lowp_without_rings(p)
        if ring.lowp != lowp:
            raise ScheduleError(
                "lowp",
                f"parallel.schedule={declared!r} contradicts "
                f"parallel.low_precision={p.low_precision!r}: the declared "
                f"ring carries lowp={ring.lowp!r} — declare one or the "
                "other",
            )
    return sched


def _schedule_from_knobs(p) -> OverlapSchedule | None:
    rules: list[GatherRule | ScatterRule] = []
    if p.fsdp_overlap:
        rules.append(gather("fsdp", granularity="block",
                            prefetch=p.fsdp_prefetch))
        rules.append(scatter("fsdp"))
    if p.tp_overlap:
        lowp = resolve_lowp(p.low_precision)
        rules.append(gather("model", granularity="ring_chunk", lowp=lowp))
        rules.append(scatter("model", lowp=lowp))
    elif p.low_precision != "none":
        _refuse_lowp_without_rings(p)
    if not rules:
        return None
    return OverlapSchedule.build(*rules)


def _refuse_lowp_without_rings(p) -> None:
    # Keeps the Trainer's historical phrasing: the knob quantizes the
    # rings; with no ring axis declared it would silently change nothing.
    raise ScheduleError(
        "lowp",
        f"parallel.low_precision={p.low_precision!r} requires a ring-chunk "
        "gather axis (parallel.tp_overlap=true): the low-precision fast "
        "path lives in the collective-matmul rings; there is no GSPMD "
        "low-precision schedule to fall back to",
    )


# ----------------------------------------------------- config validation


def model_block_count(model_cfg) -> int | None:
    """How many hook-able blocks the model family stacks — the bound the
    prefetch window is checked against (None: family without blockwise
    hooks; the family check itself raises elsewhere)."""
    family = getattr(model_cfg, "family", None)
    if family == "gpt":
        return int(model_cfg.num_layers)
    if family == "resnet":
        from frl_distributed_ml_scaffold_tpu_torch.models.resnet import (
            STAGE_SIZES,
        )

        sizes = STAGE_SIZES.get(model_cfg.depth)
        return int(sum(sizes)) if sizes else None
    return None


def validate_schedule_config(sched: OverlapSchedule, cfg) -> None:
    """Everything the schedule + config (but not the live mesh) can
    refuse: the adapters' checks, centralized, plus the contradictions
    that would otherwise surface as shape errors inside a block.
    Mesh-dependent checks (axis sizes, chunk divisibility) stay with the
    hook builders, which see the resolved mesh."""
    block = sched.block_gather()
    ring = sched.ring_gather()
    if block is not None:
        from frl_distributed_ml_scaffold_tpu_torch.parallel.fsdp_overlap import (
            validate_block_schedule,
        )

        validate_block_schedule(cfg, prefetch=block.prefetch)
        n_blocks = model_block_count(cfg.model)
        if n_blocks is not None and block.prefetch > n_blocks:
            raise ScheduleError(
                "prefetch",
                f"prefetch window {block.prefetch} exceeds the model's "
                f"block count {n_blocks} ({cfg.model.family}): there is "
                "nothing to issue that far ahead — shrink "
                "parallel.fsdp_prefetch",
            )
    if ring is not None:
        from frl_distributed_ml_scaffold_tpu_torch.parallel.tp_overlap import (
            validate_ring_schedule,
        )

        validate_ring_schedule(cfg, lowp=ring.lowp)


# ------------------------------------------------------------ the executor


def hooked_model(sched: OverlapSchedule, model, cfg, env, layout) -> None:
    """THE executor: attach to ``model`` every hook the schedule's rules
    lower to, in place: the blockwise param gathers (``param_hooks``,
    ``parallel/fsdp_overlap.py`` ``BlockGather`` over ``layout``'s
    specs) and the collective-matmul rings (``tp_overlap``,
    ``parallel/tp_overlap.py`` ``make_tp_hooks``), both when both axes
    are declared. The training and eval forward read them; decode does
    not, and the parameters are the same either way."""
    from frl_distributed_ml_scaffold_tpu_torch.parallel import (
        fsdp_overlap,
        tp_overlap,
    )

    hooks = {}
    block = sched.block_gather()
    if block is not None:
        hooks["param_hooks"] = fsdp_overlap.BlockGather(
            layout, prefetch=block.prefetch, axis=block.axis,
            block_remat=getattr(cfg.model, "block_remat", "none"))
    if sched.ring_gather() is not None:
        hooks["tp_overlap"] = tp_overlap.make_tp_hooks(cfg, env)
    model.attach(**hooks)
