"""Partition specs of the parameters and the optimizer state: the port
of the JAX package's ``parallel/partition.py``.

A spec is a tuple with one entry per dim of a tensor: a mesh axis name
(the dim is split over that axis) or None (whole). A split dim of size n
over k members gives member i the rows ``[i c, (i+1) c)`` cut at n, with
``c = ceil(n / k)`` (GSPMD's padded bounds), so the odd vocabulary of
``gpt2_tp`` over ``model=2`` splits 25129 + 25128; the jax the JAX
package runs on refuses to place that split at all.

The decisions are the JAX package's, made where the JAX package makes
them, on the JAX leaf:

1. **Model rules** (``PartitionRules``): regex -> spec pairs, first
   match wins, no match replicated. The port's rules are written
   against the port's parameter names and layouts (``models/gpt.py``
   ``gpt_tp_rules``, ``models/vit.py`` ``vit_tp_rules``).
2. **FSDP overlay** (``param_sharding="fsdp"``): ``fsdp`` on the largest
   dim that is unsplit and divisible by the axis size, ties to the first;
   leaves under ``fsdp_min_size`` elements stay replicated.
3. **Optimizer state** mirrors the param specs; ``zero1`` overlays
   ``fsdp`` onto them by the same rule while the params stay as they are.

Steps 2 and 3 read the JAX leaf a port tensor belongs to (``JaxLeaf``):
its shape (the JAX GPT stacks every block's tensor on a leading ``[L]``
axis; flax kernels are ``[in, out]`` where torch weights are ``[out,
in]``; flax attention kernels keep the heads as a dim of their own) and
which port dim each of its dims is the leading factor of. The overlay is
decided on the JAX shape, so ``fsdp_min_size`` counts the stacked leaf
and the tie-break follows the JAX dim order. Where the JAX rule picks a
dim the port tensor cannot split on its own (the stacked layer dim, or
the inner factor of a flattened dim), the port picks the best of the
dims it can split by the same rule: the per-rank bytes stay the same
whenever such a dim divides too. ``jax_spec_of`` maps a port spec back
onto the JAX leaf's dims.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Sequence

from frl_distributed_ml_scaffold_tpu_torch.config.schema import ParallelConfig

Spec = tuple


@dataclass(frozen=True)
class PartitionRules:
    """Ordered regex -> spec rules (first match wins). ``stage`` (the
    pipelined GPT's rules) places each parameter on the ``pipe`` rank
    that holds it (None: on every one): the port's counterpart of the
    JAX pipelined rules' leading ``pipe`` entry, a layer being a tensor
    of its own here (``parallel/layout.py``)."""

    rules: tuple[tuple[str, Spec], ...] = ()
    stage: Any = None

    def match(self, name: str) -> Spec | None:
        for pattern, spec in self.rules:
            if re.search(pattern, name):
                return spec
        return None


@dataclass(frozen=True)
class JaxLeaf:
    """The JAX leaf a port tensor belongs to: its path (flax's names
    joined by ``/``), its shape, and for each of its dims the port dim it
    is the leading factor of (None: the stacked layer dim, or an inner
    factor of a flattened port dim)."""

    name: str
    shape: tuple[int, ...]
    dims: tuple[int | None, ...]


def normalize(spec: Spec | None, ndim: int) -> Spec:
    """``spec`` padded with None to ``ndim`` entries."""
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def _has(entries, axis: str) -> bool:
    return any(axis == e or (isinstance(e, tuple) and axis in e)
               for e in entries)


def fsdp_spec_for(shape: Sequence[int], base: Spec, *, axis: str = "fsdp",
                  axis_size: int, min_size: int,
                  allowed: Sequence[int] | None = None) -> Spec:
    """Overlay ``axis`` onto ``base`` for an array of ``shape``: the
    largest dim unsplit in ``base`` and divisible by ``axis_size`` (ties
    to the first; ``allowed`` restricts the candidates)."""
    n = 1
    for d in shape:
        n *= int(d)
    entries = normalize(base, len(shape))
    if axis_size <= 1 or n < min_size or _has(entries, axis):
        return entries
    candidates = [
        i for i, (dim, e) in enumerate(zip(shape, entries))
        if e is None and dim % axis_size == 0 and dim >= axis_size
        and (allowed is None or i in allowed)
    ]
    if not candidates:
        return entries
    best = max(candidates, key=lambda i: shape[i])
    return entries[:best] + (axis,) + entries[best + 1:]


def jax_spec_of(spec: Spec, leaf: JaxLeaf) -> Spec:
    """A port spec on the dims of its JAX leaf."""
    return tuple(None if j is None else spec[j] for j in leaf.dims)


def _port_spec_of(jax_spec: Spec, leaf: JaxLeaf, ndim: int) -> Spec:
    out = [None] * ndim
    for i, e in enumerate(jax_spec):
        if e is not None:
            out[leaf.dims[i]] = e
    return tuple(out)


def overlay(leaf: JaxLeaf, base: Spec, *, axis_size: int,
            min_size: int) -> Spec:
    """The FSDP overlay of a port spec, decided on its JAX leaf (module
    docstring)."""
    if axis_size <= 1:
        return base
    ndim = len(base)
    jbase = jax_spec_of(base, leaf)
    jspec = fsdp_spec_for(leaf.shape, jbase, axis_size=axis_size,
                          min_size=min_size)
    picked = [i for i, (a, b) in enumerate(zip(jspec, jbase)) if a != b]
    if picked and leaf.dims[picked[0]] is None:
        ok = [i for i, j in enumerate(leaf.dims) if j is not None]
        jspec = fsdp_spec_for(leaf.shape, jbase, axis_size=axis_size,
                              min_size=min_size, allowed=ok)
    return _port_spec_of(jspec, leaf, ndim)


def param_specs(shapes: dict[str, Sequence[int]], parallel: ParallelConfig,
                axis_sizes: dict[str, int], leaves: dict[str, JaxLeaf],
                rules: PartitionRules | None = None) -> dict[str, Spec]:
    """The spec of every parameter (``shapes`` by name; ``leaves`` their
    JAX leaves; ``axis_sizes`` the mesh's)."""
    out = {}
    for name, shape in shapes.items():
        base = normalize(rules.match(name) if rules else None, len(shape))
        if parallel.param_sharding == "fsdp":
            base = overlay(leaves.get(name), base, axis_size=axis_sizes["fsdp"],
                           min_size=parallel.fsdp_min_size)
        elif parallel.param_sharding != "replicated":
            raise ValueError(
                f"unknown param_sharding {parallel.param_sharding!r}")
        out[name] = base
    return out


def opt_state_specs(p_specs: dict[str, Spec], parallel: ParallelConfig,
                    axis_sizes: dict[str, int],
                    leaves: dict[str, JaxLeaf]) -> dict[str, Spec]:
    """The spec of every parameter-shaped optimizer tensor, by the
    parameter's name: the param's own (``like_params``), or with
    ``zero1`` the FSDP overlay on top of it."""
    if parallel.opt_sharding == "like_params":
        return dict(p_specs)
    if parallel.opt_sharding != "zero1":
        raise ValueError(f"unknown opt_sharding {parallel.opt_sharding!r}")
    return {name: overlay(leaves.get(name), spec, axis_size=axis_sizes["fsdp"],
                          min_size=parallel.fsdp_min_size)
            for name, spec in p_specs.items()}


def serving_specs(model, env, rules: PartitionRules | None) -> dict[str, Spec]:
    """The spec of every parameter of ``model`` on a serving mesh ``env``
    by its TP ``rules``: each rule's ``model`` split, every other
    parameter whole. Serving has no optimizer state and no FSDP overlay
    (the JAX function's replicated ``ParallelConfig()`` base), so only
    ``rules`` decides, with two choices of the port: the tensors the
    model reads whole (``TP_COMPUTE_WHOLE``: the GPT's tied embedding and
    head) stay whole on every rank, so the logits come out whole and the
    same on every rank without a gather; and where the heads do not
    divide over ``model`` (the JAX model leaves that cache unconstrained
    and decodes every head) the attention's projections stay whole and
    each rank attends every head, while the MLP still splits."""
    shapes = {k: tuple(p.shape) for k, p in type(model)(
        model.config, model.policy, device="meta").named_parameters()}
    keep = set(getattr(type(model), "TP_COMPUTE_WHOLE", ()))
    if model.config.num_heads % env.axis_size("model"):
        keep |= {k for k in shapes if ".attn." in k}
    out = {}
    for name, shape in shapes.items():
        spec = normalize(rules.match(name) if rules else None, len(shape))
        if name in keep:
            spec = (None,) * len(shape)
        for e in spec:
            if e is not None and e != "model":
                raise ValueError(
                    f"{name}: serving splits over model only, the rule "
                    f"gives {spec}")
        out[name] = spec
    return out


def shard_params_for_serving(model, env, rules: PartitionRules, *,
                             layout=None):
    """Place a model's parameters onto a serving mesh by its TP rules
    (``serving_specs``), in place: each parameter a rule splits over
    ``model`` keeps this rank's slice (``layout.chunk_bounds``), every
    other one stays whole. Returns the model.

    A model holding the whole parameters (a host tree) narrows them
    here, with no communication. A model holding a training layout's
    shards (``layout``, the ``StateLayout`` they are split by) is placed
    through the redistribution service (``redistribute.train_to_serve``):
    every rank of the training and the serving mesh calls this, each
    sends the chunks the others lack. A rank outside the serving mesh is
    left holding no parameters (empty tensors) either way."""
    import torch

    from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import (
        chunk_bounds,
    )

    params = dict(model.named_parameters())
    if layout is not None:
        from frl_distributed_ml_scaffold_tpu_torch import redistribute

        placed, _ = redistribute.train_to_serve(
            {k: p.data for k, p in params.items()}, env, rules,
            layout=layout, model=model, donate=True)
        with torch.no_grad():
            for name, p in params.items():
                p.data = placed.get(name, p.data.new_empty(0))
        return model
    if not env.member:
        # A rank outside the serving mesh serves nothing (a dormant
        # engine, serving/engine.py): it keeps no parameters.
        with torch.no_grad():
            for p in params.values():
                p.data = p.data.new_empty(0)
        return model
    specs = serving_specs(model, env, rules)
    whole = dict(type(model)(model.config, model.policy,
                             device="meta").named_parameters())
    if any(p.shape != whole[k].shape for k, p in params.items()):
        raise ValueError(
            "shard_params_for_serving: the model holds split parameters (a "
            "training layout's shards); pass layout= (the StateLayout they "
            "are split by) to move them through the redistribution service")
    with torch.no_grad():
        for name, p in params.items():
            for d, e in enumerate(specs[name]):
                if e is None:
                    continue
                lo, hi = chunk_bounds(p.shape[d], env.axis_size(e),
                                      env.axis_index(e))
                p.data = p.data.narrow(d, lo, hi - lo).clone(
                    memory_format=torch.contiguous_format)
    return model


# --------------------------------------------------------------- JAX leaves


def _gpt_leaf(name: str, shape, cfg) -> JaxLeaf:
    shape = tuple(shape)
    head, _, rest = name.partition(".")
    if head != "blocks":
        jname = {"wte.weight": "wte/embedding", "wpe": "wpe",
                 "ln_f.weight": "ln_f/scale",
                 "ln_f.bias": "ln_f/bias"}[name]
        return JaxLeaf(jname, shape, tuple(range(len(shape))))
    parts = rest.split(".")[1:]  # drop the layer index
    mod, leaf = "/".join(parts[:-1]), parts[-1]
    stack = (cfg.num_layers,)
    if mod == "moe" and leaf in ("wi", "wo"):  # the experts, as they are
        return JaxLeaf(f"blocks/moe/{leaf}", stack + shape,
                       (None,) + tuple(range(len(shape))))
    if leaf == "weight" and len(shape) == 2:  # Dense: [out, in] -> [in, out]
        return JaxLeaf(f"blocks/{mod}/kernel", stack + shape[::-1],
                       (None, 1, 0))
    jleaf = {"weight": "scale", "bias": "bias"}[leaf]
    if mod.startswith(("attn", "mlp", "moe")):
        jleaf = "bias"
    return JaxLeaf(f"blocks/{mod}/{jleaf}", stack + shape, (None, 0))


def _vit_leaf(name: str, shape, cfg) -> JaxLeaf:
    shape = tuple(shape)
    d, h = cfg.hidden_dim, cfg.num_heads
    if name == "embed.weight":  # [D, prod(sizes) C] <- (*sizes, C, D)
        sizes = (tuple(cfg.tubelet_size) if hasattr(cfg, "tubelet_size")
                 else (cfg.patch_size, cfg.patch_size))
        c = shape[1] // math.prod(sizes)
        k = len(sizes)
        return JaxLeaf("Conv_0/kernel", (*sizes, c, d),
                       (1,) + (None,) * k + (0,))
    if name in ("embed.bias", "cls_token", "pos_embedding"):
        jname = "Conv_0/bias" if name == "embed.bias" else name
        return JaxLeaf(jname, shape, tuple(range(len(shape))))
    top = {"ln.weight": "LayerNorm_0/scale", "ln.bias": "LayerNorm_0/bias",
           "head.weight": "Dense_0/kernel", "head.bias": "Dense_0/bias"}
    if name in top:
        if name == "head.weight":
            return JaxLeaf(top[name], shape[::-1], (1, 0))
        return JaxLeaf(top[name], shape, (0,))
    _, i, *mods, leaf = name.split(".")
    pre = f"EncoderBlock_{i}/"
    if mods[0] in ("ln1", "ln2"):
        ln = "LayerNorm_0" if mods[0] == "ln1" else "LayerNorm_1"
        return JaxLeaf(f"{pre}{ln}/{'scale' if leaf == 'weight' else 'bias'}",
                       shape, (0,))
    if mods[0] == "mlp":
        dense = "Dense_0" if mods[1] == "fc_in" else "Dense_1"
        jname = f"{pre}MlpBlock_0/{dense}/"
        if leaf == "weight":
            return JaxLeaf(jname + "kernel", shape[::-1], (1, 0))
        return JaxLeaf(jname + "bias", shape, (0,))
    jname = f"{pre}MultiHeadDotProductAttention_0/{mods[1]}/"
    if mods[1] == "out":
        if leaf == "weight":  # [D, H hd] <- (H, hd, D)
            return JaxLeaf(jname + "kernel", (h, d // h, d), (1, None, 0))
        return JaxLeaf(jname + "bias", shape, (0,))
    if leaf == "weight":  # [H hd, D] <- (D, H, hd)
        return JaxLeaf(jname + "kernel", (d, h, d // h), (1, 0, None))
    return JaxLeaf(jname + "bias", (h, d // h), (0, None))


def _resnet_leaf(name: str, shape, cfg) -> JaxLeaf:
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        _BLOCK_LAYERS,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.resnet import BOTTLENECK

    shape = tuple(shape)
    bn = "FusedBatchNorm" if cfg.fused_bn else "BatchNorm"
    block = "BottleneckBlock" if BOTTLENECK[cfg.depth] else "BasicBlock"
    *mods, leaf = name.split(".")
    if mods[0] == "head":
        if leaf == "weight":
            return JaxLeaf("Dense_0/kernel", shape[::-1], (1, 0))
        return JaxLeaf("Dense_0/bias", shape, (0,))
    if mods[0] == "blocks":
        layers = _BLOCK_LAYERS[block]
        j = next(k for k, pair in enumerate(layers) if mods[2] in pair)
        kind = "Conv" if mods[2] == layers[j][0] else bn
        path = f"{block}_{mods[1]}/{kind}_{j}"
    else:
        path = {"stem_conv": "Conv_0", "stem_s2d": "stem_s2d",
                "stem_bn": f"{bn}_0"}[mods[0]]
    if leaf == "weight":  # OIHW <- HWIO
        h, w = shape[2], shape[3]
        return JaxLeaf(f"{path}/kernel", (h, w, shape[1], shape[0]),
                       (2, 3, 1, 0))
    return JaxLeaf(f"{path}/{leaf}", shape, (0,))


def _mlp_leaf(name: str, shape, cfg) -> JaxLeaf:
    shape = tuple(shape)
    _, i, leaf = name.split(".")
    if leaf == "weight":
        return JaxLeaf(f"Dense_{i}/kernel", shape[::-1], (1, 0))
    return JaxLeaf(f"Dense_{i}/bias", shape, (0,))


_LEAVES = {"gpt": _gpt_leaf, "vit": _vit_leaf, "video": _vit_leaf,
           "resnet": _resnet_leaf, "mlp": _mlp_leaf}


def jax_leaves(model_cfg: Any, shapes: dict[str, Sequence[int]]
               ) -> dict[str, JaxLeaf]:
    """The JAX leaf of every port parameter of a ``model_cfg`` model."""
    fn = _LEAVES[model_cfg.family]
    return {name: fn(name, shape, model_cfg) for name, shape in shapes.items()}
