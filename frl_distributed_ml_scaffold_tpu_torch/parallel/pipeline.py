"""Pipeline parallelism, the SPMD backend: the port of the JAX package's
``parallel/pipeline.py`` (the GPipe and circular schedules).

The JAX backend is one compiled program: the stage weights carry a
leading ``[S, ...]`` dim sharded over ``pipe`` and a rolled buffer is
the stage-to-stage send. Here each ``pipe`` rank runs one stage, and the
boundary activations and their cotangents go point to point
(``dist/collectives.py`` ``exchange_start``, counted in ``wire_bytes``
under ``pipe``); with ``mesh.pipe == 1`` one process runs every stage,
the handoffs moving through in-memory queues (``Mailbox``), as the JAX
model runs all stages on one device. The state keeps the plain GPT's
names with global layer indices: rank j holds its own layers
(``stage_layers``) and, under this backend, the embedding, the final
LayerNorm and the tied head whole, as the JAX rules leave them
replicated over ``pipe``.

The timeline (``Timeline``) is the JAX scan's, tick by tick: ``v M + S
- 1`` ticks (``v = 1``: GPipe), stage j working at tick t on microbatch
``(t - j) mod M`` of repeat ``r = (t - j) // M`` while ``0 <= t - j <
v M``; every other (stage, tick) is a bubble and computes nothing, so it
adds no aux and sends nothing. Repeat r of stage j runs virtual stage
``r S + j``, the layer group ``[(r S + j) lg, (r S + j + 1) lg)`` (``lg
= L / (S v)``). A microbatch leaving stage S-1 before its last repeat
re-enters stage 0 ``M - S`` ticks later; in between it waits in stage
0's parking FIFO of ``M - S + 1`` slots (hence ``M >= S``).

The forward runs the ticks in order, the last stage computing each
microbatch's loss (``ln_f``, then the head and loss the caller hands in:
the trainer's weight-tied head and CE) as it emerges, and its cotangent
at once, so no more than one microbatch's logits exist. The backward runs the ticks in reverse:
each (stage, tick) takes the cotangent of its output, differentiates its
own stage with ``torch.autograd.grad`` and sends the cotangent of its
input back: the reverse pipeline that JAX's autodiff of the scan gives.
The gradients accumulate in fp32. ``trainer.remat`` checkpoints each
stage's tick (``dots`` saving the matrix products' outputs), and
``model.pipeline_stage_remat`` checkpoints it whole, the layer group's
parameters selected inside the checkpointed region (the JAX comment's
point: selected outside, every tick's selection would be saved).
``model.block_remat`` does not apply inside a pipeline, as in the
reference.
"""

from __future__ import annotations

import collections
import functools
from typing import Any

import torch
from torch.func import functional_call
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from frl_distributed_ml_scaffold_tpu_torch.dist.collectives import (
    exchange_start,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.step_utils import (
    batch_mean,
    save_dots,
    to_device,
)


def effective_microbatches(model_cfg) -> int:
    """The one resolution rule for the pipeline microbatch count: the
    configured value, defaulting to the stage count (minimum bubble-free
    fill). Single source of truth for the model, trainer init sizing, and
    bubble-fraction logging."""
    stages = getattr(model_cfg, "pipeline_stages", 1)
    if stages <= 1:
        return 1
    return getattr(model_cfg, "pipeline_microbatches", 0) or stages


def circular_repeat(model_cfg) -> int:
    """Virtual-stage multiplier of the circular schedule (1 = plain GPipe)."""
    if getattr(model_cfg, "pipeline_stages", 1) <= 1:
        return 1
    return getattr(model_cfg, "pipeline_circular_repeat", 1) or 1


def pipeline_summary(model_cfg) -> str | None:
    """One-line human summary incl. the schedule's bubble fraction, or None
    when the model isn't pipelined — the single place the formula lives."""
    stages = getattr(model_cfg, "pipeline_stages", 1)
    if stages <= 1:
        return None
    micro = effective_microbatches(model_cfg)
    v = circular_repeat(model_cfg)
    if getattr(model_cfg, "pipeline_impl", "spmd") == "mpmd":
        bubble = (stages - 1) / (micro + stages - 1)
        return (
            f"pipeline: {stages} stages x {micro} microbatches "
            f"[mpmd-1f1b], bubble fraction (S-1)/(M+S-1) = {bubble:.3f}, "
            f"steady-state live microbatch activations = "
            f"{min(stages, micro)} (vs {micro} under gpipe)"
        )
    bubble = (stages - 1) / (v * micro + stages - 1)
    sched = "gpipe" if v == 1 else f"circular(x{v})"
    if getattr(model_cfg, "pipeline_stage_remat", False):
        sched += "+stage-remat"
    return (
        f"pipeline: {stages} stages x {micro} microbatches [{sched}], "
        f"bubble fraction (S-1)/(vM+S-1) = {bubble:.3f}"
    )


def check_schedule(model_cfg, batch: int | None = None) -> None:
    """The JAX schedules' refusals, word for word: layers that do not
    divide over the stages (and repeats), a batch that does not divide
    into the microbatches, and a circular schedule with fewer
    microbatches than stages."""
    s, m = model_cfg.pipeline_stages, effective_microbatches(model_cfg)
    v, layers = circular_repeat(model_cfg), model_cfg.num_layers
    if v > 1:
        if layers % (s * v):
            raise ValueError(
                f"{layers} layers not divisible by "
                f"{s} stages x {v} circular repeats"
            )
    elif layers % s:
        raise ValueError(f"{layers} layers not divisible by {s} stages")
    if batch is not None and batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    if v > 1 and m < s:
        raise ValueError(
            f"circular schedule needs microbatches >= stages ({m} < {s}): "
            "a re-entering microbatch would collide with a fresh injection"
        )


def check_pipeline(model_cfg, mesh, parallel=None) -> None:
    """What the port does not run inside a pipeline, each naming ROADMAP
    A12: a ``pipe`` axis other than 1 or the stage count (each pipe rank
    runs one stage, or one process runs them all), and ``fsdp``,
    ``model``, ``seq`` or ``expert`` ranks, FSDP or ZeRO-1 state beside
    ``pipe`` ranks. ``model_cfg`` None: a step that is not pipelined."""
    sizes = {} if mesh is None else mesh.axis_sizes()
    pipe = sizes.get("pipe", 1)
    stages = getattr(model_cfg, "pipeline_stages", 1) or 1
    if pipe > 1 and pipe != stages:
        raise NotImplementedError(
            f"mesh.pipe={pipe} with model.pipeline_stages={stages}: the "
            "port runs one pipeline stage per pipe rank (mesh.pipe == "
            "pipeline_stages), or every stage in one process (mesh.pipe == "
            "1) (ROADMAP A12)")
    if stages <= 1:
        return
    for axis in ("fsdp", "model", "seq", "expert"):
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"mesh.{axis}={sizes[axis]} inside a pipeline "
                f"(pipeline_stages={stages}): pipeline x {axis} is not "
                "ported yet (ROADMAP A12)")
    if pipe > 1 and parallel is not None and (
            parallel.param_sharding == "fsdp"
            or parallel.opt_sharding == "zero1"):
        raise NotImplementedError(
            f"parallel.param_sharding={parallel.param_sharding!r} / "
            f"opt_sharding={parallel.opt_sharding!r} over pipe ranks: FSDP "
            "and ZeRO-1 state inside a pipeline are not ported yet "
            "(ROADMAP A12)")


def group_layers(model_cfg, repeat: int, stage: int) -> range:
    """The layers of virtual stage ``repeat * S + stage``."""
    s, v = model_cfg.pipeline_stages, circular_repeat(model_cfg)
    lg = model_cfg.num_layers // (s * v)
    g = repeat * s + stage
    return range(g * lg, (g + 1) * lg)


def stage_layers(model_cfg, stage: int) -> list[int]:
    """The global layer indices pipe rank ``stage`` holds: ``[j L/S,
    (j+1) L/S)`` under GPipe, its ``v`` non-adjacent groups under the
    circular schedule."""
    return [i for r in range(circular_repeat(model_cfg))
            for i in group_layers(model_cfg, r, stage)]


def layer_stage(model_cfg, layer: int) -> int:
    """The pipe rank that holds global layer ``layer``."""
    s, v = model_cfg.pipeline_stages, circular_repeat(model_cfg)
    return (layer // (model_cfg.num_layers // (s * v))) % s


class Timeline:
    """The JAX scan's schedule: ``ticks = v M + S - 1``; ``work(t, j)``
    is ``(microbatch, repeat)`` or None (a bubble)."""

    def __init__(self, stages: int, microbatches: int, repeat: int = 1):
        self.s, self.m, self.v = stages, microbatches, repeat
        self.ticks = repeat * microbatches + stages - 1
        # The parking FIFO's slots (circular): exit from stage S-1 at the
        # end of tick t, re-entry into stage 0 at tick t + M - S + 1.
        self.qlen = microbatches - stages + 1

    def work(self, t: int, j: int):
        offs = t - j
        if 0 <= offs < self.v * self.m:
            return offs % self.m, offs // self.m
        return None

    def final(self, j: int, r: int) -> bool:
        return j == self.s - 1 and r == self.v - 1

    def dest(self, j: int) -> int:
        """Where stage j's (non-final) output goes: the next stage, or
        from the last stage round the ring to stage 0."""
        return (j + 1) % self.s

    def src(self, j: int, r: int) -> int | None:
        """Where stage j's input at repeat r comes from (None: the
        embedding)."""
        if j > 0:
            return j - 1
        return self.s - 1 if r > 0 else None


class Mailbox:
    """The stage boundary's transport. A handoff to a stage this process
    runs waits in a FIFO of its (from, to) pair; one to another pipe rank
    is posted as a send (``exchange_start``, never waited for until
    ``flush``) and received into the same FIFO by ``fetch``. Each pair's
    handoffs are taken in the order they were made, on both sides, so a
    FIFO per pair is the whole bookkeeping. ``sent`` counts the bytes
    this process sent; ``peak[pair]`` the most handoffs a pair held."""

    def __init__(self, env=None):
        self.env = env
        self.box: dict = collections.defaultdict(collections.deque)
        self.pending: list = []
        self.sent = 0
        self.peak: dict = collections.defaultdict(int)

    def _note(self, pair) -> None:
        self.peak[pair] = max(self.peak[pair], len(self.box[pair]))

    def put(self, t: torch.Tensor, frm: int, to: int, *, remote: bool):
        if not remote:
            self.box[(frm, to)].append(t)
            self._note((frm, to))
            return
        t = t.detach()
        self.sent += t.numel() * t.element_size()
        self.pending.append(exchange_start([(t, to)], [], "pipe",
                                           env=self.env))

    def fetch(self, like: torch.Tensor, frm: int, to: int) -> None:
        """Receive the next handoff of (frm, to) from rank ``frm``."""
        got = exchange_start([], [(like, frm)], "pipe", env=self.env).wait()
        self.box[(frm, to)].append(got[0])
        self._note((frm, to))

    def take(self, frm: int, to: int, like: torch.Tensor | None = None):
        q = self.box[(frm, to)]
        if not q:
            if like is None:
                raise RuntimeError(f"pipeline handoff {frm} -> {to} missing")
            self.fetch(like, frm, to)
        return q.popleft()

    def flush(self) -> None:
        for p in self.pending:
            p.wait()
        self.pending.clear()


# ------------------------------------------------------------- stage math


def layer_params(params: dict, layers) -> dict[int, dict]:
    """``{layer: {name inside the block: tensor}}`` of ``params`` (the
    plain GPT names) for ``layers``."""
    want = {f"blocks.{i}.": i for i in layers}
    out: dict[int, dict] = {i: {} for i in layers}
    for k, v in params.items():
        if k.startswith("blocks."):
            pre = k[:k.index(".", 7) + 1]
            if pre in want:
                out[want[pre]][k[len(pre):]] = v
    return out


def run_layers(model, layers, x, seed, train: bool, lparams=None):
    """The blocks ``layers`` of ``model`` over ``x`` (with their
    parameters from ``lparams`` when given): ``(x, aux)``, aux the sum of
    the MoE blocks' auxiliary losses or None."""
    aux = None
    for i in layers:
        block = model.pipeline_block(i)
        if lparams is None:
            out = block(x, None, i, None, seed, train=train)
        else:
            out = functional_call(block, lparams[i], (x, None, i, None, seed),
                                  {"train": train})
        if isinstance(out, tuple):
            x, a = out
            aux = a if aux is None else aux + a
        else:
            x = out
    return x, aux


def embed(params: dict, tokens, cfg, policy, seed):
    """The embedding front: ``wte[tokens] + wpe[:t]`` in the compute
    dtype, then dropout at site ``(L, 0)``."""
    from frl_distributed_ml_scaffold_tpu_torch.models.dropout import dropout

    cd = policy.compute_dtype
    x = torch.nn.functional.embedding(tokens, params["wte.weight"]).to(cd)
    x = x + params["wpe"][:tokens.shape[1]].to(cd)
    return dropout(x, cfg.dropout, seed, cfg.num_layers, 0, seq_dim=1)


def final_norm(params: dict, x, cfg):
    """``ln_f`` in fp32."""
    return torch.nn.functional.layer_norm(
        x.float(), (cfg.hidden_dim,), params["ln_f.weight"].float(),
        params["ln_f.bias"].float(), cfg.layer_norm_epsilon)


def _remat_checkpoint(fn, mode: str):
    """``fn`` under ``trainer.remat`` (``full`` / ``dots``) or, with
    ``mode == "stage"``, checkpointed whole."""
    if mode == "none":
        return fn
    kw: dict = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, save_dots)
    elif mode not in ("full", "stage"):
        raise KeyError(f"unknown remat mode {mode!r}")

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


class StageRunner:
    """One stage's (or repeat's) compute on a microbatch, over the
    params dict it is handed: its layer group under the remat modes
    (``trainer.remat``, then ``pipeline_stage_remat`` inside), the
    parameters selected inside the checkpointed region. Returns ``(y,
    aux or None, the names of the parameters it read)``."""

    def __init__(self, model, remat: str = "none",
                 stage_remat: bool = False):
        self.model = model
        self.modes = [m for m in (remat, "stage" if stage_remat else "none")
                      if m != "none"]

    def __call__(self, layers, x, seed, train: bool, params: dict):
        layers = tuple(layers)
        pres = tuple(f"blocks.{i}." for i in layers)
        names = [k for k in params if k.startswith(pres)]
        model = self.model

        def fn(x, *tensors):
            lp = layer_params(dict(zip(names, tensors)), layers)
            y, aux = run_layers(model, layers, x, seed, train, lp)
            return (y,) if aux is None else (y, aux)

        if torch.is_grad_enabled():
            for mode in reversed(self.modes):
                fn = _remat_checkpoint(fn, mode)
        out = fn(x, *(params[k] for k in names))
        return out[0], (out[1] if len(out) > 1 else None), names


# ------------------------------------------------------------- the schedule


class SpmdSchedule:
    """The GPipe / circular timeline over the stages this process runs
    (every stage with ``pipe == 1``, its own with ``pipe == S``), for
    one chunk of M microbatches.

    ``forward(params, micro, seeds, train, head, keep)`` runs the ticks
    in order; ``head(m, y)`` receives each microbatch's final output on
    the last stage. With ``keep`` the forward keeps what the backward
    needs (each tick's boundary input as a leaf, its output), and
    ``backward(params, cotangents, acc)`` then runs the ticks in reverse,
    adding each stage's parameter gradients into ``acc`` (fp32)."""

    def __init__(self, model, *, remat: str = "none", env=None):
        cfg = model.config
        check_schedule(cfg)
        self.model, self.cfg, self.policy = model, cfg, model.policy
        self.tl = Timeline(cfg.pipeline_stages, effective_microbatches(cfg),
                           circular_repeat(cfg))
        n = 1 if env is None else env.axis_size("pipe")
        if n not in (1, cfg.pipeline_stages):
            raise NotImplementedError(
                f"mesh.pipe={n} with model.pipeline_stages="
                f"{cfg.pipeline_stages}: the port runs one stage per pipe "
                "rank, or every stage in one process (ROADMAP A12)")
        self.local = (list(range(self.tl.s)) if n == 1
                      else [env.axis_index("pipe")])
        self.remote = n > 1
        self.env = env
        self.stage = StageRunner(model, remat, cfg.pipeline_stage_remat)
        self.mail = Mailbox(env)
        self.bmail = Mailbox(env)
        self._saved: dict = {}

    @property
    def peak_parked(self) -> int:
        """The most microbatches stage 0's parking FIFO held."""
        return self.mail.peak[(self.tl.s - 1, 0)]

    def forward(self, params: dict, micro: list, seeds: list, train: bool,
                head, keep: bool = False):
        """``micro``: the M microbatches' input tokens ``[mb, t]``;
        ``seeds`` their dropout seeds (None: no dropout). Returns the
        valid ticks' aux sum (fp32 0-d) or None."""
        tl, cfg = self.tl, self.cfg
        rows, t_len = micro[0].shape
        like = torch.empty((rows, t_len, cfg.hidden_dim),
                           dtype=self.policy.compute_dtype,
                           device=micro[0].device)
        aux_sum = None
        self._saved = {}
        for t in range(tl.ticks):
            if self.remote:
                self._arrive(t, like)
            for j in self.local:
                w = tl.work(t, j)
                if w is None:
                    continue  # a bubble: no compute, no send
                m, r = w
                src = tl.src(j, r)
                leaf = None
                if src is None:
                    x = embed(params, micro[m], cfg, self.policy, seeds[m])
                else:
                    x = self.mail.take(src, j)
                    if keep:
                        x = leaf = x.detach().requires_grad_()
                y, aux, names = self.stage(group_layers(cfg, r, j), x,
                                           seeds[m], train, params)
                if aux is not None:
                    a = aux.detach().float()
                    aux_sum = a if aux_sum is None else aux_sum + a
                if keep:
                    self._saved[(t, j)] = (leaf, y, aux, names, src is None)
                if tl.final(j, r):
                    head(m, y)
                else:
                    self.mail.put(y.detach(), j, tl.dest(j),
                                  remote=self.remote)
        self.mail.flush()
        if tl.v > 1 and self.peak_parked > tl.qlen:
            raise RuntimeError(
                f"parking FIFO held {self.peak_parked} microbatches, "
                f"more than its {tl.qlen} slots")
        return aux_sum

    def _arrive(self, t: int, like: torch.Tensor) -> None:
        """Receive what reaches this rank's stage at tick t: its source
        stage's non-final output of tick t - 1 (which, from stage S-1 to
        stage 0, then waits in the parking FIFO)."""
        tl = self.tl
        for j in self.local:
            frm = (j - 1) % tl.s
            w = tl.work(t - 1, frm) if t > 0 else None
            if w is not None and not tl.final(frm, w[1]):
                self.mail.fetch(like, frm, j)

    def backward(self, params: dict, cotangents: dict, acc: dict,
                 aux_weight: float = 1.0) -> None:
        """The reverse timeline: each valid (tick, stage) differentiates
        its stage against the cotangent of its output (``cotangents[m]``
        for a final output, else the next stage's input cotangent) and
        hands its input's cotangent back. MoE aux terms take
        ``aux_weight``."""
        tl = self.tl
        for t in reversed(range(tl.ticks)):
            for j in reversed(self.local):
                w = tl.work(t, j)
                if w is None:
                    continue
                m, r = w
                leaf, y, aux, names, embedded = self._saved.pop((t, j))
                if tl.final(j, r):
                    g = cotangents.pop(m)
                else:
                    g = self.bmail.take(tl.dest(j), j,
                                        like=torch.empty_like(y))
                outs, gouts = [y], [g]
                if aux is not None and aux.requires_grad:
                    outs.append(aux)
                    gouts.append(torch.full_like(aux, aux_weight))
                keys = list(names) + (list(EMBED_KEYS) if embedded else [])
                inputs = [params[k] for k in keys]
                if leaf is not None:
                    inputs.append(leaf)
                got = torch.autograd.grad(outs, inputs, gouts,
                                          allow_unused=True)
                for k, gk in zip(keys, got):
                    if gk is not None:
                        acc[k].add_(gk.to(acc[k].dtype))
                if leaf is not None:
                    self.bmail.put(got[-1], j, tl.src(j, r),
                                   remote=self.remote)
                del y, aux, leaf, got, outs, gouts, inputs
        self.bmail.flush()


# The parameters the embedding front reads, and the head.
EMBED_KEYS = ("wte.weight", "wpe")
HEAD_KEYS = ("ln_f.weight", "ln_f.bias", "wte.weight")


class Microbatches:
    """A chunk of token rows split into the M microbatches of the
    schedule: inputs ``[:, :-1]`` for stage 0 and targets ``[:, 1:]``
    for the last stage (each pipe rank drew the same rows, so no token
    crosses ranks)."""

    def __init__(self, tokens: torch.Tensor, m: int):
        if tokens.shape[0] % m:
            raise ValueError(
                f"batch {tokens.shape[0]} not divisible by {m} microbatches")
        parts = tokens.chunk(m)
        self.inputs = [p[:, :-1] for p in parts]
        self.targets = [p[:, 1:] for p in parts]


def head_grads(params: dict, y, targets, cfg, head_loss, acc: dict,
               emb_key: str = "wte.weight", emb=None):
    """The last stage's loss on one emerging microbatch, differentiated
    at once (so its logits are freed): ``ln_f``, then ``head_loss(feats,
    emb, targets)`` over the tied table (``params[emb_key]``, or the
    mirror ``emb``). Adds the head's parameter gradients into ``acc`` and
    returns ``(loss, the cotangent of y, the mirror's gradient or
    None)``."""
    yl = y.detach().requires_grad_()
    e = params[emb_key] if emb is None else emb
    ce = head_loss(final_norm(params, yl, cfg), e, targets)
    keys = ["ln_f.weight", "ln_f.bias"] + ([emb_key] if emb is None else [])
    got = torch.autograd.grad(
        ce, [yl] + [params[k] for k in keys] + ([] if emb is None else [e]))
    for k, gk in zip(keys, got[1:]):
        acc[k].add_(gk.to(acc[k].dtype))
    return ce.detach().float(), got[0], (None if emb is None else got[-1])


def pipe_sum(x: torch.Tensor, env) -> torch.Tensor:
    """``x`` summed over ``pipe`` (itself with no pipe ranks)."""
    group = None if env is None else env.group("pipe")
    if group is None:
        return x
    x = x.clone()
    torch.distributed.all_reduce(x, group=group)
    return x


def finish_grads(acc: dict, policy, layout, scale: float) -> dict:
    """The accumulated gradients times ``scale``, summed over the batch
    axes (and ``pipe`` for the leaves every stage holds) into the
    optimizer state's spec, in the param dtype."""
    if layout is not None:
        scale /= layout.env.loss_axis_size
        acc = {k: layout.reduce(k, g, layout.accum[k], layout.opt[k],
                                layout.step_sum_axes(k))
               for k, g in acc.items()}
    return policy.cast_to_param({k: g.mul_(scale) for k, g in acc.items()})


def make_pipeline_grad_fn(model, policy, *, head_loss, grad_accum: int = 1,
                          remat: str = "none", seed: int = 0, layout=None,
                          device=None):
    """``grad_fn(params, extras, batch, step=0) -> (loss, metrics,
    extras, grads)`` for the SPMD pipeline (``make_grad_fn``'s contract),
    the last stage's loss ``head_loss(ln_f features, the tied table,
    targets)`` (the mean CE of one microbatch):
    ``grad_accum`` chunks of the batch, each the timeline over M
    microbatches; microbatch m of chunk a draws the dropout masks of
    seed ``mix_seed(seed, step, a M + m)``, those of the one-rank step at
    ``grad_accum = a M``. The gradients are averaged over the ``grad_accum
    M`` microbatches (the mean of the microbatch means: the JAX step's
    loss at equal microbatch sizes), summed over the batch axes and, for
    the leaves every stage holds (the embedding, ``ln_f``), over
    ``pipe``: the middle stages add zeros, stage 0 the embedding's and
    the last stage the head's gradient. ``loss`` and ``metrics`` are the
    global batch's (the last stage's CE and every stage's MoE aux, the
    aux sum over the valid ticks divided by M, summed over ``pipe``)."""
    from frl_distributed_ml_scaffold_tpu_torch import resolve_device
    from frl_distributed_ml_scaffold_tpu_torch.models.dropout import (
        check_seed,
        mix_seed,
    )

    cfg = model.config
    dev = resolve_device(device)
    env = None if layout is None else layout.env
    sched = SpmdSchedule(model, remat=remat, env=env)
    tl = sched.tl
    owns_head = tl.s - 1 in sched.local
    moe = cfg.moe.num_experts > 0

    def grad_fn(params: dict, extras: dict, batch: Any, step: int = 0):
        tokens = to_device(batch, dev)["tokens"]
        if tokens.shape[0] % grad_accum:
            raise ValueError(
                f"batch dim {tokens.shape[0]} of 'tokens' not divisible by "
                f"grad_accum={grad_accum}")
        acc = {k: torch.zeros(p.shape, dtype=policy.reduce_dtype,
                              device=p.device) for k, p in params.items()}
        sums = torch.zeros(3, dtype=torch.float32, device=dev)  # ce ppl aux
        for a, chunk in enumerate(tokens.chunk(grad_accum)):
            mbs = Microbatches(chunk, tl.m)
            seeds = [check_seed(cfg.dropout, True,
                                mix_seed(seed, step, a * tl.m + m))
                     for m in range(tl.m)]
            params_c = policy.cast_to_compute(
                {k: p.detach() for k, p in params.items()})
            for p in params_c.values():
                p.requires_grad_()
            cots: dict = {}
            ces = []

            def head(m, y):
                ce, cots[m], _ = head_grads(params_c, y, mbs.targets[m], cfg,
                                            head_loss, acc)
                ces.append(ce)

            aux = sched.forward(params_c, mbs.inputs, seeds, True, head,
                                keep=True)
            sched.backward(params_c, cots, acc)
            del params_c
            if owns_head:
                ce = torch.stack(ces).sum() / tl.m
                sums[0] += ce
                sums[1] += torch.exp(ce)
            if aux is not None:
                sums[2] += aux / tl.m
        ce, ppl, aux = pipe_sum(sums, env).unbind()
        names = ["ce_loss", "perplexity"] + (["aux_loss"] if moe else [])
        loss, *ms = batch_mean([ce + aux, ce, ppl] + ([aux] if moe else []),
                                layout, 1.0 / grad_accum)
        grads = finish_grads(acc, policy, layout, 1.0 / (grad_accum * tl.m))
        return loss, dict(zip(names, ms)), extras, grads

    grad_fn.schedule = sched
    return grad_fn


def make_pipeline_eval_fn(model, policy, *, head_loss, layout=None,
                          device=None):
    """The forward-only metrics step over the timeline (``make_eval_step``'s
    contract): the global batch's CE (the mean of the microbatch means of
    ``head_loss``), perplexity and, for MoE, aux."""
    from frl_distributed_ml_scaffold_tpu_torch import resolve_device
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import mesh_context

    cfg = model.config
    dev = resolve_device(device)
    env = None if layout is None else layout.env
    sched = SpmdSchedule(model, env=env)
    tl = sched.tl
    owns_head = tl.s - 1 in sched.local

    def eval_fn(state, batch) -> dict:
        tokens = to_device(batch, dev)["tokens"]
        mbs = Microbatches(tokens, tl.m)
        params_c = policy.cast_to_compute(dict(state.params))
        ces = []

        def head(m, y):
            ces.append(head_loss(final_norm(params_c, y, cfg),
                                 params_c["wte.weight"],
                                 mbs.targets[m]).float())

        with torch.no_grad(), mesh_context(env):
            aux = sched.forward(params_c, mbs.inputs, [None] * tl.m, False,
                                head)
        sums = torch.zeros(3, dtype=torch.float32, device=dev)
        if owns_head:
            sums[0] = torch.stack(ces).sum() / tl.m
            sums[1] = torch.exp(sums[0])
        if aux is not None:
            sums[2] = aux / tl.m
        ce, ppl, aux = pipe_sum(sums, env).unbind()
        moe = cfg.moe.num_experts > 0
        names = ["ce_loss", "perplexity"] + (["aux_loss"] if moe else [])
        loss, *ms = batch_mean([ce + aux, ce, ppl] + ([aux] if moe else []),
                                layout, 1.0)
        out = dict(zip(names, ms))
        out["loss"] = loss
        return out

    return eval_fn
