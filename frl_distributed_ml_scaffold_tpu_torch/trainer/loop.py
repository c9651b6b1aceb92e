"""Trainer: the port of the JAX package's ``trainer/loop.py``, one
process per rank of the run's mesh (one rank, one card, by default).

The mesh (``dist/mesh.py``) is built over the run's ranks from
``cfg.mesh``; the state's specs over it (``parallel/layout.py``) from
``cfg.parallel`` and the model's partition rules
(``model_partition_rules``). Every rank builds the same seeded init and
keeps its shards; the optimizer state is built from fp32 templates of
its per-rank shapes, as the JAX trainer builds it from its fp32 init
(a bf16 params file keeps fp32 moments). Each rank draws its rows of
the global batch (``data/pipeline.py``). Checkpoints hold the whole
state: rank 0 writes it, gathered, and a restore re-shards it.

Seeded init on the device, then the loop. Per step the loop builds (or
takes the prefetched) batch and launches the step; it reads the device
only at a log boundary (``StepTimer.tick_window``): the step's metrics
are 0-d tensors on the device, handed to ``on_step`` as they are.

A run writes ``<workdir>/<name>/`` (rank 0 only): ``config.json``,
``metrics.jsonl`` (one record per log boundary and per eval),
``telemetry.jsonl`` (the phase timeline and a metrics snapshot at each
boundary), ``metrics.prom`` (the Prometheus text of the same registry),
``trace_events.json`` (the host spans as a Chrome trace), ``ckpt/``
when checkpoints are on, ``trace/`` when a profiler window is set,
``stall_dump.txt`` when the watchdog fires and ``tb/`` with
``trainer.tensorboard``.

``trainer.offload_opt_state`` keeps the optimizer state in pinned host
memory, built there from the start (``make_train_step`` streams it
through the card a leaf at a time); off the card it raises, as the JAX
trainer refuses a backend without ``pinned_host`` memory.

The overlap schedule (``parallel/schedule.py``): the config's declared
schedule (``parallel.schedule``, or the ``fsdp_overlap`` /
``fsdp_prefetch`` / ``tp_overlap`` / ``low_precision`` knobs) is derived
and checked when the Trainer is built, a contradiction raising a
``ScheduleError``, and ``_attach_schedule`` hooks the model to it (the
blockwise FSDP gathers, the collective-matmul rings) and the layout
(``StateLayout.with_overlap``).

Sequence parallelism (``mesh.seq``, ``model.attention=ring|ulysses``)
and MoE over the ``expert`` axis run here: each rank draws its batch
index's rows whole (``seq_len + 1`` tokens), the loss splits them into
inputs and targets and keeps the rank's block of the tokens
(``trainer/tasks.py``), and the step averages over ``seq``
(``trainer/train_step.py``). MoE under ``mesh.model > 1`` is refused,
naming ROADMAP A12.

Pipelines (``model.pipeline_stages > 1``): ``model.pipeline_impl``
picks the backend (``spmd``: the GPipe / circular timeline of
``parallel/pipeline.py``; ``mpmd``: the 1F1B loop of
``parallel/mpmd_pipeline.py``; anything else raises the JAX
``KeyError``). With ``mesh.pipe == pipeline_stages`` each pipe rank
builds and holds its own stage (``models/gpt.py`` ``GptStage``; the
layout's ``owner``), draws the same rows as the other pipe ranks of its
batch index and exchanges the boundary activations point to point; with
``mesh.pipe == 1`` (SPMD only, as in the reference) one process runs
every stage. The seeded init draws the whole model and each rank keeps
its stage; ``trainer.init_params_path`` reads the SPMD backend's own
stacked tree and the plain tree under MPMD, as the JAX trainer does;
checkpoints hold the whole state under the plain names. Inside a
pipeline, ``fsdp``, ``model``, ``seq`` and ``expert`` ranks, FSDP and
ZeRO-1 state over pipe ranks and the overlap schedule under ``mpmd`` are
refused, naming ROADMAP A12.

``trainer.init_params_path`` starts the run from a flax msgpack params
file (``tools/import_hf_gpt2.py``'s output, or ``checkpoint/
flax_msgpack.py`` ``dump`` of ``models/convert.py``'s ``*_params_to_jax``
trees), read without ``msgpack`` or flax.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import threading
import time
from typing import Any, Callable

import torch

from frl_distributed_ml_scaffold_tpu_torch import faults, resolve_device
from frl_distributed_ml_scaffold_tpu_torch.checkpoint import flax_msgpack
from frl_distributed_ml_scaffold_tpu_torch.checkpoint.manager import Checkpointer
from frl_distributed_ml_scaffold_tpu_torch.config.core import config_to_dict
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ExperimentConfig
from frl_distributed_ml_scaffold_tpu_torch.data.pipeline import build_pipeline
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    build_mesh,
    local_batch_size,
)
from frl_distributed_ml_scaffold_tpu_torch.models import convert, create_model
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GptStage
from frl_distributed_ml_scaffold_tpu_torch.parallel.mpmd_pipeline import (
    MpmdPipelineRunner,
    check_mpmd,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.pipeline import (
    check_pipeline,
    check_schedule,
    make_pipeline_eval_fn,
    make_pipeline_grad_fn,
    pipeline_summary,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import StateLayout
from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
    PartitionRules,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.schedule import (
    hooked_model,
    schedule_from_config,
    validate_schedule_config,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.tp_overlap import (
    stream_param_names,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.telemetry import (
    MetricsRegistry,
    StallWatchdog,
    Timeline,
    Tracer,
    jsonl_record,
    write_prometheus_file,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
    make_optimizer,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import (
    lm_head_loss,
    make_loss_fn,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
    make_eval_step,
    make_train_step,
    offload_state,
)
from frl_distributed_ml_scaffold_tpu_torch.utils.flops import (
    gpt_train_flops,
    grad_flops,
    peak_flops_per_chip,
)
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import (
    JsonlWriter,
    MetricLogger,
    get_logger,
    is_primary_process,
    to_host,
)
from frl_distributed_ml_scaffold_tpu_torch.utils.profiling import (
    WindowProfiler,
    annotate,
    annotate_step,
    device_memory_stats,
)
from frl_distributed_ml_scaffold_tpu_torch.utils.timing import StepTimer
from frl_distributed_ml_scaffold_tpu_torch.utils.trees import tree_param_count


def _check_ported(cfg: ExperimentConfig) -> None:
    """Refuse what the loop does not port yet (module docstring); the
    mesh, optimizer-offload and pipeline refusals are the step's and the
    model's own, MoE under tensor parallelism ``model_partition_rules``'."""
    p = cfg.parallel
    if p.sequence not in ("none", "ring", "ulysses"):
        raise ValueError(f"unknown parallel.sequence {p.sequence!r} "
                         "(none | ring | ulysses)")
    if _pipelined(cfg.model):
        impl = cfg.model.pipeline_impl
        if impl not in ("spmd", "mpmd"):
            raise KeyError(
                f"unknown model.pipeline_impl={impl!r} (spmd | mpmd)")
        check_pipeline(cfg.model, cfg.mesh, cfg.parallel)


def _pipelined(model_cfg: Any) -> bool:
    return (getattr(model_cfg, "family", None) == "gpt"
            and model_cfg.pipeline_stages > 1)


def model_partition_rules(model_cfg: Any, env: MeshEnv
                          ) -> PartitionRules | None:
    """The model's partition rules when the ``model`` or ``expert`` axis
    is populated or the model is pipelined (the JAX trainer's
    ``model_partition_rules``): a spec's axes of size 1 split nothing,
    so ``expert = n`` alone splits the MoE experts. A family without rules
    on a ``model > 1`` mesh raises, as it would silently replicate; MoE
    under ``model > 1`` raises (ROADMAP A12)."""
    m = env.axis_size("model")
    if m <= 1 and env.axis_size("expert") <= 1 and not _pipelined(model_cfg):
        return None
    moe = getattr(model_cfg, "moe", None)
    if moe is not None and moe.num_experts > 0 and m > 1:
        raise NotImplementedError(
            f"model.moe.num_experts={moe.num_experts} with mesh.model={m}: "
            "MoE under tensor parallelism is not ported yet (ROADMAP A12)")
    family = getattr(model_cfg, "family", None)
    if family == "gpt":
        from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
            gpt_tp_rules,
        )

        # A pipelined GPT's rules also place each parameter on its pipe
        # rank (the JAX pipelined rules' leading ``pipe`` entry).
        rules = gpt_tp_rules(model_cfg if _pipelined(model_cfg) else None)
    elif family in ("vit", "video"):
        from frl_distributed_ml_scaffold_tpu_torch.models.vit import (
            vit_tp_rules,
        )

        rules = vit_tp_rules()
    elif m <= 1:
        return None
    else:
        # ResNet has no TP rules by design (conv channel counts don't
        # split Megatron-style); a model>1 mesh would silently replicate.
        raise ValueError(
            f"model family {family!r} has no tensor-parallel partition "
            "rules; mesh.model must be 1"
        )
    hidden = model_cfg.hidden_dim
    for what, n in (("num_heads", model_cfg.num_heads),
                    ("the MLP width", hidden * model_cfg.mlp_ratio)):
        if n % m:
            raise ValueError(f"{what} {n} not divisible by mesh.model={m}: "
                             "each rank holds whole heads and an even MLP "
                             "slice")
    return rules


def _model_kwargs(cfg: ExperimentConfig) -> dict:
    """The model's input width, from the data section."""
    d = cfg.data
    family = cfg.model.family
    if family == "mlp":
        return {"in_features": d.image_size * d.image_size * d.channels}
    if family in ("resnet", "vit", "video"):
        return {"in_channels": d.channels}
    return {}


def _leaves_with_path(tree, path: str = ""):
    """``(key path, leaf)`` of a nested dict in JAX's flattening order
    (keys sorted at each level), the path as ``jax.tree_util.keystr``
    writes it: ``['blocks']['attn']['query']['kernel']``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _cast_tree(tree, dtype: torch.dtype):
    """Every leaf of a nested dict cast to ``dtype`` (a leaf already of
    it is kept as it is, not copied)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


class Trainer:
    """End-to-end training loop for one ``ExperimentConfig`` on
    ``device`` (``None`` means ``cuda`` and raises without a card), as
    this rank of the mesh of ``cfg.mesh`` over the run's ranks
    (``dist/mesh.py`` ``build_mesh``)."""

    def __init__(self, cfg: ExperimentConfig, *, device=None):
        self.cfg = cfg
        self.logger = get_logger()
        # Labels or tokens past the model's output range make the loss
        # meaningless while the run looks alive: refuse up front (the JAX
        # trainer's check and message).
        for attr in ("num_classes", "vocab_size"):
            d_v = getattr(cfg.data, attr, None)
            m_v = getattr(cfg.model, attr, None)
            if d_v is not None and m_v is not None and d_v != m_v:
                raise ValueError(
                    f"config {cfg.name}: data.{attr}={d_v} != "
                    f"model.{attr}={m_v}; labels out of the model's range "
                    "silently NaN the loss — override both together"
                )
        _check_ported(cfg)
        self.overlap_schedule = schedule_from_config(cfg)
        if self.overlap_schedule is not None:
            validate_schedule_config(self.overlap_schedule, cfg)
        self.device = resolve_device(device)
        self.env = build_mesh(cfg.mesh)
        self.policy = get_policy(cfg.precision)
        self._model_kw = _model_kwargs(cfg)
        self.pipelined = _pipelined(cfg.model)
        self.mpmd = self.pipelined and cfg.model.pipeline_impl == "mpmd"
        if self.mpmd:
            check_mpmd(cfg, self.env)
        elif self.pipelined:
            check_schedule(cfg.model, local_batch_size(
                cfg.data.global_batch_size, self.env)
                // cfg.trainer.grad_accum)
        self.model = self._create_model()
        self.tx, self.schedule = make_optimizer(cfg.optimizer, cfg.trainer,
                                                cfg.model)
        self.loss_fn = make_loss_fn(self.model, cfg.data.name)
        self._mpmd = None
        self.layout = self._build_layout()
        if self.overlap_schedule is not None:
            self._attach_schedule()
        self._compile_steps()
        self.state_shapes = self._state_template()
        self.pipeline = build_pipeline(cfg.data, split="train",
                                       device=self.device, env=self.env)
        self._eval_pipeline = None
        self.checkpointer = None  # attached by attach_checkpointer()
        if cfg.checkpoint.enabled:
            self.attach_checkpointer(Checkpointer(
                os.path.join(cfg.workdir, cfg.name, "ckpt"), cfg.checkpoint))

    # ---------------------------------------------------------------- setup

    def _create_model(self):
        """The model this rank runs: the whole model, or under ``pipe``
        ranks its own stage (``GptStage``; under MPMD the embedding on
        stage 0 only and ``ln_f`` on the last stage only)."""
        cfg = self.cfg
        if self.pipelined and self.env.axis_size("pipe") > 1:
            j, s = self.env.axis_index("pipe"), cfg.model.pipeline_stages
            return GptStage(cfg.model, self.policy, j,
                            embed=not self.mpmd or j == 0,
                            final=not self.mpmd or j == s - 1,
                            device=self.device)
        return create_model(cfg.model, self.policy, device=self.device,
                            **self._model_kw)

    def _build_layout(self) -> StateLayout:
        """The state's specs over the mesh (``parallel/layout.py``), of
        the whole model's parameters (a pipe rank keeps its stage's)."""
        cfg = self.cfg
        model = (create_model(cfg.model, self.policy, device="meta",
                              **self._model_kw) if self.pipelined
                 else self.model)
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        whole = ()
        if cfg.model.family == "gpt":
            from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
                TP_COMPUTE_WHOLE,
            )

            whole = TP_COMPUTE_WHOLE
        return StateLayout.build(
            self.env, cfg.model, cfg.parallel, shapes,
            rules=model_partition_rules(cfg.model, self.env),
            compute_whole=whole)

    def _attach_schedule(self) -> None:
        """Hook the model to the declared overlap schedule
        (``parallel/schedule.py`` ``hooked_model``: the blockwise FSDP
        gathers and / or the collective-matmul rings, both when both
        axes are declared) and the layout to it: the gathered blocks'
        shards stay split for the forward, and the parameters used on
        the ``model``-sharded stream are summed over ``model``."""
        model, sched = self.model, self.overlap_schedule
        hooked_model(sched, model, self.cfg, self.env, self.layout)
        gathered = (model.param_hooks.gathered_names()
                    if sched.block_gather() is not None else ())
        stream = (stream_param_names(self.layout.shapes)
                  if sched.ring_gather() is not None else ())
        self.layout = self.layout.with_overlap(gathered, stream)

    def _compile_steps(self) -> None:
        cfg, t = self.cfg, self.cfg.trainer
        grad_fn = None  # a pipeline's own forward and backward
        if self.mpmd:  # the head dense per microbatch, as the reference's
            self._mpmd = grad_fn = MpmdPipelineRunner(
                cfg, self.env, self.policy, self.model, self.layout,
                self.device, lm_head_loss(self.policy, 0))
            self.eval_step = grad_fn.eval_fn
        elif self.pipelined:
            head_loss = lm_head_loss(self.policy, cfg.model.lm_loss_chunk)
            grad_fn = make_pipeline_grad_fn(
                self.model, self.policy, head_loss=head_loss,
                grad_accum=t.grad_accum, remat=t.remat, seed=t.seed,
                layout=self.layout, device=self.device)
            self.eval_step = make_pipeline_eval_fn(
                self.model, self.policy, head_loss=head_loss,
                layout=self.layout, device=self.device)
        else:
            self.eval_step = make_eval_step(self.loss_fn, self.policy,
                                            seed=t.seed, layout=self.layout,
                                            device=self.device)
        self.grad_fn = grad_fn
        self.train_step = make_train_step(
            self.loss_fn, self.tx, self.policy, seed=t.seed,
            grad_accum=t.grad_accum, remat=t.remat, ema_decay=t.ema_decay,
            offload_opt_state=t.offload_opt_state, mesh=cfg.mesh,
            parallel=cfg.parallel, layout=self.layout, device=self.device,
            grad_fn=grad_fn, model_cfg=cfg.model)

    def _state_template(self) -> TrainState:
        """The whole state's tree on the meta device: names, shapes,
        dtypes (what a checkpoint is checked against; nothing is
        allocated). The params are fp32 from the seeded init and in the
        policy's param dtype from a file; the optimizer state is fp32
        either way."""
        meta = create_model(self.cfg.model, self.policy, device="meta",
                            **self._model_kw)
        dtype = (self.policy.param_dtype if self.cfg.trainer.init_params_path
                 else torch.float32)
        params = {k: p.detach().to(dtype) for k, p in meta.named_parameters()}
        extras = ({"batch_stats": dict(meta.named_buffers())}
                  if self.cfg.model.family == "resnet" else {})
        return TrainState(
            step=0, params=params,
            opt_state=self.tx.init({k: p.float() for k, p in params.items()}),
            extras=extras,
            ema_params=(dict(params) if self.cfg.trainer.ema_decay > 0.0
                        else None))

    def init_state(self) -> TrainState:
        """A fresh state from the family's seeded init
        (``models/convert.py``), seeded by ``trainer.seed`` on the
        trainer's device. The params are fp32 under every policy, as the
        JAX trainer's init makes them (flax's default param dtype). With
        ``trainer.init_params_path`` the params (and the EMA) come from
        that file instead, in the policy's param dtype
        (``_load_init_params``); the ResNet's BatchNorm statistics stay
        the seeded init's, as the JAX trainer loads params only."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.trainer.seed)
        family = cfg.model.family
        if family == "gpt":
            params, extras = convert.init_params(cfg.model, gen), {}
        elif family == "resnet":
            params, extras = convert.init_resnet_params(cfg.model, gen,
                                                        **self._model_kw)
        else:
            init = getattr(convert, f"init_{family}_params")
            params, extras = init(cfg.model, gen, **self._model_kw), {}
        if cfg.trainer.init_params_path:
            del params  # the seeded params are not kept beside the file's
            params = self._load_init_params(cfg.trainer.init_params_path)
        lay = self.layout
        params = {k: lay.shard(k, p, lay.param[k]) for k, p in params.items()
                  if k in lay.shapes}
        offload = cfg.trainer.offload_opt_state
        state = TrainState.create(
            params, self.tx, extras, with_ema=cfg.trainer.ema_decay > 0.0,
            opt_template=lay.opt_template(
                torch.float32, "cpu" if offload else self.device),
            device=self.device)
        if offload:
            offload_state(state.opt_state)
        self.logger.info("initialized %s: %.2fM params over mesh %s on %s",
                         cfg.name, self._param_count() / 1e6,
                         self.env.shape, self.device)
        summary = pipeline_summary(cfg.model)
        if summary:
            # The fill/drain cost: the number to watch when tuning
            # pipeline_microbatches.
            self.logger.info("%s", summary)
        return state

    def _jax_tree(self, params: dict, extras: dict) -> dict:
        """The port's params as the JAX package's params tree
        (``models/convert.py``'s inverse converters)."""
        m = self.cfg.model
        if m.family == "gpt":
            if self.mpmd:
                # The MPMD backend reads the plain (stages=1) tree.
                m = dataclasses.replace(m, pipeline_stages=1)
            return convert.params_to_jax(params, m)
        if m.family == "resnet":
            return convert.resnet_params_to_jax(params, extras, m)[0]
        if m.family == "mlp":
            return convert.mlp_params_to_jax(params)
        return convert.vit_params_to_jax(params, m)

    def _load_init_params(self, path: str) -> dict:
        """A flax msgpack params file (``checkpoint/flax_msgpack.py``) as
        the port's params, cast to the policy's param dtype, on the CPU.

        Its tree and shapes are checked against the model's own (the JAX
        tree of the state template, built on the meta device) before
        anything is converted or moved, with the JAX trainer's messages
        and key paths, so a mismatched file fails naming its leaves."""
        loaded = flax_msgpack.load(path)
        shapes = self.state_shapes
        want_tree = self._jax_tree(shapes.params, shapes.extras)
        got_paths = {k: tuple(v.shape) for k, v in _leaves_with_path(loaded)}
        want_paths = {k: tuple(v.shape)
                      for k, v in _leaves_with_path(want_tree)}
        if got_paths.keys() != want_paths.keys():
            missing = sorted(want_paths.keys() - got_paths.keys())[:5]
            extra = sorted(got_paths.keys() - want_paths.keys())[:5]
            raise ValueError(
                f"init_params_path {path!r} does not match the model tree "
                f"(missing {missing}, unexpected {extra})"
            )
        bad = [k for k in want_paths if got_paths[k] != want_paths[k]]
        if bad:
            raise ValueError(
                f"init_params_path {path!r} shape mismatches at {bad[:5]}: "
                + ", ".join(f"{k}: {got_paths[k]} != {want_paths[k]}"
                            for k in bad[:5])
            )
        dtype = self.policy.param_dtype
        loaded = _cast_tree(loaded, dtype)
        m = self.cfg.model
        if m.family == "gpt":
            params = convert.params_from_jax(loaded, m)
        elif m.family == "resnet":
            # The conversion walks the statistics beside the params: the
            # template's stand in (the file holds params only).
            stats = convert.resnet_params_to_jax(
                shapes.params, shapes.extras, m)[1]
            params = convert.resnet_params_from_jax(loaded, stats)[0]
        elif m.family == "mlp":
            params = convert.mlp_params_from_jax(loaded)
        else:
            params = convert.vit_params_from_jax(loaded)
        self.logger.info("initialized params from %s (%.2fM params)", path,
                         tree_param_count(params) / 1e6)
        return params

    def _param_count(self) -> int:
        shapes = self.layout.whole_shapes or self.layout.shapes
        return sum(math.prod(s) for s in shapes.values())

    def step_cost_analysis(self, state: TrainState, batch) -> dict | None:
        """Model FLOPs of ONE train step (``utils/flops.py``), with the
        count used as ``flops_source``: ``analytic`` for the GPT (the
        flash kernels are invisible to ``FlopCounterMode``),
        ``flop_counter`` for the other families (one forward and backward
        on ``batch`` on the state's device, no recompute)."""
        if self.cfg.model.family == "gpt":
            flops = gpt_train_flops(self.cfg, self._param_count())["flops"]
            return {"flops": float(flops) / self.env.num_devices,
                    "flops_source": "analytic"}
        try:
            params = self.layout.whole_params(state.params)
            dev = next(iter(params.values())).device
            flops = grad_flops(self.loss_fn, self.policy, params,
                               state.extras, batch, dev)
            return {"flops": float(flops), "flops_source": "flop_counter"}
        except Exception as e:
            self.logger.warning(
                "step_cost_analysis: FlopCounterMode failed (%s: %s); "
                "records will carry no mfu", type(e).__name__, e)
            return None

    # ----------------------------------------------------------------- loop

    def attach_checkpointer(self, checkpointer) -> None:
        """Checkpoints of this trainer's state: whole, gathered from the
        ranks' shards on save and re-sharded on restore."""
        checkpointer.layout = self.layout
        self.checkpointer = checkpointer

    def fit(self, state: TrainState | None = None, *,
            num_steps: int | None = None,
            on_step: Callable[[int, dict], None] | None = None
            ) -> tuple[TrainState, dict]:
        """Run the training loop; returns (final_state, last_metrics)."""
        cfg = self.cfg
        total = num_steps if num_steps is not None else cfg.trainer.total_steps

        if state is None:
            if self.checkpointer is not None and cfg.checkpoint.resume:
                state = self.checkpointer.restore_or_init(self)
            else:
                state = self.init_state()
        # The state's own step is the resume point: it keeps the
        # step-indexed data stream aligned with what the model has seen.
        start_step = int(state.step)

        run_dir = os.path.join(cfg.workdir, cfg.name)
        if is_primary_process():
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "config.json"), "w") as fh:
                json.dump(config_to_dict(cfg), fh, indent=1)

        metric_logger = MetricLogger(
            os.path.join(run_dir, "metrics.jsonl"),
            tb_dir=(os.path.join(run_dir, "tb") if cfg.trainer.tensorboard
                    else None))
        timer = StepTimer(warmup=1)  # the first window holds the set-up
        samples_per_step = cfg.data.global_batch_size
        last_record: dict = {}
        last_logged = start_step

        # One registry per fit(): exported at every log boundary as a
        # JSONL snapshot (telemetry.jsonl) and a Prometheus file
        # (metrics.prom); the timeline drains into the same JSONL.
        telem = MetricsRegistry()
        timeline = Timeline()
        # Spans (step -> load_batch / dispatch, checkpoint, eval) on one
        # "train" lane, each also a record_function annotation so a
        # profiler window lines up with them; exported as
        # trace_events.json and teed into the timeline.
        tracer = Tracer(enabled=cfg.trainer.tracing, annotate=True,
                        timeline=timeline)
        train_trace = tracer.new_trace(cfg.name)
        if tracer.enabled:
            def _span_load(step):
                return tracer.span("load_batch", cat="train", step=step)

            def _span_disp(step):
                return tracer.span("dispatch", cat="train", step=step,
                                   step_num=step)
        else:
            # tracing=false keeps the profiler annotations: the two knobs
            # are independent.
            _span_load = lambda step: annotate("load_batch")  # noqa: E731
            _span_disp = annotate_step
        telemetry_jsonl = JsonlWriter(os.path.join(run_dir,
                                                   "telemetry.jsonl"))
        prom_path = os.path.join(run_dir, "metrics.prom")
        m_step = telem.histogram(
            "train_step_seconds",
            help="per-step e2e wall time (window average, post-warmup)")
        m_wait = telem.histogram("train_data_wait_seconds",
                                 help="host wait for the next batch, per step")
        m_sps = telem.gauge("train_samples_per_sec_per_chip",
                            help="the north-star metric")
        m_mfu = telem.gauge("train_mfu", help="model FLOPs / chip peak")
        m_wait_frac = telem.gauge(
            "train_data_wait_fraction",
            help="data-wait share of the step (input-bound when near 1)")
        m_hbm_used = telem.gauge("train_hbm_in_use_gib")
        m_hbm_peak = telem.gauge("train_hbm_peak_gib",
                                 help="HBM high-watermark per log window")
        m_steps = telem.counter("train_steps_total")
        watchdog = StallWatchdog(
            cfg.trainer.stall_timeout_s, name=cfg.name, registry=telem,
            timeline=timeline,
            dump_path=os.path.join(run_dir, "stall_dump.txt"),
            # Beats flow once steps do: the first deadline absorbs the
            # first step's set-up.
            first_beat_scale=cfg.trainer.stall_timeout_first_beat_scale)
        if self._mpmd is not None:
            # The 1F1B loop's stage spans, idle gauges, transfer
            # counter and watchdog beats, into this fit's telemetry.
            self._mpmd.attach_telemetry(registry=telem, tracer=tracer,
                                        trace=train_trace, watchdog=watchdog)
        peak = peak_flops_per_chip(self.device)
        flops_per_step: dict | None | bool = None  # False once probing failed
        window_wait = 0.0

        profiler = WindowProfiler(
            os.path.join(run_dir, "trace"),
            start_step=start_step + cfg.trainer.profile_start_step,
            num_steps=cfg.trainer.profile_steps)

        # Graceful preemption: SIGTERM finishes the step in flight,
        # checkpoints and exits cleanly. Handlers are process-wide state:
        # install them only from the main thread, and always restore them
        # (the loop may be driven from tests or a supervisor).
        preempt: dict[str, Any] = {"signum": None}
        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            def _graceful(signum, frame, _p=preempt):
                _p["signum"] = signum

            prev_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                          _graceful)

        try:
            for step in range(start_step, total):
                profiler.step_start(step)
                with tracer.span("step", trace=train_trace, cat="train",
                                 step=step):
                    t_load = time.perf_counter()
                    with _span_load(step):
                        batch = self.pipeline.global_batch(step)
                    data_wait = time.perf_counter() - t_load
                    window_wait += data_wait
                    m_wait.observe(data_wait)
                    t_disp = time.perf_counter()
                    with _span_disp(step):
                        state, metrics = self.train_step(state, batch)
                # Fault sites: a hung step is the watchdog's prey; a
                # preempt sends our own SIGTERM down the graceful path.
                faults.maybe_hang("trainer.hung_step", key=step)
                if faults.fire("trainer.preempt", key=step) is not None:
                    os.kill(os.getpid(), signal.SIGTERM)
                if not tracer.enabled:
                    # tracing=false keeps telemetry.jsonl's phase records.
                    timeline.event("load_batch", dur_s=data_wait, step=step)
                    timeline.event("dispatch",
                                   dur_s=time.perf_counter() - t_disp,
                                   step=step)
                watchdog.beat()
                if (step + 1) % cfg.trainer.log_every == 0 or step + 1 == total:
                    win_steps = step + 1 - last_logged
                    dt = timer.tick_window(metrics["loss"], win_steps)
                    last_logged = step + 1
                    perf = timer.summary(samples_per_step,
                                         self.env.num_devices)
                    # The host waits data_wait for the batch; the rest of
                    # the step is the device's (window-averaged: the loop
                    # only reads the device here).
                    avg_wait = window_wait / max(win_steps, 1)
                    window_wait = 0.0
                    mem = device_memory_stats(self.device)
                    extra = {
                        "lr": float(self.schedule(step)),
                        **{k: round(v, 6) for k, v in perf.items()
                           if k in ("step_time_median_s", "step_time_p50_s",
                                    "step_time_p95_s", "step_time_p99_s",
                                    "samples_per_sec_per_chip")},
                        "data_wait_s": round(avg_wait, 6),
                        **mem,
                    }
                    if dt is not None:
                        m_step.observe(dt)
                        extra["compute_s"] = round(max(dt - avg_wait, 0.0), 6)
                        m_wait_frac.set(min(avg_wait / max(dt, 1e-12), 1.0))
                        # MFU: probe the step's FLOPs once, after the
                        # warm-up window, and only on a card with a known
                        # peak.
                        if flops_per_step is None and peak:
                            flops_per_step = (self.step_cost_analysis(
                                state, batch) or False)
                    med = perf.get("step_time_median_s", 0.0)
                    if flops_per_step and med > 0:
                        mfu = flops_per_step["flops"] / (med * peak)
                        extra["mfu"] = mfu
                        extra["flops_source"] = flops_per_step["flops_source"]
                        m_mfu.set(mfu)
                    m_sps.set(perf.get("samples_per_sec_per_chip", 0.0))
                    m_hbm_used.set(mem.get("hbm_in_use_gib", 0.0))
                    m_hbm_peak.set(mem.get("hbm_peak_gib", 0.0))
                    m_steps.inc(win_steps)
                    last_record = metric_logger.log(step + 1, metrics, extra)
                    for rec in timeline.drain():
                        telemetry_jsonl.write(rec)
                    telemetry_jsonl.write(jsonl_record(telem, step=step + 1))
                    if is_primary_process():
                        write_prometheus_file(telem, prom_path)
                if on_step is not None:
                    on_step(step, metrics)
                if (self.checkpointer is not None
                        and (step + 1) % cfg.checkpoint.save_every == 0):
                    with tracer.span("checkpoint", trace=train_trace,
                                     cat="train", step=step + 1):
                        self.checkpointer.save(step + 1, state)
                if (cfg.trainer.eval_every
                        and (step + 1) % cfg.trainer.eval_every == 0):
                    with tracer.span("eval", trace=train_trace, cat="train",
                                     step=step + 1):
                        eval_metrics = self.evaluate(state)
                    metric_logger.log(step + 1, eval_metrics,
                                      {"split": "eval"})
                if preempt["signum"] is not None:
                    self.logger.warning(
                        "signal %d: checkpointing at step %d and exiting "
                        "cleanly (preemption)", preempt["signum"], step + 1)
                    if self.checkpointer is not None:
                        # The periodic save may have just covered this
                        # step; preempt_save=false skips the forced save
                        # but still waits for saves in flight to commit.
                        if (cfg.trainer.preempt_save
                                and (step + 1) % cfg.checkpoint.save_every):
                            self.checkpointer.save(step + 1, state,
                                                   force=True)
                        self.checkpointer.wait()
                    last_record = metric_logger.log(step + 1, metrics,
                                                    {"event": "preempted"})
                    preempt["exited_early"] = True
                    break
            # The final save runs inside the signal-guarded region: a
            # SIGTERM here only sets the flag while the save completes.
            if (not preempt.get("exited_early")
                    and self.checkpointer is not None):
                if total % cfg.checkpoint.save_every != 0:
                    with tracer.span("checkpoint", trace=train_trace,
                                     cat="train", step=total, final=True):
                        self.checkpointer.save(total, state, force=True)
                self.checkpointer.wait()
        finally:
            # A crash still flushes the trace and the telemetry: the crash
            # run is when they are wanted.
            profiler.stop()
            watchdog.stop()
            try:
                for rec in timeline.drain():
                    telemetry_jsonl.write(rec)
                telemetry_jsonl.write(jsonl_record(telem, step=last_logged))
                if is_primary_process():
                    write_prometheus_file(telem, prom_path)
                    if tracer.enabled:
                        tracer.write_chrome_trace(
                            os.path.join(run_dir, "trace_events.json"))
            except Exception as e:  # must not mask the real error
                self.logger.warning(
                    "final telemetry flush failed (%s: %s); continuing "
                    "shutdown", type(e).__name__, e)
            telemetry_jsonl.close()
            if hasattr(self.pipeline, "close"):
                self.pipeline.close()  # stop the prefetch worker
            for sig, prev in prev_handlers.items():
                signal.signal(sig, prev)
        metric_logger.close()
        return state, last_record

    def evaluate(self, state: TrainState, num_steps: int | None = None
                 ) -> dict:
        """Mean eval metrics over ``num_steps`` (default
        ``trainer.eval_steps``) eval batches, on the EMA params when the
        state keeps them; one transfer to the host at the end."""
        if self._eval_pipeline is None:
            self._eval_pipeline = build_pipeline(self.cfg.data, split="eval",
                                                 device=self.device,
                                                 env=self.env)
        if state.ema_params is not None:
            state = dataclasses.replace(state, params=state.ema_params)
        n = num_steps or self.cfg.trainer.eval_steps
        acc: dict[str, torch.Tensor] = {}
        for step in range(n):
            m = self.eval_step(state, self._eval_pipeline.global_batch(step))
            acc = m if not acc else {k: acc[k] + m[k] for k in acc}
        mean = to_host({k: v / n for k, v in acc.items()})
        return {f"eval_{k}": v for k, v in mean.items()}
