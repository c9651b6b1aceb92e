"""Pipeline parallelism, the MPMD backend: the port of the JAX package's
``parallel/mpmd_pipeline.py`` (per-stage programs and the 1F1B loop).

Each ``pipe`` rank runs one stage (``models/gpt.py`` ``GptStage``) and
holds that stage's parameters and optimizer state only: its contiguous
layers, the embedding on stage 0 and ``ln_f`` on the last stage. The
loop is the JAX host loop's order, run by every rank on its own
stage: stage j issues ``min(S-1-j, M)`` warm-up forwards, then
alternates one forward and one backward, then drains the backwards; the
last stage runs a fused forward and backward (``X``) per microbatch.
A forward keeps only its boundary input (stage 0: the microbatch's
tokens), and the backward recomputes the stage from it (under
``trainer.remat``, whose checkpoint then covers the recompute's own
residuals), so stage j holds at most ``min(S - j, M)`` microbatch
activations (``stage_peak_live``; GPipe holds ``M``). Activations and
cotangents cross the boundary point to point (``dist/collectives.py``
``exchange_start``: each send is posted and the loop goes on, each
receive waits), each pair of neighbouring stages in microbatch order.

The tied embedding: stage 0 owns ``wte``; each step it sends the
compute-dtype table to the last stage, whose head reads it, and the
head's gradient comes back to stage 0 at the end of the step (JAX
``:869-872``, ``:996-998``). ``grad_accum`` folds into the same run as
more microbatches (``total_micro = M x grad_accum``), the gradients
averaged over all of them. The global norm sums every stage's squares
over ``pipe`` and one clip factor serves every stage (``trainer/
train_step.py``, the JAX ``:1005-1016`` pre-scale), the optimizer's clip
reading that norm.

Counters of the last step: ``last_peak_live`` (per stage, gathered over
``pipe``), ``last_boundary_bytes`` (this rank's sends) and
``last_stage_idle_s``; with ``attach_telemetry`` the JAX gauges and
counter (``pipeline_stage{j}_idle_s``, ``pipeline_bubble_fraction``,
``pipeline_boundary_transfer_bytes_total``), the spans ``stage{j}_fwd``,
``stage{j}_fwd_bwd``, ``stage{j}_bwd`` and ``stage{j}_update``, and
watchdog beats from inside the schedule loop.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import torch

from frl_distributed_ml_scaffold_tpu_torch.parallel.pipeline import (
    EMBED_KEYS,
    Mailbox,
    Microbatches,
    StageRunner,
    circular_repeat,
    effective_microbatches,
    embed,
    final_norm,
    finish_grads,
    head_grads,
    pipe_sum,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.step_utils import (
    batch_mean,
    to_device,
)

#: Schedules the analytic model knows. "gpipe" is the SPMD backend's
#: all-forwards-then-all-backwards timeline; "1f1b" is this module's.
SCHEDULES = ("gpipe", "1f1b")


def bubble_fraction(schedule: str, num_stages: int,
                    num_microbatches: int) -> float:
    """Idle fraction of the pipeline timeline: ``(S-1)/(M+S-1)``.

    Fill/drain costs ``S-1`` microbatch-slots at both ends of the
    timeline whichever way the middle is ordered, so GPipe and 1F1B share
    the bubble FRACTION (at equal per-microbatch fwd+bwd cost); 1F1B's
    win is peak activation MEMORY (``peak_live_activations`` — S vs M),
    which is what unlocks large ``M`` and therefore small bubbles.
    """
    if schedule not in SCHEDULES:
        raise KeyError(
            f"unknown pipeline schedule {schedule!r} ({SCHEDULES})")
    s, m = int(num_stages), int(num_microbatches)
    if s <= 1 or m < 1:
        return 0.0
    return (s - 1) / (m + s - 1)


def peak_live_activations(
    schedule: str, num_stages: int, num_microbatches: int
) -> int:
    """Max in-flight forward boundary activations any stage holds.

    - ``gpipe``: every microbatch's activations stay live until the
      backward sweep starts → ``M``.
    - ``1f1b``: stage ``j`` warms up ``min(S-1-j, M)`` forwards and then
      retires one activation per new forward → ``min(S-j, M)``; the max
      (stage 0) is ``min(S, M)`` — ``< M`` whenever ``M > S``.
    """
    if schedule not in SCHEDULES:
        raise KeyError(
            f"unknown pipeline schedule {schedule!r} ({SCHEDULES})")
    s, m = int(num_stages), int(num_microbatches)
    if s <= 1:
        return 1
    if schedule == "gpipe":
        return max(m, 1)
    return max(min(s, m), 1)


def stage_peak_live(stage: int, num_stages: int,
                    num_microbatches: int) -> int:
    """1F1B per-stage peak in-flight activations: ``min(S - j, M)``."""
    return max(min(num_stages - stage, num_microbatches), 1)


def stage_ops(stage: int, num_stages: int, microbatches: int) -> list[str]:
    """Stage ``stage``'s 1F1B op string: warmup forwards, steady 1F1B
    pairs, cooldown backwards. The last stage runs fused
    forward+backward microsteps ('X')."""
    m = microbatches
    if stage == num_stages - 1:
        return ["X"] * m
    w = min(num_stages - 1 - stage, m)
    return ["F"] * w + ["F", "B"] * (m - w) + ["B"] * w


def check_order(num_stages: int, microbatches: int, ops=None) -> None:
    """Run the stages' op strings through the JAX host loop's readiness
    loop, with no compute: a forward needs its input from the previous
    stage, a backward its cotangent from the next; a schedule whose
    bookkeeping leaves no op ready raises the JAX error. Every rank runs
    this before its step (``ops``: the op strings, default
    ``stage_ops``)."""
    s, m = num_stages, microbatches
    ops = ops or [stage_ops(j, s, m) for j in range(s)]
    pc, f_cnt, b_cnt = [0] * s, [0] * s, [0] * s
    acts = [set() for _ in range(s)]
    grads = [set() for _ in range(s)]
    while any(pc[j] < len(ops[j]) for j in range(s)):
        progressed = False
        for j in range(s):
            if pc[j] >= len(ops[j]):
                continue
            op = ops[j][pc[j]]
            if op in ("F", "X"):
                if j > 0 and f_cnt[j] not in acts[j]:
                    continue
                acts[j].discard(f_cnt[j])
                if op == "F":
                    acts[j + 1].add(f_cnt[j])
                else:
                    if j > 0:
                        grads[j - 1].add(f_cnt[j])
                    b_cnt[j] += 1
                f_cnt[j] += 1
            else:
                if b_cnt[j] not in grads[j]:
                    continue
                grads[j].discard(b_cnt[j])
                if j > 0:
                    grads[j - 1].add(b_cnt[j])
                b_cnt[j] += 1
            pc[j] += 1
            progressed = True
        if not progressed:
            raise RuntimeError(
                "1F1B schedule wedged: no stage op is ready "
                f"(pc={pc}, fwd={f_cnt}, bwd={b_cnt}) — schedule "
                "bookkeeping bug, not a device stall"
            )


def check_mpmd(cfg, env) -> None:
    """The JAX runner's refusals, word for word."""
    model_cfg = cfg.model
    if getattr(model_cfg, "family", None) != "gpt":
        raise ValueError(
            "model.pipeline_impl='mpmd': per-stage programs are wired "
            f"for the GPT stack (family {model_cfg.family!r}); use "
            "pipeline_impl='spmd'"
        )
    if cfg.data.name not in ("lm", "lm_synthetic"):
        raise ValueError(
            "model.pipeline_impl='mpmd' implements the LM task "
            f"(data.name {cfg.data.name!r})"
        )
    if model_cfg.moe.num_experts > 0:
        raise ValueError(
            "model.pipeline_impl='mpmd' does not support MoE blocks "
            "(the router aux loss needs a cross-stage reduction the "
            "explicit-transfer boundary does not carry yet); use "
            "pipeline_impl='spmd'"
        )
    if circular_repeat(model_cfg) > 1:
        raise ValueError(
            "model.pipeline_impl='mpmd' runs the 1F1B schedule; the "
            "circular (interleaved) schedule is an SPMD-backend "
            "feature — set pipeline_circular_repeat=1 or "
            "pipeline_impl='spmd'"
        )
    if cfg.trainer.offload_opt_state:
        raise ValueError(
            "model.pipeline_impl='mpmd' does not compose with "
            "trainer.offload_opt_state (per-stage programs manage "
            "their own state residency)"
        )
    s = int(model_cfg.pipeline_stages)
    if s < 2:
        raise ValueError("pipeline_impl='mpmd' needs pipeline_stages >= 2")
    if env.axis_size("pipe") != s:
        raise ValueError(
            f"pipeline_impl='mpmd' maps one stage per pipe-mesh slice: "
            f"mesh.pipe={env.axis_size('pipe')} != "
            f"pipeline_stages={s}"
        )
    if model_cfg.num_layers % s:
        raise ValueError(
            f"{model_cfg.num_layers} layers not divisible by {s} stages"
        )
    total = effective_microbatches(model_cfg) * cfg.trainer.grad_accum
    b = cfg.data.global_batch_size
    if b % total:
        raise ValueError(
            f"data.global_batch_size={b} not divisible by "
            f"pipeline_microbatches x grad_accum = {total}"
        )
    if (b // total) % env.batch_axis_size:
        raise ValueError(
            f"microbatch size {b // total} not divisible by the "
            f"stage submesh batch axes ({env.batch_axis_size})"
        )


class MpmdPipelineRunner:
    """The 1F1B loop of this rank's stage of ``cfg`` over ``env``
    (``pipe == pipeline_stages``). Called, it is the step's ``grad_fn``
    (``make_grad_fn``'s contract, with ``update_span`` around the
    update); ``eval_fn`` is ``make_eval_step``'s; so the ``Trainer``
    steps it like any other model. ``model`` is this rank's
    ``GptStage``, ``layout`` the run's (its stage's parameters),
    ``head_loss(ln_f features, the tied table, targets)`` the last
    stage's loss on one microbatch (the trainer's dense head and CE)."""

    def __init__(self, cfg, env, policy, model, layout, device, head_loss):
        from frl_distributed_ml_scaffold_tpu_torch import resolve_device

        check_mpmd(cfg, env)
        self.cfg, self.env, self.policy = cfg, env, policy
        self.model, self.layout = model, layout
        self.head_loss = head_loss
        self.device = resolve_device(device)
        model_cfg = cfg.model
        if model_cfg.lm_loss_chunk:
            from frl_distributed_ml_scaffold_tpu_torch.utils.logging import (
                get_logger,
            )

            get_logger().warning(
                "pipeline_impl='mpmd' computes the LM head densely per "
                "microbatch (model.lm_loss_chunk=%d ignored; microbatch "
                "logits are already 1/M of the batch tensor)",
                model_cfg.lm_loss_chunk,
            )
        self.num_stages = s = int(model_cfg.pipeline_stages)
        self.stage = env.axis_index("pipe")
        self.microbatches = effective_microbatches(model_cfg)
        self.total_micro = self.microbatches * cfg.trainer.grad_accum
        self.micro_batch = cfg.data.global_batch_size // self.total_micro
        self.runner = StageRunner(model, cfg.trainer.remat)
        self.layers = model.layers

        # Telemetry (attached per fit() by the Trainer).
        self._tracer = self._trace = self._watchdog = None
        self._g_idle = self._g_bubble = self._c_transfer = None
        #: Schedule instrumentation from the last step: per-stage peak
        #: in-flight boundary activations (the 1F1B memory pin reads
        #: this), this rank's boundary bytes sent, per-stage idle time.
        self.last_peak_live: list[int] = [0] * s
        self.last_boundary_bytes: int = 0
        self.last_stage_idle_s: list[float] = [0.0] * s
        self.mail = Mailbox(env)

    # ------------------------------------------------------- telemetry

    def attach_telemetry(self, *, registry=None, tracer=None, trace=None,
                         watchdog=None) -> None:
        """Wire the fit() loop's telemetry into the 1F1B loop: per-stage
        idle gauges + the analytic bubble gauge, boundary-transfer
        counter, stage-lane spans, and watchdog beats from inside the
        schedule loop (a wedged inter-stage transfer then fires the stall
        dump instead of hanging silently)."""
        self._tracer, self._trace, self._watchdog = tracer, trace, watchdog
        if registry is not None:
            self._g_idle = [
                registry.gauge(
                    f"pipeline_stage{j}_idle_s",
                    help="host-observed dispatch shadow of stage j per "
                    "step (fill/drain + starvation)",
                )
                for j in range(self.num_stages)
            ]
            self._g_bubble = registry.gauge(
                "pipeline_bubble_fraction",
                help="analytic (S-1)/(M+S-1) of the running 1F1B schedule",
            )
            self._c_transfer = registry.counter(
                "pipeline_boundary_transfer_bytes_total",
                help="explicit inter-stage activation/gradient bytes "
                "moved by the 1F1B loop",
            )

    def _span(self, name: str, **fields):
        if self._tracer is not None and getattr(self._tracer, "enabled",
                                                False):
            return self._tracer.span(name, trace=self._trace,
                                     cat="pipeline", **fields)
        return contextlib.nullcontext()

    def _beat(self) -> None:
        if self._watchdog is not None:
            self._watchdog.beat()

    @contextlib.contextmanager
    def update_span(self, step: int):
        """The span of this stage's optimizer update (``make_train_step``
        runs the update inside it), a watchdog beat after it."""
        with self._span(f"stage{self.stage}_update", step=int(step)):
            yield
        self._beat()

    # ------------------------------------------------------------ 1F1B

    def _like(self, rows: int, t: int) -> torch.Tensor:
        return torch.empty((rows, t, self.cfg.model.hidden_dim),
                           dtype=self.policy.compute_dtype,
                           device=self.device)

    def _stage_fwd(self, params, x, seed, train: bool):
        """This stage's program on boundary input ``x`` (stage 0: the
        tokens): the embedding front on stage 0, then its layers."""
        if self.stage == 0:
            x = embed(params, x, self.cfg.model, self.policy, seed)
        return self.runner(self.layers, x, seed, train, params)[::2]

    def __call__(self, params: dict, extras: dict, batch: Any,
                 step: int = 0):
        """One 1F1B pass over ``microbatches x grad_accum`` microbatches
        of this rank's rows (``make_grad_fn``'s contract)."""
        from frl_distributed_ml_scaffold_tpu_torch.models.dropout import (
            check_seed,
            mix_seed,
        )

        cfg, policy = self.cfg, self.policy
        s, j, mt = self.num_stages, self.stage, self.total_micro
        last = j == s - 1
        t_start = time.perf_counter()
        check_order(s, mt)
        mail = self.mail
        mail.sent = 0
        tokens = to_device(batch, self.device)["tokens"]
        mbs = Microbatches(tokens, mt)
        rows, t_len = mbs.inputs[0].shape
        seeds = [check_seed(cfg.model.dropout, True, mix_seed(
            cfg.trainer.seed, step, i)) for i in range(mt)]
        params_c = policy.cast_to_compute(
            {k: p.detach() for k, p in params.items()})
        for p in params_c.values():
            p.requires_grad_()
        acc = {k: torch.zeros(p.shape, dtype=policy.reduce_dtype,
                              device=p.device) for k, p in params.items()}
        emb = g_emb = None
        if j == 0:
            mail.put(params_c["wte.weight"], 0, s - 1, remote=True)
        if last:
            v, d = cfg.model.vocab_size, cfg.model.hidden_dim
            emb = mail.take(0, s - 1, like=torch.empty(
                (v, d), dtype=policy.compute_dtype, device=self.device))
            emb.requires_grad_()
            g_emb = torch.zeros((v, d), dtype=policy.reduce_dtype,
                                device=self.device)
        like = self._like(rows, t_len)
        saved: dict = {}
        peak = f_cnt = b_cnt = 0
        first_t = last_t = None
        losses = []
        for op in stage_ops(j, s, mt):
            if op == "F":
                m = f_cnt
                x = mbs.inputs[m] if j == 0 else mail.take(j - 1, j, like)
                with self._span(f"stage{j}_fwd", step=int(step),
                                microbatch=m), torch.no_grad():
                    y, _ = self._stage_fwd(params_c, x, seeds[m], True)
                saved[m] = x
                peak = max(peak, len(saved))
                mail.put(y, j, j + 1, remote=True)
                f_cnt += 1
            elif op == "X":
                m = f_cnt
                x = mail.take(j - 1, j, like).requires_grad_()
                with self._span(f"stage{j}_fwd_bwd", step=int(step),
                                microbatch=m):
                    y, _, names = self.runner(self.layers, x, seeds[m], True,
                                              params_c)
                    ce, gy, ge = head_grads(params_c, y, mbs.targets[m],
                                            cfg.model, self.head_loss, acc,
                                            emb=emb)
                    self._backward(params_c, y, gy, names, acc, x)
                g_emb.add_(ge.to(g_emb.dtype))
                losses.append(ce)
                f_cnt += 1
                b_cnt += 1
            else:  # "B"
                m = b_cnt
                g = mail.take(j + 1, j, like)
                x = saved.pop(m)
                with self._span(f"stage{j}_bwd", step=int(step),
                                microbatch=m):
                    # The recompute from the saved boundary input.
                    leaf = None if j == 0 else x.requires_grad_()
                    xin = (embed(params_c, x, cfg.model, policy, seeds[m])
                           if j == 0 else leaf)
                    y, _, names = self.runner(self.layers, xin, seeds[m],
                                              True, params_c)
                    self._backward(params_c, y, g, names + (
                        list(EMBED_KEYS) if j == 0 else []), acc, leaf)
                b_cnt += 1
            now = time.perf_counter()
            first_t = now if first_t is None else first_t
            last_t = now
            self._beat()
        # The head's gradient of the tied embedding back to stage 0.
        if last:
            mail.put(g_emb, s - 1, 0, remote=True)
        if j == 0:
            got = mail.take(s - 1, 0, like=torch.empty_like(acc[
                "wte.weight"]))
            acc["wte.weight"].add_(got)
        mail.flush()
        del params_c, saved
        sums = torch.zeros(3, dtype=torch.float32, device=self.device)
        if last:
            ces = torch.stack(losses)
            sums[0], sums[1] = ces.mean(), torch.exp(ces).mean()
        ce, ppl, _ = pipe_sum(sums, self.env).unbind()
        loss, ce_m, ppl_m = batch_mean([ce, ce, ppl], self.layout, 1.0)
        grads = finish_grads(acc, policy, self.layout, 1.0 / mt)
        t_end = time.perf_counter()
        self._record(peak, mail.sent, (first_t - t_start) + (t_end - last_t))
        return loss, {"ce_loss": ce_m, "perplexity": ppl_m}, extras, grads

    def _backward(self, params, y, g, names, acc, leaf) -> None:
        """Differentiate one stage forward against its output's
        cotangent ``g``: the parameter gradients into ``acc`` and, with a
        boundary ``leaf``, its cotangent sent to the previous stage."""
        inputs = [params[k] for k in names] + ([] if leaf is None
                                               else [leaf])
        got = torch.autograd.grad([y], inputs, [g], allow_unused=True)
        for k, gk in zip(names, got):
            if gk is not None:
                acc[k].add_(gk.to(acc[k].dtype))
        if leaf is not None:
            self.mail.put(got[-1], self.stage, self.stage - 1, remote=True)

    def _record(self, peak: int, sent: int, idle: float) -> None:
        """The step's counters, every stage's gathered over ``pipe``."""
        s = self.num_stages
        vals = torch.zeros((2, s), dtype=torch.float64, device=self.device)
        vals[0, self.stage], vals[1, self.stage] = peak, idle
        vals = pipe_sum(vals, self.env)
        self.last_peak_live = [int(v) for v in vals[0].tolist()]
        self.last_stage_idle_s = vals[1].tolist()
        self.last_boundary_bytes = sent
        if self._g_idle is not None:
            for j in range(s):
                self._g_idle[j].set(self.last_stage_idle_s[j])
            self._g_bubble.set(bubble_fraction("1f1b", s, self.total_micro))
            self._c_transfer.inc(sent)

    # ------------------------------------------------------------ eval

    def eval_fn(self, state, batch) -> dict:
        """Forward-only metrics (the ``make_eval_step`` contract): the
        whole batch through the stages, the head on the last."""
        from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
            mesh_context,
        )

        policy, s, j = self.policy, self.num_stages, self.stage
        tokens = to_device(batch, self.device)["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        params_c = policy.cast_to_compute(dict(state.params))
        mail = self.mail
        sums = torch.zeros(3, dtype=torch.float32, device=self.device)
        with torch.no_grad(), mesh_context(self.env):
            if j == 0:
                mail.put(params_c["wte.weight"], 0, s - 1, remote=True)
            x = inputs if j == 0 else mail.take(j - 1, j, self._like(
                *inputs.shape))
            y, _ = self._stage_fwd(params_c, x, None, False)
            if j < s - 1:
                mail.put(y, j, j + 1, remote=True)
            else:
                v, d = self.cfg.model.vocab_size, self.cfg.model.hidden_dim
                emb = mail.take(0, s - 1, like=torch.empty(
                    (v, d), dtype=policy.compute_dtype, device=self.device))
                ce = self.head_loss(final_norm(params_c, y, self.cfg.model),
                                    emb, targets).float()
                sums[0], sums[1] = ce, torch.exp(ce)
            mail.flush()
        ce, ppl, _ = pipe_sum(sums, self.env).unbind()
        loss, ce_m, ppl_m = batch_mean([ce, ce, ppl], self.layout, 1.0)
        return {"ce_loss": ce_m, "perplexity": ppl_m, "loss": loss}
