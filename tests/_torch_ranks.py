"""A rank of the port's multi-rank CPU tests: one process of a gloo run.

    python tests/_torch_ranks.py RANK WORLD RENDEZVOUS JOBS OUT

joins the process group at ``RENDEZVOUS`` (a ``file://`` path), runs
every job of the ``torch.save`` list ``JOBS`` (``{"name", "kind",
"args"}``; ``kind`` names a function below) in order, and writes
``{name: result}`` to ``OUT/rank<RANK>.pt``. It imports torch and the
port only: the tests hold its results against the JAX package in their
own process. ``start_ranks`` starts a run, ``spawn_ranks`` also waits
for its results.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def start_ranks(world: int, jobs: list, tmp, timeout: float = 240):
    """Start ``jobs`` on ``world`` gloo ranks; returns ``wait()``, which
    returns each rank's results (a list by rank). A rank that fails
    fails ``wait`` with its output."""
    tmp = str(tmp)
    jobs_path = os.path.join(tmp, "jobs.pt")
    torch.save(jobs, jobs_path)
    rdv = "file://" + os.path.join(tmp, "rendezvous")
    # A rank that fails leaves the others in a collective: a short
    # process-group timeout ends them instead of the test's.
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "FRL_TPU_INIT_TIMEOUT_S": "90"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_ranks.py"), str(r),
         str(world), rdv, jobs_path, tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for r in range(world)]

    def wait():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for p in procs:
                p.kill()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   + outs[r][-6000:])
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]

    return wait


def spawn_ranks(world: int, jobs: list, tmp, timeout: float = 240):
    """``start_ranks`` and wait for them."""
    return start_ranks(world, jobs, tmp, timeout)()


# ------------------------------------------------------------------ jobs


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.is_floating_point() else t).numpy().copy()
    return tree


def collectives(env_cfg: dict) -> dict:
    """Each collective of ``dist/collectives.py`` over a data=4 mesh, on
    the shard ``arange`` of the JAX tests' cases."""
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import MeshConfig
    from frl_distributed_ml_scaffold_tpu_torch.dist import collectives as C
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
        build_mesh,
        mesh_context,
    )

    env = build_mesh(MeshConfig(**env_cfg))
    n, i = env.axis_size("data"), env.axis_index("data")
    out = {}
    with mesh_context(env):
        x = torch.arange(float(n))[i:i + 1]  # this shard of arange(n)
        out["all_reduce"] = C.all_reduce(x, "data")
        out["all_mean"] = C.all_mean(x, "data")
        m = torch.arange(2.0 * n).reshape(n, 2)[i:i + 1]
        full = C.all_gather(m, "data")
        out["all_gather"] = full
        out["reduce_scatter"] = C.reduce_scatter(full, "data")
        out["broadcast"] = C.broadcast(x, "data", source=3)
        out["ring_shift"] = C.ring_shift(x, "data", shift=1)
        sq = torch.arange(float(n * n)).reshape(n, n)[i:i + 1]
        out["all_to_all"] = C.all_to_all(sq, "data", split_axis=1,
                                         concat_axis=0)
        out["axis"] = torch.tensor([C.axis_index("data"),
                                    C.axis_size("data")])
        out["tree"] = C.all_reduce({"a": x, "b": {"c": 2 * x}}, "data")
    out["host_all_gather"] = C.host_all_gather(np.array([float(i)]))
    out["host_broadcast"] = C.host_broadcast({"rank": i})
    C.barrier("test")
    return _numpy(out)


def train(config: str, overrides: list, steps: int, *,
          keep_local: bool = False) -> dict:
    """``steps`` steps of the ``Trainer``'s step on this rank, from the
    config's init (``trainer.init_params_path`` when the overrides set
    it): per-step metrics, this rank's batches, the layout's specs and
    per-rank bytes, and the whole params at the end (and this rank's own
    shards with ``keep_local``)."""
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
    from frl_distributed_ml_scaffold_tpu_torch.utils.trees import (
        tree_size_bytes,
    )

    from frl_distributed_ml_scaffold_tpu_torch.dist import collectives

    cfg = tconfig.apply_overrides(tconfig.get_config(config), overrides)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    lay = trainer.layout
    collectives.reset_counters()
    out = {"metrics": [], "batches": [],
           "specs": {"param": lay.param, "opt": lay.opt,
                     "accum": lay.accum, "compute": lay.compute},
           "accum_shapes": {k: lay.local_shape(k, s)
                            for k, s in lay.accum.items()},
           "param_bytes": tree_size_bytes(state.params),
           "opt_bytes": sum(tree_size_bytes(v) for k, v in
                            state.opt_state.items() if k != "count"),
           "coords": trainer.env.coords}
    for step in range(steps):
        batch = trainer.pipeline.global_batch(step)  # this rank's rows
        out["batches"].append(_numpy(batch))
        state, m = trainer.train_step(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    # The overlap schedule's counts over the steps: bytes sent point to
    # point by axis and dtype, and the blockwise gathers.
    out["wire_bytes"] = {a: dict(v) for a, v in
                         collectives.wire_bytes.items()}
    hooks = getattr(trainer.model, "param_hooks", None)
    out["gathers"] = (None if hooks is None else
                      {"gathers": hooks.gathers, "regathers": hooks.regathers,
                       "names": sorted(hooks.gathered_names()),
                       "events": hooks.events})
    runner = getattr(trainer, "_mpmd", None)
    if runner is not None:  # the 1F1B loop's counters of the last step
        out["pipeline"] = {"peak_live": runner.last_peak_live,
                           "boundary_bytes": runner.last_boundary_bytes,
                           "idle_s": runner.last_stage_idle_s}
    out["params"] = _numpy(lay.whole_params(state.params))
    out["local_names"] = sorted(state.params)
    out["extras"] = _numpy(state.extras)
    if keep_local:
        out["local_params"] = _numpy(state.params)
    return out


def grads(config: str, overrides: list) -> dict:
    """The gradients of step 0 on this rank (``make_grad_fn`` through the
    ``Trainer``'s layout), gathered whole, with the loss, the metrics and
    this rank's batch."""
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import mesh_context
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    cfg = tconfig.apply_overrides(tconfig.get_config(config), overrides)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    lay, t = trainer.layout, cfg.trainer
    fn = make_grad_fn(trainer.loss_fn, trainer.policy,
                      grad_accum=t.grad_accum, remat=t.remat, seed=t.seed,
                      layout=lay, device="cpu")
    batch = trainer.pipeline.global_batch(0)
    with mesh_context(trainer.env):
        loss, metrics, _, g = fn(state.params, state.extras, batch)
        whole = {k: lay.gather(k, x, lay.opt[k], (None,) * x.dim())
                 for k, x in g.items()}
    return _numpy({"loss": loss, "metrics": metrics, "grads": whole,
                   "batch": batch, "coords": trainer.env.coords})


def rings(cases: list) -> dict:
    """The collective-matmul rings on this rank of a ``model=N`` mesh:
    each case (``{"name", "op": "agm" | "mrs", "x", "w", "dy", "dfull",
    "chunk_axis", "return_full", "lowp"}``, numpy arrays of this rank's
    shards) forward, then backward with the given cotangents. Returns the
    outputs and gradients, the first hop's sends (as sent: payloads and
    scales) and the bytes sent by dtype."""
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import MeshConfig
    from frl_distributed_ml_scaffold_tpu_torch.dist import collectives as C
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import build_mesh
    from frl_distributed_ml_scaffold_tpu_torch.ops import (
        collective_matmul as cm,
    )

    env = build_mesh(MeshConfig(data=1, model=-1))
    first: list = []
    start = C.exchange_start

    def record(sends, recvs, axis, env=None):
        if not first:
            first.append([t.detach().clone() for t, _ in sends])
        return start(sends, recvs, axis, env=env)

    C.exchange_start = record
    out = {"index": env.axis_index("model")}
    for case in cases:
        C.reset_counters()
        first.clear()
        x = torch.from_numpy(case["x"]).requires_grad_()
        w = torch.from_numpy(case["w"]).requires_grad_()
        if case["op"] == "agm":
            y = cm.all_gather_matmul(x, w, "model", case["chunk_axis"],
                                     case["return_full"], case["lowp"],
                                     env=env)
        else:
            y = cm.matmul_reduce_scatter(x, w, "model", case["chunk_axis"],
                                         case["lowp"], env=env)
        outs = y if isinstance(y, tuple) else (y,)
        cts = [torch.from_numpy(case["dy"])]
        if case.get("return_full"):
            cts.append(torch.from_numpy(case["dfull"]))
        fwd_first = list(first)
        first.clear()
        torch.autograd.backward(outs, cts)
        out[case["name"]] = _numpy({
            "outs": list(outs), "dx": x.grad, "dw": w.grad,
            "first_fwd": fwd_first[0] if fwd_first else [],
            "first_bwd": first[0] if first else [],
            "wire": dict(C.wire_bytes.get("model", {}))})
    C.exchange_start = start
    return out


def saved_shapes(config: str, overrides: list) -> dict:
    """One step of the ``Trainer``'s step under an outer
    ``torch.autograd.graph.saved_tensors_hooks`` that records the shape
    of every tensor autograd saves for the backward; with the shapes of
    the blockwise-gathered params, whole, and the hooks' counts."""
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    cfg = tconfig.apply_overrides(tconfig.get_config(config), overrides)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    lay = trainer.layout
    seen = []

    def pack(t):
        seen.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        trainer.train_step(state, trainer.pipeline.global_batch(0))
    hooks = trainer.model.param_hooks
    names = ([k for k in lay.shapes if k.startswith("blocks.")
              and "fsdp" in lay.param[k]] if hooks is None
             else sorted(hooks.gathered_names()))
    return {"saved": seen,
            "gathered": {k: lay.local_shape(k, tuple(
                None if e == "fsdp" else e for e in lay.param[k]))
                for k in names},
            "counts": (None if hooks is None else
                       {"gathers": hooks.gathers,
                        "regathers": hooks.regathers,
                        "events": hooks.events})}


def dropout_rows(rate: float, seed: int, shape: tuple) -> dict:
    """This rank's dropout mask of a ``shape`` (this rank's rows) site on
    a data=N mesh."""
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import MeshConfig
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
        build_mesh,
        mesh_context,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.dropout import keep_mask

    env = build_mesh(MeshConfig(data=-1))
    with mesh_context(env):
        mask = keep_mask(shape, rate, seed, 3, 1, device="cpu")
    return {"mask": mask.numpy(), "index": env.batch_index}


def seq_attention(mesh: dict, cases: list) -> dict:
    """Ring and Ulysses attention on this rank of a ``seq`` (and
    ``model``) mesh: each case (``{"name", "op": "ring" | "ulysses",
    "causal", "q", "k", "v", "do"}``, numpy (B, T, H, D) arrays of the
    whole problem) on this rank's tokens (and heads along ``model``),
    forward then backward with its part of ``do``. Returns this rank's
    output and gradients, its coordinates, the flash launches' count on
    the CPU route (0) and the bytes it sent over ``seq`` by dtype."""
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import MeshConfig
    from frl_distributed_ml_scaffold_tpu_torch.dist import collectives as C
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
        build_mesh,
        mesh_context,
    )
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa
    from frl_distributed_ml_scaffold_tpu_torch.ops.ring_attention import (
        ring_attention,
    )
    from frl_distributed_ml_scaffold_tpu_torch.ops.ulysses import (
        ulysses_attention,
    )

    env = build_mesh(MeshConfig(**mesh))
    r, n = env.axis_index("seq"), env.axis_size("seq")
    m, mn = env.axis_index("model"), env.axis_size("model")
    out = {"coords": env.coords}
    ops = {"ring": ring_attention, "ulysses": ulysses_attention}
    for case in cases:
        t, h = case["q"].shape[1] // n, case["q"].shape[2] // mn

        def part(a):
            return torch.from_numpy(np.ascontiguousarray(
                a[:, r * t:(r + 1) * t, m * h:(m + 1) * h]))

        q, k, v = (part(case[x]).requires_grad_() for x in "qkv")
        C.reset_counters()
        fallbacks = fa.flash_attention.fallbacks
        with mesh_context(env):
            try:
                o = ops[case["op"]](q, k, v, causal=case["causal"])
            except ValueError as e:
                out[case["name"]] = {"error": str(e)}
                continue
            o.backward(part(case["do"]))
        out[case["name"]] = _numpy({
            "o": o, "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "wire": {a: dict(b) for a, b in C.wire_bytes.items()},
            "fallbacks": fa.flash_attention.fallbacks - fallbacks})
    return out


_CALLS: dict | None = None
_RANK = 0  # this process's rank (``main``)


def _count_collectives() -> dict:
    """Count this process's calls of the ``torch.distributed`` collectives
    (``calls["n"]``), wrapping them in place once."""
    global _CALLS
    if _CALLS is not None:
        return _CALLS
    import torch.distributed as dist

    _CALLS = {"n": 0}
    for name in ("all_reduce", "all_gather", "broadcast", "reduce_scatter",
                 "all_to_all", "broadcast_object_list", "all_gather_object",
                 "send", "recv", "isend", "irecv", "batch_isend_irecv"):
        def counted(*a, _fn=getattr(dist, name), **k):
            _CALLS["n"] += 1
            return _fn(*a, **k)

        setattr(dist, name, counted)
    return _CALLS


def serve(model_cfg: dict, state: dict, mesh: dict, cases: list,
          skew_rank: int = -1) -> dict:
    """Tensor-parallel serving on this rank: the port's GPT (``model_cfg``
    fields, fp32) loaded with ``state`` (numpy, the whole params), placed
    by ``build_engine(rules=gpt_tp_rules())`` inside the mesh of
    ``mesh``, then each case of ``cases`` (``{"name", "kind", ...}``):
    ``generate`` (``prompt``, ``new``), ``beam`` (also ``beams``) or
    ``engine`` (``serving`` fields, ``temperature``,
    ``requests`` as ``(prompt, new, deadline_s, tenant)``, ``slots``,
    ``kv_cache_quant``). Each case builds its model anew from
    ``state``. On rank ``skew_rank`` the clock runs a million times
    fast, so every deadline this process judged on its own would pass at
    once. Returns each case's tokens and finish reasons (by request id),
    the engine's byte counts, its stats and, for a disaggregated engine,
    the collectives its handoff splices made."""
    import time

    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        GPTConfig,
        MeshConfig,
        ServingConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
        build_mesh,
        mesh_context,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
        beam_search,
        generate,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
        GPT,
        gpt_tp_rules,
    )
    from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
        shard_params_for_serving,
    )
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    env = build_mesh(MeshConfig(**mesh))
    if env.rank == skew_rank:
        real, t0 = time.perf_counter, time.perf_counter()
        time.perf_counter = lambda: t0 + (real() - t0) * 1e6
    out = {"coords": env.coords}
    splices = {"n": 0, "calls": 0}
    for case in cases:
        cfg = GPTConfig(**{**model_cfg, **case.get("model", {})})
        model = GPT(cfg, get_policy("fp32"), device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        res = {}
        with mesh_context(env):
            if case["kind"] in ("generate", "beam"):
                shard_params_for_serving(model, env, gpt_tp_rules())
                res["heads"] = model.local_heads()
                if case["kind"] == "generate":
                    res["tokens"] = generate(
                        model, case["prompt"], max_new_tokens=case["new"],
                        temperature=0.0, device="cpu").numpy()
                else:
                    toks, scores = beam_search(
                        model, case["prompt"], max_new_tokens=case["new"],
                        num_beams=case["beams"], device="cpu")
                    res["tokens"], res["scores"] = (toks.numpy(),
                                                    scores.numpy())
                out[case["name"]] = res
                continue
            serving = ServingConfig(**case.get("serving", {}))
            # A sampled case draws from a generator seeded by the rank:
            # only the lock step's broadcast keeps the ranks' tokens equal.
            gen = (torch.Generator().manual_seed(env.rank)
                   if case.get("temperature") else None)
            eng = build_engine(model, serving=serving,
                               rules=gpt_tp_rules(), num_slots=case["slots"],
                               temperature=case.get("temperature", 0.0),
                               generator=gen, device="cpu")
        if serving.disaggregate:
            calls = _count_collectives()

            def admit(*a, _inner=eng.decode.admit_handoff, **k):
                n0 = calls["n"]
                _inner(*a, **k)
                splices["n"] += 1
                splices["calls"] += calls["n"] - n0

            eng.decode.admit_handoff = admit
        for prompt, new, deadline, tenant in case["requests"]:
            kw = {"deadline_s": deadline}
            if serving.disaggregate:
                kw["tenant"] = tenant
            eng.submit(np.asarray(prompt, np.int32), new, **kw)
        done = eng.run()
        res["done"] = {c.id: (np.asarray(c.tokens), c.finish_reason)
                       for c in done}
        res["bytes_per_slot"] = eng.bytes_per_slot()
        res["block_bytes"] = eng.block_bytes()
        res["stats"] = dict(eng.stats)
        out[case["name"]] = res
    out["splices"] = splices
    return out


def checkpoint(config: str, overrides: list, workdir: str,
               steps: int) -> dict:
    """``steps`` steps through ``Trainer.fit`` with a checkpoint at the
    last one (``workdir``), then a new ``Trainer`` on the same mesh
    restoring it: the whole params after the run and after the restore,
    and this rank's own names in each."""
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    ov = overrides + [f"workdir={workdir}", "checkpoint.enabled=true",
                      f"checkpoint.save_every={steps}",
                      "checkpoint.async_save=false",
                      f"trainer.total_steps={steps}", "trainer.log_every=1"]
    cfg = tconfig.apply_overrides(tconfig.get_config(config), ov)
    trainer = Trainer(cfg, device="cpu")
    state, _ = trainer.fit()
    out = {"fit": _numpy(trainer.layout.whole_params(state.params)),
           "fit_local": sorted(state.params), "fit_step": int(state.step)}
    again = Trainer(cfg, device="cpu")
    restored = again.checkpointer.restore_or_init(again)
    out["restored"] = _numpy(again.layout.whole_params(restored.params))
    out["restored_local"] = sorted(restored.params)
    out["restored_opt_local"] = sorted(restored.opt_state["mu"])
    out["restored_step"] = int(restored.step)
    return out


def mpmd_telemetry(config: str, overrides: list) -> dict:
    """One step of the MPMD 1F1B loop with telemetry attached (a registry, a
    tracer and a counting watchdog): the span names, the beats and the
    registry's snapshot on this rank, and its stage's op count."""
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
    from frl_distributed_ml_scaffold_tpu_torch.telemetry import (
        MetricsRegistry,
        Tracer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    cfg = tconfig.apply_overrides(tconfig.get_config(config), overrides)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()

    class Beats:
        n = 0

        def beat(self):
            self.n += 1

    reg, tracer, beats = MetricsRegistry(), Tracer(), Beats()
    runner = trainer._mpmd
    runner.attach_telemetry(registry=reg, tracer=tracer,
                            trace=tracer.new_trace("t"), watchdog=beats)
    trainer.train_step(state, trainer.pipeline.global_batch(0))
    return {"spans": sorted({sp["name"] for sp in tracer.spans()}),
            "beats": beats.n, "snapshot": reg.snapshot(),
            "ops": runner.total_micro * (1 if runner.stage
                                         == runner.num_stages - 1 else 2),
            "coords": trainer.env.coords}


def _env(n: int, kw: dict):
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import MeshConfig
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import build_mesh

    return build_mesh(MeshConfig(**kw), n)


def redist_grid(cases: list) -> dict:
    """The executor on each case (``{"name", "src", "dst"`` as ``(n,
    mesh, spec)``, ``"shape"``, ``"dtypes"``, ``"limit"``, ``"naive"}``):
    a seeded array of every dtype moved there and back (donated), each
    rank's regions compared bit for bit; the plan's numbers, this rank's
    sent bytes and scratch, and, where ``naive``, the naive reference's
    result and sent bytes."""
    from frl_distributed_ml_scaffold_tpu_torch import redistribute as rd
    from frl_distributed_ml_scaffold_tpu_torch.redistribute import (
        executor,
    )

    envs = {}
    for case in cases:  # every rank builds every mesh, in one order
        for n, kw, _ in (case["src"], case["dst"]):
            key = (n, tuple(sorted(kw.items())))
            if key not in envs:
                envs[key] = _env(n, kw)
    me = torch.distributed.get_rank()
    out = {}
    for case in cases:
        (ns, ks, ss), (nd, kd, sd) = case["src"], case["dst"]
        src = rd.Placement(envs[(ns, tuple(sorted(ks.items())))], ss)
        dst = rd.Placement(envs[(nd, tuple(sorted(kd.items())))], sd)
        shape = tuple(case["shape"])
        rng = np.random.default_rng(7)
        base = torch.from_numpy(rng.integers(-100, 100, size=shape)
                                .astype(np.float32))
        res = {"ok": [], "sent": [], "back_sent": [], "scratch": [],
               "donated": [], "moved": [], "lower": [], "peak": [],
               "back_moved": []}
        for dtype in case["dtypes"]:
            whole = base.to(getattr(torch, dtype))

            def local(pl):
                reg = pl.regions(shape).get(me)
                return (None if reg is None else
                        whole[tuple(slice(a, b) for a, b in reg)].clone())

            def same(a, b):
                return (a is None and b is None) or (
                    a is not None and b is not None
                    and a.shape == b.shape and torch.equal(
                        a.contiguous().view(torch.uint8),
                        b.contiguous().view(torch.uint8)))

            x = local(src)
            plan = rd.compile_tree_plan(
                {"w": rd.Abstract.of(shape, dtype, src)}, {"w": dst},
                scratch_limit_bytes=case.get("limit"))
            y = rd.execute(plan, {"w": x}, donate=True,
                           device="cpu").get("w")
            res["donated"].append(
                x is None or plan.leaves[0].kind == "identity"
                or x.untyped_storage().nbytes() == 0)
            ok = same(y, local(dst))
            res["sent"].append(plan.executed_bytes_sent)
            res["scratch"].append(plan.executed_scratch_bytes)
            back = rd.compile_tree_plan(
                {"w": rd.Abstract.of(shape, dtype, dst)}, {"w": src})
            z = rd.execute(back, {"w": y}, donate=False,
                           device="cpu").get("w")
            res["back_sent"].append(back.executed_bytes_sent)
            res["ok"].append(ok and same(z, local(src)))
            res["kind"] = plan.leaves[0].kind
            for key, v in (("moved", plan.bytes_moved),
                           ("lower", plan.bytes_lower_bound),
                           ("peak", plan.peak_scratch_bytes),
                           ("back_moved", back.bytes_moved)):
                res[key].append(v)
            if case.get("naive") and plan.leaves[0].kind == "collective":
                executor.NAIVE_GATHER_SCATTER = True
                try:
                    naive = rd.execute(plan, {"w": local(src)},
                                       donate=False, device="cpu").get("w")
                finally:
                    executor.NAIVE_GATHER_SCATTER = False
                res["naive_ok"] = same(naive, local(dst))
                res["naive_sent"] = plan.executed_bytes_sent
        out[case["name"]] = res
    return out


def redist_restore(config: str, save: list, restore: list, workdir: str,
                   steps: int, torn_at: int = 0) -> dict:
    """``steps`` steps of ``config`` saved on the mesh of ``save``
    (overrides; a torn write at save ``torn_at`` when set), then restored
    on the mesh of ``restore`` directly and through the redistribution
    service: this rank's tensors both ways, the step, the plan's numbers,
    the bytes this rank read and the payload's."""
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
    from frl_distributed_ml_scaffold_tpu_torch import faults
    from frl_distributed_ml_scaffold_tpu_torch.faults import FaultPlan
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    base = [f"workdir={workdir}", "checkpoint.enabled=true",
            f"checkpoint.save_every={max(1, steps // 3)}",
            "checkpoint.async_save=false", "checkpoint.max_to_keep=5",
            f"trainer.total_steps={steps}", "trainer.log_every=100",
            "trainer.eval_every=0"]
    cfg = tconfig.apply_overrides(tconfig.get_config(config), base + save)
    plan = (FaultPlan([dict(site="checkpoint.torn_write", at=torn_at)])
            if torn_at else FaultPlan([]))
    with faults.active(plan):
        trainer = Trainer(cfg, device="cpu")
        trainer.fit()
        trainer.checkpointer.close()
    out = {}
    for name, extra in (("direct", []),
                        ("via", ["checkpoint.restore_redistribute=true"])):
        cfg = tconfig.apply_overrides(tconfig.get_config(config),
                                      base + restore + extra)
        t = Trainer(cfg, device="cpu")
        ck = t.checkpointer
        state = ck.restore_or_init(t)
        out[name] = {"params": _numpy(state.params),
                     "opt": _numpy({k: v for k, v in state.opt_state.items()
                                    if isinstance(v, dict)}),
                     "step": int(state.step),
                     "uncommitted": ck.uncommitted_steps()}
        if name == "via":
            p = ck.last_restore_plan
            out[name].update(
                kinds=p.kinds(), moved=p.bytes_moved,
                lower=p.bytes_lower_bound, peak=p.peak_scratch_bytes,
                scratch=p.executed_scratch_bytes,
                sent=p.executed_bytes_sent, read=ck.last_restore_read_bytes,
                total=p.total_bytes, coords=t.env.coords)
        ck.close()
    return out


def redist_restore_fails(config: str, save: list, restore: list,
                         workdir: str, steps: int, fail_rank: int) -> dict:
    """``redist_restore``'s save, then a restore through the service in
    which the executor raises on ``fail_rank`` as its first move starts
    (the plan's or a send's failure): every rank's outcome (what it
    raised, or the step it restored) and the steps it judged corrupt.
    The failing rank leaves the process group, as its process would on
    exiting, so the others' sends fail instead of waiting."""
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
    from frl_distributed_ml_scaffold_tpu_torch.redistribute import (
        executor,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    base = [f"workdir={workdir}", "checkpoint.enabled=true",
            f"checkpoint.save_every={max(1, steps // 2)}",
            "checkpoint.async_save=false", f"trainer.total_steps={steps}",
            "trainer.log_every=100", "trainer.eval_every=0"]
    trainer = Trainer(tconfig.apply_overrides(tconfig.get_config(config),
                                              base + save), device="cpu")
    trainer.fit()
    trainer.checkpointer.close()
    t = Trainer(tconfig.apply_overrides(
        tconfig.get_config(config),
        base + restore + ["checkpoint.restore_redistribute=true"]),
        device="cpu")
    run_leaf = executor._run_leaf

    def failing(plan, *args):
        if plan.kind in ("collective", "chunked"):
            raise RuntimeError("injected failure of the move")
        return run_leaf(plan, *args)

    if _RANK == fail_rank:
        executor._run_leaf = failing
    out = {}
    try:
        state = t.checkpointer.restore_or_init(t)
        out["restored"] = int(state.step)
    except Exception as e:  # noqa: BLE001 (the outcome under test)
        out["raised"] = f"{type(e).__name__}: {e}"
    finally:
        executor._run_leaf = run_leaf
    out["corrupt"] = list(t.checkpointer.corrupt_steps)
    if _RANK == fail_rank:
        torch.distributed.destroy_process_group()
    return out


def _serving_model(model_cfg: dict, state: dict, **kw):
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    model = GPT(GPTConfig(**{**model_cfg, **kw}), get_policy("fp32"),
                device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _drive(eng, requests, steps: int):
    for prompt, new in requests:
        eng.submit(np.asarray(prompt, np.int32), new)
    for _ in range(steps):
        eng.step()


def _done(done) -> dict:
    return {c.id: (np.asarray(c.tokens), c.finish_reason) for c in done}


def redist_serve(model_cfg: dict, state: dict, requests: list) -> dict:
    """The serving seams on four ranks: the train-to-serve handoff of the
    fsdp=2 model=2 training layout onto ``model=2`` over ranks 0-1
    (``shard_params_for_serving(layout=)``) against the host path, then
    a paged engine there; a live re-spread grow (model=2 over ranks 0-1
    to model=4) and shrink (model=4 to model=2, the int form) mid-decode,
    and the grow again over an int8 pool. Tokens by request id on every
    rank, the plans' numbers and the engines' stats and counters; the
    grow also for an engine built with no rules (its params whole on
    every rank of the mesh)."""
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        GPTConfig,
        ParallelConfig,
        ServingConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import mesh_context
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
        TP_COMPUTE_WHOLE,
        gpt_tp_rules,
    )
    from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import (
        StateLayout,
    )
    from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
        shard_params_for_serving,
    )
    from frl_distributed_ml_scaffold_tpu_torch.redistribute import (
        executor,
    )
    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    rules = gpt_tp_rules()
    train_env = _env(4, dict(data=1, fsdp=2, model=2))
    env2 = _env(2, dict(data=1, model=2))
    env4 = _env(4, dict(data=1, model=4))
    out = {}
    paged = ServingConfig(kv_block_size=8)

    # Seam 2: the handoff.
    model = _serving_model(model_cfg, state)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    layout = StateLayout.build(
        train_env, GPTConfig(**model_cfg),
        ParallelConfig(param_sharding="fsdp", fsdp_min_size=16), shapes,
        rules=rules, compute_whole=TP_COMPUTE_WHOLE)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.data = layout.shard(k, p.data, layout.param[k])
    host = _serving_model(model_cfg, state)
    with mesh_context(env2):
        shard_params_for_serving(host, env2, rules)
    executor.reset_counters()
    with mesh_context(env2):
        eng = build_engine(model, serving=paged, rules=rules,
                           layout=layout, num_slots=2, device="cpu")
    out["handoff_equal"] = all(
        torch.equal(a, b) for a, b in zip(model.parameters(),
                                          host.parameters()))
    out["handoff_sent"] = executor.sent_bytes["chunked"]
    out["handoff_empty"] = all(p.numel() == 0 for p in model.parameters())
    for prompt, new in requests:
        eng.submit(np.asarray(prompt, np.int32), new)
    out["handoff_done"] = _done(eng.run())

    # Seam 3: grow model=2 (ranks 0-1; 2-3 dormant) to model=4, split by
    # the TP rules, and with no rules (every param and the pool whole on
    # every rank).
    for name, quant, by in (("none", "none", rules), ("int8", "int8", rules),
                            ("whole", "none", None)):
        model = _serving_model(model_cfg, state, kv_cache_quant=quant)
        with mesh_context(env2):
            eng = build_engine(model, serving=paged, rules=by,
                               num_slots=2, device="cpu")
        _drive(eng, requests, 2)
        plans = eng.respread_pool(env4)
        res = {"heads": model.local_heads(),
               "dormant_before": eng._dormant}
        res["done"] = _done(eng.run())
        res["stats"] = {k: eng.stats[k] for k in ("parked", "resumed",
                                                  "respread")}
        snap = eng.telemetry.snapshot()
        res["counters"] = (snap["serve_pool_respread_total"],
                           snap["serve_pool_respread_bytes_total"])
        res["plans"] = {k: (p.bytes_moved, p.executed_bytes_sent,
                            p.executed_scratch_bytes, p.peak_scratch_bytes,
                            [l.path for l in p.leaves])
                        for k, p in plans.items()}
        out[f"grow_{name}"] = res

    # Shrink: model=4 to model=2 by the int form; ranks 2-3 go dormant.
    model = _serving_model(model_cfg, state)
    with mesh_context(env4):
        eng = build_engine(model, serving=paged, rules=rules, num_slots=2,
                           device="cpu")
    _drive(eng, requests, 1)
    plans = eng.respread_pool(2)
    out["shrink"] = {"done": _done(eng.run()),
                     "dormant": eng._dormant,
                     "empty": all(p.numel() == 0
                                  for p in model.parameters()),
                     "moved": {k: (p.bytes_moved, p.executed_bytes_sent)
                               for k, p in plans.items()},
                     "stats": {k: eng.stats[k] for k in ("parked",
                                                         "resumed")}}
    return out


def redist_partition(model_cfg: dict, state: dict, requests: list) -> dict:
    """The disaggregated engine with a separate prefill partition on four
    ranks: ``remote`` decodes over model=2 on ranks 0-1 and prefills on a
    partition of ranks 2-3 (a ``MeshEnv`` of other ranks); ``beside``
    decodes over model=4 and prefills on a device of each rank, beside
    the live ``model`` axis. Tokens by request id, the counted transfer
    bytes and handoffs, the replica plan's numbers on this rank."""
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        MeshConfig,
        ServingConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
        MeshEnv,
        mesh_context,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import gpt_tp_rules
    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    me = torch.distributed.get_rank()
    env2 = _env(2, dict(data=1, model=2))
    env4 = _env(4, dict(data=1, model=4))
    others = MeshEnv(config=MeshConfig(data=2),
                     ranks=np.arange(2, 4).reshape(1, 2, 1, 1, 1, 1),
                     rank=me)
    serving = ServingConfig(kv_block_size=8, disaggregate=True)
    out = {}
    for name, env, part in (("remote", env2, others),
                            ("beside", env4, torch.device("cpu"))):
        model = _serving_model(model_cfg, state)
        with mesh_context(env):
            eng = build_engine(model, serving=serving, rules=gpt_tp_rules(),
                               num_slots=2, temperature=0.0,
                               prefill_env=part, device="cpu")
        pw = eng.prefill_worker
        for prompt, new in requests:
            eng.submit(np.asarray(prompt, np.int32), new)
        done = eng.run()
        plan = pw.replica_plan
        out[name] = {"done": _done(done), "remote": pw.remote,
                     "bytes": eng.stats["handoff_transfer_bytes"],
                     "handoffs": eng.stats["handoffs"],
                     "prefix_hits": sum(c.prefix_cache_hit for c in done),
                     "replica_heads": (pw.model.local_heads()
                                       if pw.model.wpe.numel() else 0),
                     "replica": (plan.bytes_moved, plan.executed_bytes_sent,
                                 plan.kinds())}
    return out


JOBS = {"collectives": collectives, "train": train,
        "checkpoint": checkpoint, "mpmd_telemetry": mpmd_telemetry,
        "dropout_rows": dropout_rows, "serve": serve,
        "saved_shapes": saved_shapes, "rings": rings,
        "seq_attention": seq_attention, "grads": grads,
        "redist_grid": redist_grid, "redist_restore": redist_restore,
        "redist_restore_fails": redist_restore_fails,
        "redist_serve": redist_serve, "redist_partition": redist_partition,
        "rings_by_rank": lambda by_rank: rings(by_rank[_RANK])}


def main(argv) -> None:
    rank, world, rdv, jobs_path, out = argv
    torch.set_num_threads(1)
    from frl_distributed_ml_scaffold_tpu_torch.dist.initialize import (
        initialize_distributed,
        shutdown_distributed,
    )

    global _RANK
    _RANK = int(rank)
    initialize_distributed(rdv, int(world), int(rank), device="cpu")
    results = {}
    try:
        for job in torch.load(jobs_path, weights_only=False):
            results[job["name"]] = JOBS[job["kind"]](**job["args"])
    finally:
        shutdown_distributed()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
