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
    out["params"] = _numpy(lay.whole_params(state.params))
    out["extras"] = _numpy(state.extras)
    if keep_local:
        out["local_params"] = _numpy(state.params)
    return out


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


JOBS = {"collectives": collectives, "train": train,
        "dropout_rows": dropout_rows, "serve": serve,
        "saved_shapes": saved_shapes, "rings": rings,
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
