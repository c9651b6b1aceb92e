"""The harness of the port's sharded-step tests
(``test_torch_sharded_train.py``, ``test_torch_sharded_tp.py``,
``test_torch_sharded_adafactor.py``): cases cut from a recipe to a few
layers at narrow widths, fp32, two steps unless a test asks for more
(the first at the warmup's lr 0), run on four gloo ranks
(``_torch_ranks.py``)
beside the JAX step on the same mesh (4 of the 8 simulated devices) and
the port's one-rank step, on the same global batch and from one params
file (``trainer.init_params_path``).

Every rank draws its own rows (``host_offset`` = its batch index); the
global batch the JAX step and the one-rank step take is built from the
ranks' draws, microbatch m of it being every rank's microbatch m (the
row order ``grad_accum`` splits). ``hold`` holds loss and grad_norm per
step to rtol ``RTOL`` and every param after the steps to ``RTOL`` and an
atol (``ATOL`` unless the test file says otherwise), but a leaf whose
exact gradient is 0 (``.attn.key.bias``: rounding noise that Adam
normalises, ROADMAP C.7) to Adam's bound, twice the summed lr.
"""

import jax
import numpy as np
from flax import serialization

from _torch_parity import TINY_TRAIN, TINY_VIT, ZERO_GRAD, recipe_pair
from _torch_ranks import start_ranks
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer as JaxTrainer
from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.data.pipeline import DataPipeline
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    rank_layout,
)
from frl_distributed_ml_scaffold_tpu_torch.models import convert
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

RTOL, ATOL = 2e-5, 1e-6
STEPS = 2
COMMON = ["precision.policy=fp32", *TINY_TRAIN]
GPT = ["model.num_layers=2", "model.hidden_dim=64", "model.num_heads=4",
       "model.seq_len=32", "data.seq_len=32", "data.global_batch_size=8",
       "trainer.grad_accum=2", "model.vocab_size=512", "data.vocab_size=512"]
VIT = TINY_VIT + ["data.global_batch_size=8"]
# The one-rank step runs without the overlap schedule: a ring or a
# blockwise gather over one rank is refused, as the reference refuses it.
ONE_RANK = ["mesh.data=1", "mesh.fsdp=1", "mesh.model=1", "mesh.seq=1",
            "mesh.expert=1", "mesh.pipe=1",
            "parallel.tp_overlap=false", "parallel.fsdp_overlap=false",
            "parallel.low_precision=none"]


def _random_params(shapes, seed: int) -> dict:
    """Seeded numpy params of the JAX tree's shapes: kernels at 1 /
    sqrt(fan-in), embeddings at 0.02, scales near 1, biases near 0."""
    rng = np.random.default_rng(seed)

    def one(path, sds):
        name = jax.tree_util.keystr(path)
        shape = sds.shape
        if "scale" in name:
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif "bias" in name:
            v = 0.1 * rng.standard_normal(shape)
        elif any(k in name for k in ("wte", "wpe", "pos_embedding",
                                     "cls_token")):
            v = 0.02 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _port_params(cfg, params, batch_stats=None) -> dict:
    m = cfg.model
    if m.family == "gpt":
        return convert.params_from_jax(params, m)
    if m.family == "resnet":
        return convert.resnet_params_from_jax(params, batch_stats)[0]
    if m.family == "mlp":
        return convert.mlp_params_from_jax(params)
    return convert.vit_params_from_jax(params)


def _global_batches(tcfg, steps: int = STEPS) -> tuple[list, int]:
    """The global batch of each step, built from the 4 ranks' draws
    (microbatch m of it = every rank's microbatch m, in batch-index
    order; a pipeline's microbatches are ``grad_accum`` times its M), and
    the batch-axis size."""
    from frl_distributed_ml_scaffold_tpu_torch.parallel.pipeline import (
        effective_microbatches,
    )

    ranks = rank_layout(tcfg.mesh, 4)
    ga = tcfg.trainer.grad_accum * effective_microbatches(tcfg.model)
    pipes = {}
    for r in range(4):
        env = MeshEnv(config=tcfg.mesh, ranks=ranks, rank=r)
        pipes.setdefault(env.batch_index, DataPipeline(
            tcfg.data, device="cpu", env=env))
    out = []
    for step in range(steps):
        local = [pipes[b].local_batch(step) for b in sorted(pipes)]
        out.append({k: np.concatenate([
            np.array_split(x[k], ga)[m] for m in range(ga) for x in local])
            for k in local[0]})
    return out, len(pipes)


def _run_port(cfg, batches) -> dict:
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    metrics = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": {k: v.numpy() for k, v in state.params.items()},
            "extras": state.extras,
            "lr": sum(trainer.schedule(c) for c in range(len(batches)))}


def run_cases(cases: dict, tmp, extra_jobs=(), steps: int = STEPS) -> dict:
    """Each case (``name: (recipe, overrides, with_jax[, seed])``) from
    its own random params file (seeded by ``seed``, else its index): the four ranks' results (``ranks``), the one-rank
    step's (``one``) and, ``with_jax``, the JAX step's (``jax``), on the
    global batches built from the ranks' draws, ``steps`` of them.
    ``extra_jobs`` run on the ranks after the cases; their results come
    back under ``extra``."""
    jobs, jax_side = [], {}
    for i, (name, case) in enumerate(cases.items()):
        # A case may name its params' seed (default: its index).
        recipe, ov, with_jax, seed = (*case, i)[:4]
        path = tmp / f"{name}.msgpack"
        ov = ov + COMMON + [f"trainer.init_params_path={path}"]
        jcfg, tcfg = recipe_pair(recipe, ov)
        jt = JaxTrainer(jcfg, mesh_env=jbuild(jcfg.mesh,
                                              devices=jax.devices()[:4]))
        path.write_bytes(serialization.to_bytes(
            _random_params(jt.state_shapes.params, seed)))
        jax_side[name] = (jt, tcfg, with_jax)
        jobs.append({"name": name, "kind": "train",
                     "args": {"config": recipe, "overrides": ov,
                              "steps": steps,
                              "keep_local": name == "mlp"}})
    wait = start_ranks(4, jobs + list(extra_jobs), tmp)
    out = {}
    for name, (jt, tcfg, with_jax) in jax_side.items():
        batches, nb = _global_batches(tcfg, steps)
        one = tconfig.apply_overrides(tcfg, ONE_RANK)
        res = {"batches": batches, "nb": nb, "one_cfg": one,
               "one": _run_port(one, batches)}
        if with_jax:
            jstate = jt.init_state()
            jm = []
            for b in batches:
                jstate, m = jt.train_step(jstate, b)
                jm.append({k: float(v) for k, v in m.items()})
            tree = jax.device_get(jstate.params)
            stats = jax.device_get(jstate.extras.get("batch_stats"))
            res["jax"] = {"metrics": jm,
                          "params": _port_params(tcfg, tree, stats),
                          "state": jstate, "trainer": jt}
        out[name] = res
    ranks = wait()
    for name in cases:
        out[name]["ranks"] = [r[name] for r in ranks]
    out["extra"] = [{j["name"]: r[j["name"]] for j in extra_jobs}
                    for r in ranks]
    return out


def hold_params(got: dict, want: dict, lr_sum: float, what: str,
                 atol: float = ATOL, rtol: float = RTOL):
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        if k.endswith(ZERO_GRAD):
            assert np.abs(got[k] - w).max() <= 2 * lr_sum + 1e-6, (what, k)
            continue
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def hold(run: dict, ref_metrics: list, ref_params: dict, what: str,
          atol: float = ATOL, rtol: float = RTOL):
    rank0 = run["ranks"][0]
    for r in run["ranks"]:
        assert r["metrics"] == rank0["metrics"]  # one global mean
    for got, want in zip(rank0["metrics"], ref_metrics):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=f"{what} {k}")
    hold_params(rank0["params"], ref_params, run["one"]["lr"], what, atol,
                rtol)


def hold_draws(run: dict):
    """Every rank drew its batch index's rows, and ranks along model the
    same ones."""
    by_index: dict = {}
    for r in run["ranks"]:
        for step, b in enumerate(r["batches"]):
            key = (r["coords"]["data"], r["coords"]["fsdp"], step)
            if key in by_index:
                for k in b:
                    np.testing.assert_array_equal(b[k], by_index[key][k])
            by_index[key] = b



def hold_state_bytes(run: dict):
    """Each rank's params and moments take the bytes the JAX state's
    shards take on the device at its mesh coordinate (optax's adamw keeps
    mu and nu; the clip keeps no tensor; counts are left out)."""
    jstate = run["jax"]["state"]
    mesh = jax.tree.leaves(jstate.params)[0].sharding.mesh
    ids = np.vectorize(lambda d: d.id)(np.asarray(mesh.devices))

    def per_device(tree):
        out: dict = {}
        for leaf in jax.tree.leaves(tree):
            if getattr(leaf, "ndim", 0) == 0:
                continue
            for s in leaf.addressable_shards:
                out[s.device.id] = out.get(s.device.id, 0) + s.data.nbytes
        return out

    p_b, o_b = per_device(jstate.params), per_device([jstate.opt_state])
    for r in run["ranks"]:
        dev = int(ids[tuple(r["coords"].values())])
        assert r["param_bytes"] == p_b[dev], r["coords"]
        assert r["opt_bytes"] == o_b[dev], r["coords"]


def _jax_int8_spread(run, tmp) -> dict:
    """How far the JAX int8 step itself moves when its params move by
    1e-7 relative (a random sign per value): the rounding of the int8
    quantizers turns input noise at fp32's last bits into whole
    quantization steps. The largest relative grad_norm change over the
    steps, and the largest param change after them."""
    from frl_distributed_ml_scaffold_tpu.config.core import (
        apply_overrides as japply,
    )

    jt = run["jax"]["trainer"]
    path = tmp / "ulp.msgpack"
    base = jax.device_get(jt.init_state().params)
    rng = np.random.default_rng(5)
    noisy = jax.tree.map(lambda v: (v * (1 + 1e-7 * rng.choice(
        [-1, 1], v.shape))).astype(np.float32), base)
    path.write_bytes(serialization.to_bytes(noisy))
    jcfg = japply(jt.cfg, [f"trainer.init_params_path={path}"])
    jt2 = JaxTrainer(jcfg, mesh_env=jbuild(jcfg.mesh,
                                            devices=jax.devices()[:4]))
    state, ms = jt2.init_state(), []
    for b in run["batches"]:
        state, m = jt2.train_step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    params = _port_params(run["one_cfg"], jax.device_get(state.params))
    ref = run["jax"]
    return {
        **{k: max(abs(a[k] - b[k]) / abs(b[k])
                  for a, b in zip(ms, ref["metrics"]))
           for k in ("loss", "grad_norm")},
        "params": max(float(np.abs(np.asarray(params[k])
                                   - np.asarray(ref["params"][k])).max())
                      for k in params)}


# An int8 case against the JAX int8 step: loss and grad_norm relative,
# params absolute. Measured on the tiny GPT (2 steps, 4 ranks): the port
# against JAX up to 3.7e-5 / 1.6e-4 / 4.5e-4, and the JAX int8 step
# against itself under 1e-7 relative noise on its params up to 8.8e-6 /
# 4.0e-4 / 4.5e-4 (``_jax_int8_spread``); fp32 rings hold 2e-5 / 1e-6.
INT8_TOL = {"loss": 2e-4, "grad_norm": 2e-3, "params": 2e-3}


def hold_int8(run: dict, tmp):
    """An int8 case against the JAX int8 step. The int8 quantizers
    round fp32's last-bit differences (torch's and XLA's orders of
    summation) into whole quantization steps, in the JAX step as in the
    port: the JAX int8 step itself moves by more than ``hold``'s bounds
    under 1e-7 relative noise on its params (measured here), so the
    case is held to ``INT8_TOL``, well inside the reference's int8
    bands (loss 5e-3, params 1e-2)."""
    hold_draws(run)
    spread = _jax_int8_spread(run, tmp)
    assert spread["params"] > 1e2 * ATOL  # the quantizers' sensitivity
    got, want = run["ranks"][0], run["jax"]
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= INT8_TOL[k] * abs(b[k]), (k, a, b)
    worst = max(float(np.abs(got["params"][k] - np.asarray(w)).max())
                for k, w in want["params"].items())
    assert worst <= INT8_TOL["params"], (worst, spread)


def hold_block_order(run: dict):
    """Every rank gathered its blocks' split params in the forward,
    block k's gather posted once block k - 1 - prefetch had run and
    waited for just before block k."""
    p = run["one_cfg"].parallel.fsdp_prefetch
    for r in run["ranks"]:
        g = r["gathers"]
        assert g["names"] and g["gathers"] > 0
        ev = g["events"]
        runs_at = {k: i for i, (e, k) in enumerate(ev) if e == "run"}
        for i, (e, k) in enumerate(ev):
            if e == "post" and k - 1 - p >= 0:
                assert runs_at[k - 1 - p] < i, (k, ev)
            if e == "post":
                assert i < runs_at[k]
        assert sorted(runs_at) == list(range(len(runs_at)))
