"""The port's ResNet training step (models/resnet.py, ops/fused_bn.py,
ops/fused_adamw.py, trainer/) held against the JAX package's train step
on the same carried-across variables and the same ``SyntheticImages``
batches: three optimizer steps of ``grad_accum=2`` (the BatchNorm
statistics threaded through the microbatches) of a depth-10 ResNet at
32 px, under fp32 and bf16_mixed, ``model.fused_bn`` off and on, with
the recipe's SGD (nesterov momentum, weight decay) and with
``fused_adamw``, each after a one-step warmup into a cosine schedule.

The JAX step runs its fused BatchNorm through its default CPU route,
``_fallback_bwd``, the kernels' math; one test runs it through the
Pallas kernels in interpret mode (``fused_bn.FORCE_INTERPRET``, restored
after). The port's fused path takes its plain versions on the CPU.

Tolerances, set from the largest difference of the eight runs measured
here (the variables are the JAX init's, each block's last BatchNorm
scale 0):
- loss 1e-5 relative in fp32 (measured 1.0e-6), 1e-2 under bf16_mixed
  (1.8e-3: the frameworks round bf16 at other places, convolution
  outputs and the head's fused bias add among them); ``grad_norm`` 1e-5
  / 2e-2 (4.3e-7 / 4.2e-3); accuracies equal in fp32;
- running statistics, relative to max(1, max|ref|): SGD fp32 1e-4
  (4.8e-6); everything else 1e-2 (1.6e-4 fp32 AdamW, 2.3e-3 bf16): the
  params they are taken under differ as below;
- params after three steps: SGD fp32 1e-6 absolute (1.2e-7); SGD
  bf16_mixed 1e-2 (2.3e-3) with the mean under 1e-3 (3.4e-4). AdamW's
  early steps are about lr sign(g), so a gradient within rounding of 0
  moves a param by up to lr one way in one framework and the other way
  in the other: each param is held to twice the summed lr (measured
  1.4e-3 fp32, 3.7e-3 bf16, against 3.9e-3), and the mean to 10 % of
  that in fp32 and 50 % under bf16_mixed (measured 3 % and 24 %). In
  fp32 the worst are the biases of the stem's and block 0's last
  BatchNorm: they reach the next BatchNorm nearly as a per-channel
  shift, which it removes, so their gradients are rounding-sized.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fused_names, jax_resnet_variables

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.models.resnet import ResNet as JaxResNet
from frl_distributed_ml_scaffold_tpu.ops import fused_bn as jbn
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu.trainer import optimizers as jopt
from frl_distributed_ml_scaffold_tpu.trainer import tasks as jtasks
from frl_distributed_ml_scaffold_tpu.trainer import train_state as jstate
from frl_distributed_ml_scaffold_tpu.trainer import train_step as jstep
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticImages
from frl_distributed_ml_scaffold_tpu_torch.models import create_model
from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
    resnet_params_from_jax,
)
from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as tfa
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import optimizers as topt
from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
    make_train_step,
)

DEPTH, CLASSES, IMAGE, BATCH, ACCUM, STEPS = 10, 10, 64, 8, 2, 3
OPT = {
    "sgd": dict(name="sgd", learning_rate=0.02, momentum=0.9,
                weight_decay=1e-4, schedule="cosine", warmup_steps=1),
    "fused_adamw": dict(name="fused_adamw", learning_rate=1e-3,
                        weight_decay=1e-4, schedule="cosine",
                        warmup_steps=1),
}
TRAINER = dict(total_steps=10, grad_accum=ACCUM)
DATA = dict(name="imagenet", global_batch_size=BATCH, image_size=IMAGE,
            channels=3, num_classes=CLASSES)
TOL = {"fp32": dict(loss=1e-5, grad_norm=1e-5), "bf16_mixed": dict(
    loss=1e-2, grad_norm=2e-2)}
# (stats relative, param max absolute or None for the Adam bound, param
# mean absolute or as a fraction of the Adam bound) by (policy, opt).
STATE_TOL = {
    ("fp32", "sgd"): (1e-4, 1e-6, 1e-6),
    ("bf16_mixed", "sgd"): (1e-2, 1e-2, 1e-3),
    ("fp32", "fused_adamw"): (1e-2, None, 0.1),
    ("bf16_mixed", "fused_adamw"): (1e-2, None, 0.5),
}


def _batches():
    data = SyntheticImages(tschema.DataConfig(**DATA), split="train")
    return [data.batch(s, BATCH) for s in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _variables():
    return jax_resnet_variables(DEPTH, CLASSES, IMAGE, spread=None)


def _configs(opt, fused):
    model = dict(depth=DEPTH, num_classes=CLASSES, fused_bn=fused)
    return ((jschema.ResNetConfig(**model), jschema.OptimizerConfig(**OPT[opt]),
             jschema.TrainerConfig(**TRAINER)),
            (tschema.ResNetConfig(**model), tschema.OptimizerConfig(**OPT[opt]),
             tschema.TrainerConfig(**TRAINER)))


@functools.lru_cache(maxsize=None)
def _reference(policy, opt, fused, steps=STEPS, accum=ACCUM):
    """The JAX train step's trajectory: per-step metrics and lr, and the
    final params and statistics in the port's names."""
    (mcfg, ocfg, tcfg), _ = _configs(opt, fused)
    v = _variables()
    if fused:
        v = {k: fused_names(t) for k, t in v.items()}
    model = JaxResNet(mcfg, jax_policy(policy))
    tx, schedule = jopt.make_optimizer(ocfg, tcfg)
    state = jstate.TrainState.create(
        jax.tree.map(jnp.asarray, v["params"]), tx,
        {"batch_stats": jax.tree.map(jnp.asarray, v["batch_stats"])})
    step = jax.jit(jstep.make_train_step(
        jtasks.make_loss_fn(model, "imagenet"), tx, jax_policy(policy),
        grad_accum=accum))
    out = {"metrics": [], "lr": []}
    for s, batch in enumerate(_batches()[:steps]):
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        out["metrics"].append({k: float(x) for k, x in m.items()})
        out["lr"].append(float(schedule(s)))
    out["params"], extras = resnet_params_from_jax(
        jax.device_get(state.params),
        jax.device_get(state.extras["batch_stats"]))
    out["stats"] = extras["batch_stats"]
    return out


def _port_run(policy, opt, fused, steps=STEPS, accum=ACCUM):
    _, (mcfg, ocfg, tcfg) = _configs(opt, fused)
    v = _variables()
    params, extras = resnet_params_from_jax(v["params"], v["batch_stats"])
    model = create_model(mcfg, get_policy(policy), device="cpu")
    model.load_state_dict({**params, **extras["batch_stats"]})
    tx, schedule = topt.make_optimizer(ocfg, tcfg, mcfg)
    state = TrainState.create(params, tx, extras, device="cpu")
    step = make_train_step(ttasks.make_loss_fn(model, "imagenet"), tx,
                           get_policy(policy), grad_accum=accum, device="cpu")
    out = {"metrics": [], "lr": []}
    for s, batch in enumerate(_batches()[:steps]):
        state, m = step(state, batch)
        out["metrics"].append({k: float(x) for k, x in m.items()})
        out["lr"].append(schedule(s))
    out["params"] = state.params
    out["stats"] = state.extras["batch_stats"]
    out["state"] = state
    return out


def _hold(got, ref, policy, opt):
    tol = TOL[policy]
    np.testing.assert_allclose(got["lr"], ref["lr"], rtol=1e-6, atol=1e-9)
    for g, r in zip(got["metrics"], ref["metrics"]):
        assert g.keys() == r.keys()
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=tol["loss"])
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=tol["grad_norm"])
        if policy == "fp32":
            for k in ("accuracy", "accuracy_top5"):
                assert g[k] == r[k], k
    stats_tol, p_max, p_mean = STATE_TOL[policy, opt]
    assert got["stats"].keys() == ref["stats"].keys()
    for name, want in ref["stats"].items():
        err = float((got["stats"][name] - want).abs().max())
        assert err <= stats_tol * max(1.0, float(want.abs().max())), (
            name, err)
    if p_max is None:  # Adam: two frameworks' steps of lr, opposite ways
        p_max = 2 * sum(ref["lr"]) + 1e-6
        p_mean *= p_max
    assert got["params"].keys() == ref["params"].keys()
    for name, want in ref["params"].items():
        diff = (got["params"][name] - want).abs()
        assert float(diff.max()) <= p_max, (name, float(diff.max()), p_max)
        assert float(diff.mean()) <= p_mean, (name, float(diff.mean()),
                                              p_mean)


@pytest.mark.parametrize("opt", ["sgd", "fused_adamw"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain_bn", "fused_bn"])
@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_train_steps_match_jax(policy, fused, opt):
    """Three steps against the JAX step: loss, accuracy, top-5 accuracy,
    grad_norm and lr per step; every param and running statistic after
    the last."""
    got = _port_run(policy, opt, fused)
    _hold(got, _reference(policy, opt, fused), policy, opt)
    assert got["state"].step == STEPS
    assert got["state"].opt_state["count"] == STEPS


def test_train_step_matches_jax_through_the_pallas_kernels():
    """One step of the fused path against the JAX step with its fused
    BatchNorm run through the Pallas sums and dx kernels in interpret
    mode (``FORCE_INTERPRET``, restored after), fp32, SGD."""
    jbn.FORCE_INTERPRET = True
    try:
        ref = _reference.__wrapped__("fp32", "sgd", True, steps=1, accum=1)
    finally:
        jbn.FORCE_INTERPRET = None
    _hold(_port_run("fp32", "sgd", True, steps=1, accum=1), ref, "fp32",
          "sgd")


def test_first_step_under_warmup_moves_stats_not_params():
    """lr(0) is 0 under warmup: step 0 leaves every param as it was while
    every running statistic moves; step 1 moves the params."""
    _, (mcfg, ocfg, tcfg) = _configs("sgd", True)
    v = _variables()
    params, extras = resnet_params_from_jax(v["params"], v["batch_stats"])
    model = create_model(mcfg, get_policy("fp32"), device="cpu")
    model.load_state_dict({**params, **extras["batch_stats"]})
    tx, schedule = topt.make_optimizer(ocfg, tcfg, mcfg)
    state = TrainState.create(params, tx, extras, device="cpu")
    step = make_train_step(ttasks.make_loss_fn(model, "imagenet"), tx,
                           get_policy("fp32"), device="cpu")
    batches = _batches()
    state, _ = step(state, batches[0])
    assert schedule(0) == 0.0
    assert all(torch.equal(state.params[k], p) for k, p in params.items())
    assert all(not torch.equal(state.extras["batch_stats"][k], s)
               for k, s in extras["batch_stats"].items())
    state, _ = step(state, batches[1])
    assert any(not torch.equal(state.params[k], p) for k, p in params.items())


def test_fused_adamw_refusals():
    """``fused_adamw`` is refused with a grad clip (by the factory) and
    under sharded state or a model, expert or pipe axis above 1 (where
    the step is built), with the JAX package's messages."""
    with pytest.raises(ValueError, match="grad_clip_norm"):
        topt.make_optimizer(tschema.OptimizerConfig(
            **dict(OPT["fused_adamw"], grad_clip_norm=1.0)),
            tschema.TrainerConfig(**TRAINER), None)
    tx, _ = topt.make_optimizer(tschema.OptimizerConfig(**OPT["fused_adamw"]),
                                tschema.TrainerConfig(**TRAINER), None)
    assert isinstance(tx, tfa.FusedAdamW)
    loss = lambda *a: None  # noqa: E731 (never called)
    pol = get_policy("fp32")
    for kw in ({"parallel": tschema.ParallelConfig(opt_sharding="zero1")},
               {"parallel": tschema.ParallelConfig(param_sharding="fsdp")},
               {"mesh": tschema.MeshConfig(model=2)},
               {"mesh": tschema.MeshConfig(expert=2)},
               {"mesh": tschema.MeshConfig(pipe=2)}):
        with pytest.raises(ValueError, match="requires replicated state"):
            make_train_step(loss, tx, pol, device="cpu", **kw)
    make_train_step(loss, tx, pol, device="cpu",
                    mesh=tschema.MeshConfig(data=-1),
                    parallel=tschema.ParallelConfig())
    # The same layouts under SGD are one card's replicated state.
    sgd, _ = topt.make_optimizer(tschema.OptimizerConfig(**OPT["sgd"]),
                                 tschema.TrainerConfig(**TRAINER), None)
    make_train_step(loss, sgd, pol, device="cpu",
                    parallel=dataclasses.replace(tschema.ParallelConfig(),
                                                 opt_sharding="zero1"))
