"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

One tiny GPT config (2 layers, d=128, 4 heads so head_dim is 32 and the
JAX decode kernel really runs, vocab 512, 128 context), initialised ONCE
in the JAX package and carried into the port with ``params_from_jax``;
and the JAX ResNet's variables, carried across with
``resnet_params_from_jax``.
"""

from __future__ import annotations

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np

from _jit import jit_init

from frl_distributed_ml_scaffold_tpu.config.schema import GPTConfig as JaxGPTConfig
from frl_distributed_ml_scaffold_tpu.config.schema import (
    ResNetConfig as JaxResNetConfig,
)
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JaxGPT
from frl_distributed_ml_scaffold_tpu.models.resnet import ResNet as JaxResNet
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
from frl_distributed_ml_scaffold_tpu_torch.models.convert import params_from_jax
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

TINY = dict(
    vocab_size=512, num_layers=2, num_heads=4, hidden_dim=128, seq_len=128,
)

jax_decode_attention = importlib.import_module(
    "frl_distributed_ml_scaffold_tpu.ops.decode_attention"
)


def jax_params():
    """The JAX model's params (numpy leaves; fp32 under every policy)."""
    model = JaxGPT(JaxGPTConfig(**TINY), jax_policy("fp32"))
    variables = jit_init(model, jnp.zeros((1, 8), jnp.int32), train=False)
    return jax.device_get(variables["params"])


def build_pair(params, policy: str, **model):
    """(JAX GPT, port GPT on the CPU carrying ``params``) under ``policy``;
    ``model`` overrides fields of both configs (``kv_cache_quant=...``)."""
    jmodel = JaxGPT(JaxGPTConfig(**TINY, **model), jax_policy(policy))
    cfg = GPTConfig(**TINY, **model)
    tmodel = GPT(cfg, get_policy(policy), device="cpu")
    tmodel.load_state_dict(params_from_jax(params, cfg))
    return jmodel, tmodel


@contextlib.contextmanager
def pallas_interpret():
    """Route the JAX package's decode attention through its Pallas kernel
    in interpret mode (its own tests' hook)."""
    jax_decode_attention.FORCE_INTERPRET = True
    try:
        yield
    finally:
        jax_decode_attention.FORCE_INTERPRET = None


def jax_resnet_variables(depth: int, num_classes: int, image: int,
                         seed: int = 0, spread: float | None = 0.3,
                         **model) -> dict:
    """The JAX ResNet's variables (numpy leaves, fp32, ``model.fused_bn``
    off). Unless ``spread`` is None, every BatchNorm's scale (1 + spread
    N(0, 1)), bias and running mean (spread / 3 N(0, 1)) and running var
    (U(0.5, 1.5)) are drawn from a numpy seed: the init's zero scale on
    each block's last BatchNorm would leave every residual branch out of
    a forward comparison. ``model`` sets other ResNetConfig fields
    (``stem="s2d"``)."""
    model = JaxResNet(JaxResNetConfig(depth=depth, num_classes=num_classes,
                                      **model), jax_policy("fp32"))
    variables = jax.device_get(jit_init(
        model, jnp.zeros((1, image, image, 3), jnp.float32), train=False))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "scale":
                out[k] = (1 + spread * rng.standard_normal(v.shape)).astype(
                    np.float32)
            elif k in ("bias", "mean"):
                out[k] = (spread / 3 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    if spread is None:
        return jax.tree.map(np.asarray, dict(variables))
    return {"params": perturb(variables["params"]),
            "batch_stats": perturb(variables["batch_stats"])}


def fused_names(tree):
    """A ResNet tree with flax's ``BatchNorm_i`` module names as
    ``FusedBatchNorm_i``, the names the JAX model gives them under
    ``model.fused_bn``."""
    if not isinstance(tree, dict):
        return tree
    return {(f"Fused{k}" if k.startswith("BatchNorm_") else k): fused_names(v)
            for k, v in tree.items()}


# ViT, video classifier and MLP: tiny configs cut from the recipes by
# the same overrides in both packages, and the train-step trajectories of
# both packages over the same batches.

TINY_VIT = ["model.image_size=32", "model.patch_size=8",
            "model.hidden_dim=64", "model.num_layers=2", "model.num_heads=4",
            "model.num_classes=10", "data.image_size=32",
            "data.num_classes=10"]
TINY_VIDEO = ["model.image_size=32", "model.num_frames=4",
              "model.tubelet_size=2,8,8", "model.hidden_dim=64",
              "model.num_layers=2", "model.num_heads=4",
              "model.num_classes=10", "data.image_size=32",
              "data.num_frames=4", "data.num_classes=10"]
# Three steps: lr 0 (warmup), then the cosine's first two.
TINY_TRAIN = ["optimizer.warmup_steps=1", "trainer.total_steps=10"]
# Logits relative to max(1, max|ref|), and ``hold_train``'s limits, of
# the ViT, video and MLP parity tests (their docstrings give the
# differences measured).
LOGIT_TOL = {"fp32": 1e-5, "bf16_mixed": 3e-2}
TRAIN_TOL = {
    "fp32": dict(loss=3e-5, grad_norm=3e-5, param_max=1e-5, param_mean=1e-6),
    "bf16_mixed": dict(loss=2e-2, grad_norm=2e-2, param_max=None,
                       param_mean=0.05),
}


def recipe_pair(name: str, overrides: list) -> tuple:
    """(JAX config, port config) of recipe ``name`` under ``overrides``."""
    from frl_distributed_ml_scaffold_tpu.config import recipes as jrecipes
    from frl_distributed_ml_scaffold_tpu.config.core import (
        apply_overrides as japply,
    )
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig

    return (japply(getattr(jrecipes, name)(), overrides),
            tconfig.apply_overrides(tconfig.get_config(name), overrides))


def jax_init_perturbed(model, example, seed: int = 0,
                       spread: float = 0.1) -> dict:
    """The JAX model's fp32 params (numpy leaves) with ``spread`` N(0, 1)
    from a numpy seed added to every bias, LayerNorm scale and cls token,
    so the zero and unit inits take part in a comparison."""
    params = jax.device_get(jit_init(model, jnp.asarray(example))["params"])
    rng = np.random.default_rng(seed)

    def perturb(path, v):
        v = np.asarray(v)
        if path[-1].key in ("bias", "scale", "cls_token"):
            v = v + spread * rng.standard_normal(v.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, params)


def jax_train(cfg, model, params, batches) -> dict:
    """The JAX train step's trajectory under ``cfg``'s optimizer,
    schedule, remat and policy: per-step metrics and lr, and the final
    params (numpy leaves)."""
    from frl_distributed_ml_scaffold_tpu.trainer import optimizers as jopt
    from frl_distributed_ml_scaffold_tpu.trainer import tasks as jtasks
    from frl_distributed_ml_scaffold_tpu.trainer import train_state as jstate
    from frl_distributed_ml_scaffold_tpu.trainer import train_step as jstep

    tx, schedule = jopt.make_optimizer(cfg.optimizer, cfg.trainer)
    state = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), tx)
    step = jax.jit(jstep.make_train_step(
        jtasks.make_loss_fn(model, cfg.data.name), tx,
        jax_policy(cfg.precision.policy), remat=cfg.trainer.remat))
    out = {"metrics": [], "lr": []}
    for s, batch in enumerate(batches):
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        out["metrics"].append({k: float(x) for k, x in m.items()})
        out["lr"].append(float(schedule(s)))
    out["params"] = jax.device_get(state.params)
    return out


def port_train(cfg, model, sd: dict, batches) -> dict:
    """The port's train step from the state dict ``sd`` on the CPU, as
    ``jax_train``; ``params`` are the port's final params by name."""
    from frl_distributed_ml_scaffold_tpu_torch.trainer import optimizers as topt
    from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_train_step,
    )

    tx, schedule = topt.make_optimizer(cfg.optimizer, cfg.trainer,
                                       cfg.model)
    state = TrainState.create(sd, tx, device="cpu")
    step = make_train_step(
        ttasks.make_loss_fn(model, cfg.data.name), tx,
        get_policy(cfg.precision.policy), remat=cfg.trainer.remat,
        mesh=cfg.mesh, parallel=cfg.parallel, device="cpu")
    out = {"metrics": [], "lr": []}
    for s, batch in enumerate(batches):
        state, m = step(state, batch)
        out["metrics"].append({k: float(x) for k, x in m.items()})
        out["lr"].append(schedule(s))
    out["params"] = state.params
    out["state"] = state
    return out


# Leaves whose exact gradient is 0 (the softmax ignores a per-query
# constant): rounding noise that Adam normalises, so held to Adam's bound
# only, under every policy.
ZERO_GRAD = (".attn.key.bias",)


def hold_train(got: dict, ref: dict, *, loss: float, grad_norm: float,
               param_max: float | None, param_mean: float) -> dict:
    """``got`` (port) against ``ref`` (JAX, params already in the port's
    names): lr per step to 1e-6, loss and grad_norm relative, accuracies
    equal where ``loss`` is below 1e-4 (fp32), every param's largest and
    mean absolute difference. ``param_max=None`` holds each param to
    Adam's bound, twice the summed lr, and ``param_mean`` is then a
    fraction of that bound; ``ZERO_GRAD`` leaves are held to that bound
    alone. Returns the largest differences seen."""
    np.testing.assert_allclose(got["lr"], ref["lr"], rtol=1e-6, atol=1e-9)
    seen = {"loss": 0.0, "grad_norm": 0.0, "param_max": 0.0,
            "param_mean": 0.0}
    for g, r in zip(got["metrics"], ref["metrics"]):
        assert g.keys() == r.keys()
        for k in ("loss", "grad_norm"):
            seen[k] = max(seen[k], abs(g[k] - r[k]) / abs(r[k]))
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=loss)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=grad_norm)
        if loss < 1e-4:
            for k in g.keys() - {"loss", "grad_norm"}:
                assert g[k] == r[k], k
    bound = 2 * sum(ref["lr"]) + 1e-6
    if param_max is None:
        param_max, param_mean = bound, param_mean * bound
    assert got["params"].keys() == ref["params"].keys()
    for name, want in ref["params"].items():
        diff = (got["params"][name] - want).abs()
        if name.endswith(ZERO_GRAD):
            assert float(diff.max()) <= bound, (name, float(diff.max()))
            continue
        seen["param_max"] = max(seen["param_max"], float(diff.max()))
        seen["param_mean"] = max(seen["param_mean"], float(diff.mean()))
        assert float(diff.max()) <= param_max, (name, float(diff.max()))
        assert float(diff.mean()) <= param_mean, (name, float(diff.mean()))
    return seen
