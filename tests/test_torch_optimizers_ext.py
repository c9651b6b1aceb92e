"""The port's ``adam``, ``lion`` and ``adafactor`` (frl_distributed_ml_
scaffold_tpu_torch/trainer/optimizers.py) against optax through the JAX
package's factory, on the same numpy params and gradients; the
``gpt2_medium_adafactor`` recipe against the JAX one; three steps of
``make_train_step`` with adafactor against the JAX step; and an
adafactor save and resume through the port's ``Trainer``.

Leaves: factored (both large dims at least 128, 2-d and 3-d), one dim
below 128 (unfactored), a vector and a tiny matrix.

Tolerances:
- fp32 params: 1e-6 absolute on params of unit scale after three steps
  (fp32 elementwise math and reductions in another order; measured
  7.2e-7 for adam, 2.4e-7 for lion and adafactor).
- bf16 params (the state in bf16 too, as optax makes it): XLA keeps fp32
  inside its fusions and rounds the update to bf16, the port rounds each
  stored tensor once, so a step near a sign or rounding boundary goes
  the other way. Each element is held within 2 bf16 ulps of optax's plus
  the most a disagreeing update of unit size can move it, twice the sum
  of the learning rates applied (measured: up to 0.07 of that sum, 0.7
  for lion, whose sign flips where its interpolation nears 0), and the
  mean difference under 1 % of that bound.
- The train step: loss and grad_norm to 1e-5 relative, params to 1e-6
  absolute (fp32, as ``test_torch_train_step.py``), but the key bias
  (ROADMAP C.7), held to the most its noise-driven steps can move it.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import TINY, jax_params

from frl_distributed_ml_scaffold_tpu.config import recipes as jrecipes
from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JaxGPT
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu.trainer import optimizers as jopt
from frl_distributed_ml_scaffold_tpu.trainer import tasks as jtasks
from frl_distributed_ml_scaffold_tpu.trainer import train_state as jstate
from frl_distributed_ml_scaffold_tpu.trainer import train_step as jstep
from frl_distributed_ml_scaffold_tpu_torch.config import (
    apply_overrides,
    get_config,
)
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
from frl_distributed_ml_scaffold_tpu_torch.models.convert import params_from_jax
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import optimizers as topt
from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
    make_train_step,
)
from frl_distributed_ml_scaffold_tpu_torch.utils.trees import tree_leaves

SHAPES = {"f": (128, 160), "f3": (3, 130, 128), "u": (127, 200),
          "b": (5,), "s": (2, 3)}
STEPS = 3


def _run_both(opt_kw, dtype: str, seed: int = 0, scale: float = 1.0):
    """``STEPS`` updates of the port's optimizer and the JAX factory's
    from the same params and gradients in ``dtype``; returns (port
    params, optax params, port state, optax state)."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    trainer = dict(total_steps=10)
    jtx, _ = jopt.make_optimizer(jschema.OptimizerConfig(**opt_kw),
                                 jschema.TrainerConfig(**trainer))
    ttx, _ = topt.make_optimizer(tschema.OptimizerConfig(**opt_kw),
                                 tschema.TrainerConfig(**trainer), None)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = {k: jnp.asarray(v).astype(jd) for k, v in params.items()}
    jst = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).to(td) for k, v in params.items()}
    tst = ttx.init(tp)
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jd) for k, v in g.items()}
        updates, jst = jtx.update(jg, jst, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.update({k: torch.from_numpy(v).to(td) for k, v in g.items()},
                   tst, tp)
    return tp, jp, tst, jst


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _hold(tp, jp, dtype: str, lr_sum: float = 0.0):
    for k in SHAPES:
        got = tp[k].float().numpy()
        want = np.asarray(jp[k].astype(jnp.float32))
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=k)
            continue
        diff = np.abs(got - want)
        bound = 2 * lr_sum
        assert (diff <= 2 * _bf16_ulp(want) + bound).all(), (k, diff.max())
        assert diff.mean() <= 0.01 * bound, (k, diff.mean(), bound)


OPTS = ["adam", "lion", "adafactor"]


@pytest.mark.parametrize("decay_clip", [False, True],
                         ids=["plain", "wd_clip"])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear", "wsd"])
@pytest.mark.parametrize("name", OPTS)
def test_optimizer_matches_optax_fp32(name, schedule, decay_clip):
    """Three fp32 steps of adam / lion / adafactor under every schedule
    with a 1-step warmup, with and without weight decay (adafactor's
    decoupled decay, lion's built-in one; adam has none) and the
    global-norm clip (gradients of norm ~30 against a clip of 1)."""
    kw = dict(name=name, learning_rate=1e-2, schedule=schedule,
              warmup_steps=1, wsd_decay_fraction=0.5)
    if decay_clip:
        kw.update(weight_decay=0.1, grad_clip_norm=1.0)
    tp, jp, tst, _ = _run_both(kw, "fp32")
    _hold(tp, jp, "fp32")
    assert tst["count"] == STEPS


@pytest.mark.parametrize("decay_clip", [False, True],
                         ids=["plain", "wd_clip"])
@pytest.mark.parametrize("name", OPTS + ["adamw", "sgd"])
def test_optimizer_matches_optax_bf16_params(name, decay_clip):
    """bf16 params: the state takes the params' dtype, as optax makes
    it, and the params stay bf16 within the bf16 tolerance."""
    kw = dict(name=name, learning_rate=1e-2, schedule="cosine",
              warmup_steps=1, momentum=0.9)
    if decay_clip:
        kw.update(weight_decay=0.1, grad_clip_norm=1.0)
    tp, jp, tst, jst = _run_both(kw, "bf16", seed=1)
    sched = topt.make_schedule(tschema.OptimizerConfig(**kw), 10)
    _hold(tp, jp, "bf16", sum(sched(c) for c in range(STEPS)))
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16, k
    want = {str(x.dtype) for x in jax.tree.leaves(jst)
            if getattr(x, "ndim", 0) > 0}
    got = {str(x.dtype).replace("torch.", "") for x in tree_leaves(tst)
           if isinstance(x, torch.Tensor)}
    assert got == want == {"bfloat16"}, (got, want)


def test_default_b2_is_each_optimizers_own():
    """b2 unset: lion's 0.99, adam's 0.999; an explicit 0.999 is kept."""
    tr = tschema.TrainerConfig()
    lion, _ = topt.make_optimizer(tschema.OptimizerConfig(name="lion"), tr,
                                  None)
    adam, _ = topt.make_optimizer(tschema.OptimizerConfig(name="adam"), tr,
                                  None)
    assert (lion.b2, adam.b2, adam.weight_decay) == (0.99, 0.999, 0.0)
    lion, _ = topt.make_optimizer(
        tschema.OptimizerConfig(name="lion", b2=0.999), tr, None)
    assert lion.b2 == 0.999
    tp, jp, _, _ = _run_both(dict(name="lion", learning_rate=3e-3), "fp32",
                             seed=2)
    _hold(tp, jp, "fp32")


def test_adafactor_state_is_optax_factored_state():
    """The factored leaves keep [row] and [col] moments and a (1,)
    placeholder; the others a param-shaped v: optax's shapes, leaf by
    leaf, and its decay, eps and clip defaults (not cfg.eps)."""
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    jtx, _ = jopt.make_optimizer(
        jschema.OptimizerConfig(name="adafactor", eps=1e-3),
        jschema.TrainerConfig())
    jst = next(x for x in jax.tree.leaves(
        jtx.init(jax.tree.map(jnp.asarray, params)),
        is_leaf=lambda x: hasattr(x, "v_row")) if hasattr(x, "v_row"))
    ttx, _ = topt.make_optimizer(
        tschema.OptimizerConfig(name="adafactor", eps=1e-3),
        tschema.TrainerConfig(), None)
    tst = ttx.init({k: torch.from_numpy(v) for k, v in params.items()})
    for leaf in ("v_row", "v_col", "v"):
        for k in SHAPES:
            assert tuple(tst[leaf][k].shape) == getattr(jst, leaf)[k].shape, (
                leaf, k)
    assert tst["v"]["f"].shape == (1,) and tst["v"]["u"].shape == (127, 200)
    # eps 1e-3 in the config changes nothing: optax's 1e-30 is used.
    tp, jp, _, _ = _run_both(dict(name="adafactor", learning_rate=1e-2,
                                  eps=1e-3), "fp32", seed=3, scale=1e-4)
    _hold(tp, jp, "fp32")


def test_gpt2_medium_adafactor_recipe_matches_jax():
    t = get_config("gpt2_medium_adafactor")
    j = jrecipes.gpt2_medium_adafactor()
    assert t.name == j.name
    for section in ("model", "data", "trainer", "optimizer", "mesh",
                    "parallel", "precision", "checkpoint", "serving"):
        assert dataclasses.asdict(getattr(t, section)) == (
            dataclasses.asdict(getattr(j, section))), section
    assert (t.optimizer.name, t.optimizer.learning_rate,
            t.optimizer.weight_decay) == ("adafactor", 1e-2, 0.0)


@pytest.mark.parametrize("recipe", ["gpt2_medium_zero1", "imagenet_rn50_ddp",
                                    "imagenet_vitb_fsdp", "mnist_mlp"])
def test_adafactor_groups_the_model_configs_jax_leaves(recipe):
    """``make_optimizer`` takes the model config, and Adafactor reduces
    over that family's JAX leaves: a GPT's layers of one block parameter
    form one leaf (the JAX GPT scans its blocks); the ResNet's, ViT's and
    MLP's parameters, and a plain dict's (None), are each their own."""
    cfg = get_config(recipe)
    opt = tschema.OptimizerConfig(name="adafactor")
    tx, _ = topt.make_optimizer(opt, cfg.trainer, cfg.model)
    plain, _ = topt.make_optimizer(opt, cfg.trainer, None)
    names = ["blocks.0.attn.qkv.weight", "blocks.11.attn.qkv.weight",
             "wte.weight"]
    want = ["blocks.attn.qkv.weight"] * 2 + ["wte.weight"]
    if cfg.model.family != "gpt":
        want = names
    assert [tx.leaf_of(k) for k in names] == want
    assert [plain.leaf_of(k) for k in names] == names


def test_adafactor_train_steps_match_jax():
    """Three steps of ``make_train_step`` with adafactor (the recipe's
    lr 1e-2, a 2-step warmup into a cosine, the clip, decay, grad_accum
    2) on the tiny GPT, fp32, against the JAX step: loss and grad_norm
    per step, every param after the last. The JAX GPT stacks its layers
    into one leaf, so the block RMS runs over ``stacked_name``'s
    groups, which ``make_optimizer`` reads from the model config."""
    opt = dict(name="adafactor", learning_rate=1e-2, warmup_steps=2,
               schedule="cosine", grad_clip_norm=1.0, weight_decay=0.05)
    trainer = dict(total_steps=10, grad_accum=2)
    data = SyntheticLM(tschema.DataConfig(
        name="lm_synthetic", global_batch_size=4, seq_len=TINY["seq_len"],
        vocab_size=TINY["vocab_size"]), split="train")
    batches = [data.batch(s, 4) for s in range(3)]
    params = jax_params()
    jmodel = JaxGPT(jschema.GPTConfig(**TINY), jax_policy("fp32"))
    jtx, _ = jopt.make_optimizer(jschema.OptimizerConfig(**opt),
                                 jschema.TrainerConfig(**trainer))
    js = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), jtx)
    jfn = jax.jit(jstep.make_train_step(jtasks.make_lm_loss(jmodel), jtx,
                                        jax_policy("fp32"), grad_accum=2))
    cfg = tschema.GPTConfig(**TINY)
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    ttx, _ = topt.make_optimizer(tschema.OptimizerConfig(**opt),
                                 tschema.TrainerConfig(**trainer), cfg)
    ts = TrainState.create(dict(model.named_parameters()), ttx, device="cpu")
    tfn = make_train_step(ttasks.make_lm_loss(model), ttx, get_policy("fp32"),
                          grad_accum=2, device="cpu")
    for batch in batches:
        js, jm = jfn(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tfn(ts, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    want = params_from_jax(jax.device_get(js.params), cfg)
    # The key bias's exact gradient is 0 (ROADMAP C.7): its update is
    # rounding noise normalised by its own RMS in both frameworks, at
    # most sqrt(n) of the clipped block RMS times lr times its parameter
    # scale (1e-3: it stays near its zero init), over n = L * d.
    noise = 2 * 1.5e-2 * 1e-3 * math.sqrt(TINY["num_layers"]
                                          * TINY["hidden_dim"])
    for name, w in want.items():
        atol = noise if name.endswith("attn.key.bias") else 1e-6
        np.testing.assert_allclose(ts.params[name].numpy(), w.numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def test_adafactor_save_and_resume_is_bit_equal(tmp_path):
    """mnist_mlp with adafactor (a 128-wide hidden layer, so its kernels
    are factored): a fit of 6 steps with a save every 2, then a resume
    from step 4 to 6: the resumed state equals the uninterrupted one bit
    for bit, the factored v_row / v_col leaves included."""
    ov = ["model.hidden_sizes=128", "data.global_batch_size=8",
          "trainer.total_steps=6", "trainer.log_every=1",
          "trainer.eval_every=0", "optimizer.name=adafactor",
          "optimizer.learning_rate=1e-2", "optimizer.weight_decay=0.01",
          "checkpoint.enabled=true", "checkpoint.save_every=2",
          "checkpoint.async_save=false"]
    full = Trainer(apply_overrides(get_config("mnist_mlp"),
                                   ov + [f"workdir={tmp_path / 'a'}"]),
                   device="cpu")
    state_a, _ = full.fit()
    assert state_a.opt_state["v_row"]["dense.0.weight"].shape == (128,)
    assert state_a.opt_state["v_col"]["dense.0.weight"].shape == (784,)
    cfg_b = apply_overrides(get_config("mnist_mlp"),
                            ov + [f"workdir={tmp_path / 'b'}"])
    first = Trainer(cfg_b, device="cpu")
    first.fit(num_steps=4)
    resumed = Trainer(cfg_b, device="cpu")
    state_b, _ = resumed.fit()
    assert state_b.step == state_a.step == 6
    la = list(tree_leaves(state_a.params)) + list(tree_leaves(
        state_a.opt_state))
    lb = list(tree_leaves(state_b.params)) + list(tree_leaves(
        state_b.opt_state))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
