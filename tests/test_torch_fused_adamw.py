"""The port's fused AdamW (frl_distributed_ml_scaffold_tpu_torch/ops/
fused_adamw.py) and SGD (trainer/optimizers.py) against the JAX package's
``ops/fused_adamw.py`` and the optax chains its factory builds, on the
CPU, inputs from a numpy seed.

- ``update_leaf`` (``adamw_math`` on the CPU) against the Pallas
  ``_update_leaf`` in interpret mode, leaves above and below the kernel's
  65536-element minimum (one ragged);
- ``FusedAdamW`` against JAX ``fused_adamw``'s ``fused_apply`` over 3
  steps of a warmup + cosine schedule with weight decay: params and both
  moments; and over 3 steps of bf16 gradients, the JAX kernel in
  interpret mode;
- ``SGD`` (``optimizer.name=sgd``: weight decay, nesterov momentum) and
  its clip against the JAX factory's optax chain;
- the factory's refusals.

Tolerances: 1e-6 absolute on params and moments of unit scale or below
(fp32 elementwise math; lr and the bias corrections are host doubles
here and fp32 there, 1e-7 relative apart).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.ops import fused_adamw as jfa
from frl_distributed_ml_scaffold_tpu.trainer import optimizers as jopt
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as tfa
from frl_distributed_ml_scaffold_tpu_torch.trainer import optimizers as topt

ATOL = 1e-6
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
# Leaves: two below the kernel's minimum, one at it, one ragged above it.
SHAPES = {"bias": (64,), "small": (7, 33), "min": (512, 128),
          "ragged": (3, 5, 4373)}
TRAINER = dict(total_steps=10)


def _leaves(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("name", list(SHAPES))
def test_update_leaf_matches_pallas_update_leaf(name):
    """Three updates of one leaf: the port's ``update_leaf`` (in place)
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(len(name))
    shape = SHAPES[name]
    p = rng.standard_normal(shape).astype(np.float32)
    m = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    jp, jm, jv = (jnp.asarray(a) for a in (p, m, v))
    for t in range(1, 4):
        g = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        lr, bc1, bc2 = 1e-2 * t, 1 - 0.9 ** t, 1 - 0.999 ** t
        jp, jm, jv = jfa._update_leaf(jnp.asarray(g), jm, jv, jp, lr, bc1,
                                      bc2, interpret=True, **HYPER)
        tfa.update_leaf(torch.from_numpy(g), tm, tv, tp, lr, bc1, bc2,
                        **HYPER)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_fused_adamw_matches_jax_over_three_steps():
    """``FusedAdamW`` from ``make_optimizer`` against the JAX factory's
    ``fused_adamw`` (its ``fused_apply``): a 2-step warmup into a cosine
    schedule, weight decay, leaves above and below 65536 elements; params
    and both moments after 3 steps, and the count."""
    kw = dict(name="fused_adamw", learning_rate=1e-2, warmup_steps=2,
              schedule="cosine", weight_decay=0.1, b2=0.95)
    jtx, _ = jopt.make_optimizer(jschema.OptimizerConfig(**kw),
                                 jschema.TrainerConfig(**TRAINER))
    ttx, _ = topt.make_optimizer(tschema.OptimizerConfig(**kw),
                                 tschema.TrainerConfig(**TRAINER))
    assert isinstance(ttx, tfa.FusedAdamW)
    rng = np.random.default_rng(0)
    params = _leaves(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    for _ in range(3):
        g = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, jstate = jtx.fused_apply(jax.tree.map(jnp.asarray, g), jstate, jp)
        ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
    assert tstate["count"] == int(jstate.count) == 3
    for k in SHAPES:
        for got, want in ((tp[k], jp[k]), (tstate["mu"][k], jstate.mu[k]),
                          (tstate["nu"][k], jstate.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=ATOL, err_msg=k)


def test_fused_adamw_bf16_grads_match_jax_over_three_steps():
    """``FusedAdamW`` fed bf16 gradients (``precision.policy=bf16``'s
    cast) against JAX ``fused_adamw`` running its Pallas kernel in
    interpret mode on the same bf16 gradients: fp32 params and both
    moments after 3 steps, leaves above and below 65536 elements."""
    sched = lambda c: 1e-2 * (c + 1)
    jtx = jfa.fused_adamw(sched, b2=0.95, weight_decay=0.1, interpret=True)
    ttx = tfa.FusedAdamW(sched, b2=0.95, weight_decay=0.1)
    rng = np.random.default_rng(3)
    params = _leaves(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    for _ in range(3):
        g = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, jstate = jtx.fused_apply(
            {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()},
            jstate, jp)
        ttx.update({k: torch.from_numpy(v).bfloat16() for k, v in g.items()},
                   tstate, tp)
    for k in SHAPES:
        assert tp[k].dtype == tstate["mu"][k].dtype == torch.float32
        for got, want in ((tp[k], jp[k]), (tstate["mu"][k], jstate.mu[k]),
                          (tstate["nu"][k], jstate.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=ATOL, err_msg=k)


def test_kernel_takes_bf16_grads_and_refuses_other_leaves():
    """What the kernel wrapper takes, checked before any build: a bf16 g
    beside fp32 p, m and v; a bf16 p (reachable only through a bf16
    init, ``trainer.init_params_path``, ROADMAP queue A item 15) or a
    misaligned g raises."""
    p, m, v = (torch.zeros(65536) for _ in range(3))
    tfa._check_leaf(p, torch.zeros(65536, dtype=torch.bfloat16), m, v)
    with pytest.raises(TypeError, match="init_params_path.*item 15"):
        tfa.adamw_kernel(p.bfloat16(), p, m, v, 1e-3, 0.1, 0.1, b1=0.9,
                         b2=0.999, eps=1e-8, wd=0.0)
    with pytest.raises(TypeError, match="float32 or bfloat16 g"):
        tfa.adamw_kernel(p, p.half(), m, v, 1e-3, 0.1, 0.1, b1=0.9,
                         b2=0.999, eps=1e-8, wd=0.0)
    g = torch.zeros(65537, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="8-byte aligned"):
        tfa.adamw_kernel(p, g, m, v, 1e-3, 0.1, 0.1, b1=0.9, b2=0.999,
                         eps=1e-8, wd=0.0)


def test_fused_adamw_reads_lr_before_the_count_increments():
    """Step 0 of a warmup (lr 0) leaves every leaf unchanged while the
    moments move; step 1 moves the params."""
    tx = tfa.FusedAdamW(lambda c: 0.0 if c == 0 else 1e-2, weight_decay=0.1)
    params = {k: torch.ones(s) for k, s in SHAPES.items()}
    state = tx.init(params)
    grads = {k: torch.full(s, 0.5) for k, s in SHAPES.items()}
    tx.update(grads, state, params)
    assert all(torch.equal(p, torch.ones(SHAPES[k]))
               for k, p in params.items())
    assert all(bool((m != 0).all()) for m in state["mu"].values())
    tx.update(grads, state, params)
    assert all(not torch.equal(p, torch.ones(SHAPES[k]))
               for k, p in params.items())


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_sgd_matches_optax(wd, clip):
    """``optimizer.name=sgd`` (the imagenet_rn50_ddp recipe's: nesterov
    momentum 0.9, weight decay, warmup + cosine) against the JAX
    factory's optax chain over 4 steps, with and without the clip."""
    kw = dict(name="sgd", learning_rate=0.4, momentum=0.9, weight_decay=wd,
              schedule="cosine", warmup_steps=2, grad_clip_norm=clip)
    jtx, _ = jopt.make_optimizer(jschema.OptimizerConfig(**kw),
                                 jschema.TrainerConfig(**TRAINER))
    ttx, _ = topt.make_optimizer(tschema.OptimizerConfig(**kw),
                                 tschema.TrainerConfig(**TRAINER))
    assert isinstance(ttx, topt.SGD)
    rng = np.random.default_rng(1)
    params = _leaves(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    for _ in range(4):
        g = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()}
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
    assert tstate["count"] == 4
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=ATOL, err_msg=k)


def test_factory_refuses_fused_adamw_with_a_clip():
    """Both factories refuse ``fused_adamw`` with ``grad_clip_norm``, with
    the same message; the other optimizers not ported raise naming their
    ROADMAP item."""
    cfg = dict(name="fused_adamw", grad_clip_norm=1.0)
    with pytest.raises(ValueError, match="grad_clip_norm") as jerr:
        jopt.make_optimizer(jschema.OptimizerConfig(**cfg),
                            jschema.TrainerConfig(**TRAINER))
    with pytest.raises(ValueError) as terr:
        topt.make_optimizer(tschema.OptimizerConfig(**cfg),
                            tschema.TrainerConfig(**TRAINER))
    assert str(terr.value) == str(jerr.value)
    for name in ("lion", "adafactor", "adam"):
        with pytest.raises(NotImplementedError, match="item 10"):
            topt.make_optimizer(
                dataclasses.replace(tschema.OptimizerConfig(), name=name),
                tschema.TrainerConfig(**TRAINER))
