"""The port's AdamW, clip and schedules (frl_distributed_ml_scaffold_tpu_torch/
trainer/optimizers.py) against optax through the JAX package's factory
(``make_schedule`` / ``make_optimizer``), on the same numpy inputs.

Tolerances: schedules 1e-6 relative, or 1e-6 of the peak lr absolute
where the value nears 0 (fp64 here, fp32 in optax, whose cosine rounds
at eps of the peak); AdamW
and the clip 1e-6 absolute on params of unit scale after several steps
(fp32 elementwise math in another order).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.trainer import optimizers as jopt
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.trainer import optimizers as topt

SHAPES = {"w": (7, 5), "b": (5,), "e": (11, 3)}


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear", "wsd"])
def test_schedules_match_optax(schedule, warmup):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, schedule=schedule,
              wsd_decay_fraction=0.3)
    j = jopt.make_schedule(jschema.OptimizerConfig(**kw), 20)
    t = topt.make_schedule(tschema.OptimizerConfig(**kw), 20)
    for count in range(0, 26):
        want = float(j(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(t(count), want, rtol=1e-6,
                                   atol=1e-6 * kw["learning_rate"],
                                   err_msg=f"{schedule} count={count}")
    if warmup:
        assert t(0) == 0.0


def _run_both(opt_kw, grads_scale, steps=4, seed=0):
    """``steps`` updates of the port's AdamW and optax's chain from the
    same params and gradients; returns (port params, optax params)."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (grads_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    trainer = dict(total_steps=10)
    jtx, _ = jopt.make_optimizer(jschema.OptimizerConfig(**opt_kw),
                                 jschema.TrainerConfig(**trainer))
    ttx, _ = topt.make_optimizer(tschema.OptimizerConfig(**opt_kw),
                                 tschema.TrainerConfig(**trainer))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        updates, jstate = jtx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
    return tp, jp, tstate


@pytest.mark.parametrize("scale", [1e-2, 10.0], ids=["below_clip", "clipped"])
@pytest.mark.parametrize("warmup", [0, 2])
def test_adamw_with_clip_matches_optax(scale, warmup):
    """clip_by_global_norm(1.0) then adamw(b2=0.95, wd=0.1) under a cosine
    schedule: gradients below the clip and far above it."""
    kw = dict(name="adamw", learning_rate=1e-2, warmup_steps=warmup,
              schedule="cosine", weight_decay=0.1, b2=0.95,
              grad_clip_norm=1.0)
    tp, jp, state = _run_both(kw, scale)
    assert state["count"] == 4
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_adamw_without_clip_and_default_b2_matches_optax():
    """b2=None is the adam family's 0.999; no clip; weight decay on every
    leaf (optax.adamw runs with no mask)."""
    kw = dict(name="adamw", learning_rate=5e-3, weight_decay=0.3)
    tp, jp, _ = _run_both(kw, 1.0, seed=1)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_clip_has_no_epsilon_and_keeps_grads_below_the_norm():
    """optax's clip: unchanged below max, ``(g / norm) * max`` at or
    above it, with no epsilon (torch's clip_grad_norm_ adds 1e-6)."""
    rng = np.random.default_rng(2)
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    norm = float(optax.global_norm(jax.tree.map(jnp.asarray, g)))
    got = topt.global_norm(torch.from_numpy(v) for v in g.values())
    np.testing.assert_allclose(float(got), norm, rtol=1e-6)
    for max_norm in (norm * 2, norm / 3):
        clip = optax.clip_by_global_norm(max_norm)
        want, _ = clip.update(jax.tree.map(jnp.asarray, g), clip.init(None))
        tx = topt.AdamW(lambda c: 0.0, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.0, clip=max_norm)
        params = {k: torch.zeros(s) for k, s in SHAPES.items()}
        state = tx.init(params)
        # lr 0: the params stay; the moments record the clipped grads.
        tx.update({k: torch.from_numpy(v) for k, v in g.items()}, state,
                  params)
        for k in SHAPES:
            clipped = state["mu"][k] / (1 - 0.9)
            np.testing.assert_allclose(clipped.numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-7)
            assert torch.equal(params[k], torch.zeros(SHAPES[k]))


def test_step_zero_under_warmup_leaves_params_unchanged():
    """The schedule is read at the count before it increments."""
    kw = dict(name="adamw", learning_rate=1e-2, warmup_steps=5,
              schedule="cosine", weight_decay=0.1, grad_clip_norm=1.0)
    tx, sched = topt.make_optimizer(tschema.OptimizerConfig(**kw),
                                    tschema.TrainerConfig(total_steps=10))
    params = {"w": torch.ones(3)}
    state = tx.init(params)
    tx.update({"w": torch.full((3,), 0.5)}, state, params)
    assert sched(0) == 0.0 and torch.equal(params["w"], torch.ones(3))
    tx.update({"w": torch.full((3,), 0.5)}, state, params)
    assert not torch.equal(params["w"], torch.ones(3))
