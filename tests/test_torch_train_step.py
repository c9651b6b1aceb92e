"""The port's GPT training step (frl_distributed_ml_scaffold_tpu_torch/
trainer/, models/gpt.py's training forward, ops/flash_attention.py's
differentiable router, data/synthetic.py) held against the JAX
package's train step on the same carried-across params and the same
``SyntheticLM`` batches: three optimizer steps of ``grad_accum=2``
through AdamW with a 2-step warmup into a cosine schedule, weight decay
and the global-norm clip.

The JAX step runs once per policy (a module fixture): on the CPU its
``attention=flash`` goes dense and its remat modes do not change the
numbers, so one reference serves every port variant (attention dense or
flash, remat none/full/dots, ``lm_loss_chunk`` 0 or 32). The port's flash
takes its plain lse path on the CPU, its own autograd Function.

Tolerances:
- fp32: loss and ``grad_norm`` to 1e-5 relative, lr to 1e-6 relative
  (the schedule is computed in fp64 here, fp32 there), every final param
  to 1e-6 absolute (summation order only; measured 3e-7).
- bf16_mixed: the frameworks round bf16 at different places (fused bias
  adds, the tied embedding's two gradient contributions, the lse path's
  unnormalised probabilities), so the loss is held to 2e-4 relative,
  ``grad_norm`` to 1e-2 relative, and each final param to the most a
  disagreeing Adam direction can move it, twice the sum of the learning
  rates applied (2 * 1.5e-3 here), with the mean absolute difference
  under 1 % of that (measured: max 1.2e-3, mean 1.2e-5).
- The key projection's bias gets no gradient in exact arithmetic (the
  softmax is invariant to a per-query constant), so under both policies
  its update is Adam-normalised rounding noise in both frameworks: it is
  held only to twice that bound (measured 2.9e-3 under bf16_mixed, 5.5e-5
  under fp32).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, jax_params

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.data.synthetic import (
    SyntheticLM as JaxSyntheticLM,
)
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
from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as tfa
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import optimizers as topt
from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
    make_eval_step,
    make_train_step,
)

STEPS, BATCH, ACCUM = 3, 4, 2
OPT = dict(name="adamw", learning_rate=1e-3, warmup_steps=2,
           schedule="cosine", weight_decay=0.1, b2=0.95,
           grad_clip_norm=1.0)
TRAINER = dict(total_steps=10, grad_accum=ACCUM)
DATA = dict(name="lm_synthetic", global_batch_size=BATCH,
            seq_len=TINY["seq_len"], vocab_size=TINY["vocab_size"])
LR_SUM = 1.5e-3  # lr(0) + lr(1) + lr(2) = 0 + 5e-4 + 1e-3


def _batches():
    data = SyntheticLM(tschema.DataConfig(**DATA), split="train")
    return [data.batch(s, BATCH) for s in range(STEPS)]


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module", params=["fp32", "bf16_mixed"])
def reference(request, params):
    """The JAX train step's trajectory under one policy: per-step loss,
    grad_norm and lr, and the final params (the port's names)."""
    policy = request.param
    model = JaxGPT(jschema.GPTConfig(**TINY), jax_policy(policy))
    tx, schedule = jopt.make_optimizer(
        jschema.OptimizerConfig(**OPT), jschema.TrainerConfig(**TRAINER))
    state = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), tx)
    step = jax.jit(jstep.make_train_step(
        jtasks.make_lm_loss(model), tx, jax_policy(policy),
        grad_accum=ACCUM))
    out = {"loss": [], "grad_norm": [], "lr": []}
    for s, batch in enumerate(_batches()):
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["lr"].append(float(schedule(s)))
    out["params"] = params_from_jax(jax.device_get(state.params),
                                    tschema.GPTConfig(**TINY))
    out["policy"] = policy
    return out


def _port_run(params, policy, *, attention="dense", remat="none", chunk=0):
    cfg = tschema.GPTConfig(**TINY, attention=attention, lm_loss_chunk=chunk)
    model = GPT(cfg, get_policy(policy), device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    tx, schedule = topt.make_optimizer(
        tschema.OptimizerConfig(**OPT), tschema.TrainerConfig(**TRAINER), cfg)
    state = TrainState.create(dict(model.named_parameters()), tx,
                              device="cpu")
    step = make_train_step(ttasks.make_lm_loss(model), tx,
                           get_policy(policy), grad_accum=ACCUM, remat=remat,
                           device="cpu")
    out = {"loss": [], "grad_norm": [], "lr": []}
    for s, batch in enumerate(_batches()):
        state, m = step(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["lr"].append(schedule(s))
    out["params"] = state.params
    out["state"] = state
    out["model"] = model
    return out


def _hold(got, ref):
    bf16 = ref["policy"] == "bf16_mixed"
    np.testing.assert_allclose(got["lr"], ref["lr"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["loss"], ref["loss"],
                               rtol=2e-4 if bf16 else 1e-5, atol=0)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=1e-2 if bf16 else 1e-5, atol=0)
    assert got["params"].keys() == ref["params"].keys()
    adam_bound = 2 * LR_SUM
    for name, want in ref["params"].items():
        diff = (got["params"][name] - want).abs()
        if name.endswith("attn.key.bias"):  # no gradient but noise
            assert float(diff.max()) <= 2 * adam_bound, (name, diff.max())
            continue
        bound = adam_bound if bf16 else 1e-6
        assert float(diff.max()) <= bound, (name, float(diff.max()), bound)
        if bf16:
            assert float(diff.mean()) <= 0.01 * bound, (name, diff.mean())


@pytest.mark.parametrize("chunk", [0, 32], ids=["dense_head", "chunk32"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_train_steps_match_jax(params, reference, attention, remat, chunk):
    """Three steps of the port's step against the JAX step: loss,
    grad_norm and lr per step, every param after the last."""
    before = tfa.flash_attention.fallbacks
    got = _port_run(params, reference["policy"], attention=attention,
                    remat=remat, chunk=chunk)
    assert tfa.flash_attention.fallbacks == before
    _hold(got, reference)
    assert got["state"].step == STEPS
    assert got["state"].opt_state["count"] == STEPS


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_remat_modes_give_the_same_grads(params, policy):
    """none, full and dots: the same numbers on the CPU (recomputation is
    deterministic there), through the flash router's autograd Function
    and a ctypes-free selective checkpoint alike."""
    runs = {r: _port_run(params, policy, attention="flash", remat=r)
            for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        assert runs[r]["grad_norm"] == runs["none"]["grad_norm"], r
        assert runs[r]["loss"] == runs["none"]["loss"], r
        for name, p in runs["none"]["params"].items():
            torch.testing.assert_close(runs[r]["params"][name], p,
                                       atol=0, rtol=0)


def test_first_step_under_warmup_leaves_params_unchanged(params):
    """optax reads the schedule at the count before it increments: lr(0)
    is 0 under warmup, so step 0 moves nothing; step 1 moves."""
    cfg = tschema.GPTConfig(**TINY)
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    tx, schedule = topt.make_optimizer(
        tschema.OptimizerConfig(**OPT), tschema.TrainerConfig(**TRAINER), cfg)
    state = TrainState.create(dict(model.named_parameters()), tx,
                              device="cpu")
    step = make_train_step(ttasks.make_lm_loss(model), tx, get_policy("fp32"),
                           grad_accum=ACCUM, device="cpu")
    start = {k: p.clone() for k, p in state.params.items()}
    batches = _batches()
    state, m0 = step(state, batches[0])
    assert schedule(0) == 0.0
    assert all(torch.equal(state.params[k], p) for k, p in start.items())
    assert float(m0["grad_norm"]) > 0
    state, _ = step(state, batches[1])
    assert any(not torch.equal(state.params[k], p) for k, p in start.items())


def test_eval_step_matches_jax_eval(params):
    """The eval step's loss and metrics against the JAX eval step."""
    model = JaxGPT(jschema.GPTConfig(**TINY), jax_policy("fp32"))
    tx, _ = jopt.make_optimizer(jschema.OptimizerConfig(**OPT),
                                jschema.TrainerConfig(**TRAINER))
    jst = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), tx)
    batch = _batches()[0]
    want = jax.jit(jstep.make_eval_step(jtasks.make_lm_loss(model),
                                        jax_policy("fp32")))(
        jst, jax.tree.map(jnp.asarray, batch))
    got = _port_run(params, "fp32")
    tmodel = got["model"]
    tmodel.load_state_dict(params_from_jax(params, tmodel.config))
    ttx, _ = topt.make_optimizer(tschema.OptimizerConfig(**OPT),
                                 tschema.TrainerConfig(**TRAINER),
                                 tmodel.config)
    tst = TrainState.create(dict(tmodel.named_parameters()), ttx,
                            device="cpu")
    out = make_eval_step(ttasks.make_lm_loss(tmodel), get_policy("fp32"),
                         device="cpu")(tst, batch)
    for k in ("loss", "ce_loss", "perplexity"):
        np.testing.assert_allclose(float(out[k]), float(want[k]), rtol=1e-5)


def test_synthetic_lm_batches_match_jax():
    """``SyntheticLM`` batches are the JAX ones, bit for bit, for both
    splits, several steps and host offsets."""
    for split in ("train", "eval"):
        for seed in (0, 3):
            dcfg = dict(DATA, shuffle_seed=seed)
            t = SyntheticLM(tschema.DataConfig(**dcfg), split=split)
            j = JaxSyntheticLM(jschema.DataConfig(**dcfg), split=split)
            for step, off in ((0, 0), (5, 0), (2, 1)):
                a, b = t.batch(step, 3, off), j.batch(step, 3, off)
                assert a.keys() == b.keys() == {"tokens"}
                assert a["tokens"].dtype == b["tokens"].dtype == np.int32
                np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_training_refusals():
    """What the port still does not train raises, naming its ROADMAP
    item: seq / expert / pipe axes (A12); fused_adamw with a clip. Per-block
    remat under the overlap schedule trains; its rings need model > 1. Optimizer offload
    off the card raises as the JAX trainer's refusal does. Training
    dropout needs its seed; an unknown block_remat raises."""
    cfg = tschema.GPTConfig(**TINY, dropout=0.1)
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    toks = torch.zeros((1, 9), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs a seed"):
        model(toks, train=True)
    assert model(toks, train=True, rng=3).shape == (1, 9, TINY["vocab_size"])
    assert model(toks, train=False).shape == (1, 9, TINY["vocab_size"])
    loss = ttasks.make_lm_loss(model)
    tx, _ = topt.make_optimizer(tschema.OptimizerConfig(**OPT),
                                tschema.TrainerConfig(**TRAINER), cfg)
    # Optimizer offload needs a card's pinned host memory, as the JAX
    # trainer refuses a backend without it.
    with pytest.raises(ValueError, match="pinned_host"):
        make_train_step(loss, tx, get_policy("fp32"), device="cpu",
                        offload_opt_state=True)
    with pytest.raises(ValueError, match="grad_shardings"):
        make_train_step(loss, tx, get_policy("fp32"), device="cpu",
                        grad_shardings=object())
    # A mesh of more than one device needs a layout over as many ranks
    # (the Trainer builds it); seq / expert / pipe stay with A12.
    for mesh in (tschema.MeshConfig(data=2),
                 tschema.MeshConfig(data=1, fsdp=4)):
        with pytest.raises(ValueError, match="needs [24] devices"):
            make_train_step(loss, tx, get_policy("fp32"), device="cpu",
                            mesh=mesh)
    for axis in ("seq", "expert", "pipe"):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            make_train_step(loss, tx, get_policy("fp32"), device="cpu",
                            mesh=tschema.MeshConfig(**{axis: 2}))
    # The recipe's own mesh (data=1, fsdp=-1) is one card.
    make_train_step(loss, tx, get_policy("fp32"), device="cpu",
                    mesh=tschema.MeshConfig(data=1, fsdp=-1))
    # Per-block remat under the overlap schedule: the blockwise FSDP
    # gathers build and train (over one card nothing is split: the
    # plain step's loss); the rings on a model=1 mesh raise, as the
    # reference's make_tp_hooks refuses them.
    ov = ["model.num_layers=2", "model.hidden_dim=128",
          "model.num_heads=4", "model.vocab_size=512",
          "model.seq_len=128", "data.vocab_size=512",
          "data.seq_len=128", "model.block_remat=full",
          "data.global_batch_size=2", "trainer.grad_accum=1",
          "precision.policy=fp32", "parallel.param_sharding=fsdp"]
    base = apply_overrides(get_config("gpt2_medium_zero1"), ov)
    losses = []
    for flag in ("false", "true"):
        t = Trainer(apply_overrides(base, [f"parallel.fsdp_overlap={flag}"]),
                    device="cpu")
        _, m = t.train_step(t.init_state(), t.pipeline.global_batch(0))
        losses.append(float(m["loss"]))
    assert t.model.param_hooks is not None and losses[0] == losses[1]
    with pytest.raises(ValueError, match="requires mesh.model > 1"):
        Trainer(apply_overrides(base, ["parallel.tp_overlap=true"]),
                device="cpu")
    # fused_adamw is ported; with this recipe's clip it is refused, as
    # the JAX factory refuses it.
    with pytest.raises(ValueError, match="grad_clip_norm"):
        topt.make_optimizer(
            dataclasses.replace(tschema.OptimizerConfig(**OPT),
                                name="fused_adamw"),
            tschema.TrainerConfig(**TRAINER), cfg)
    with pytest.raises(KeyError, match="block_remat"):
        GPT(dataclasses.replace(tschema.GPTConfig(**TINY), block_remat="dots"),
            get_policy("fp32"), device="cpu")


def test_ema_follows_the_params(params):
    """With ``ema_decay`` the step ends with ``ema = d * ema + (1 - d) *
    params`` after the update, as the JAX step does; the EMA starts as a
    copy of the params."""
    cfg = tschema.GPTConfig(**TINY)
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    tx, _ = topt.make_optimizer(
        tschema.OptimizerConfig(**dict(OPT, warmup_steps=0)),
        tschema.TrainerConfig(**TRAINER), cfg)
    state = TrainState.create(dict(model.named_parameters()), tx,
                              with_ema=True, device="cpu")
    assert all(torch.equal(state.ema_params[k], p)
               and state.ema_params[k].data_ptr() != p.data_ptr()
               for k, p in state.params.items())
    step = make_train_step(ttasks.make_lm_loss(model), tx, get_policy("fp32"),
                           grad_accum=ACCUM, ema_decay=0.9, device="cpu")
    start = {k: p.clone() for k, p in state.params.items()}
    state, _ = step(state, _batches()[0])
    for k, p in state.params.items():
        # Unit-scale params: fp32 rounding of two products and a sum.
        torch.testing.assert_close(state.ema_params[k],
                                   start[k] * 0.9 + p * (1 - 0.9),
                                   atol=1e-6, rtol=0)
    assert any(not torch.equal(state.params[k], p) for k, p in start.items())
