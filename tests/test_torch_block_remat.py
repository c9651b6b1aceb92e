"""``model.block_remat`` in the port's GPT (frl_distributed_ml_scaffold_
tpu_torch/models/gpt.py ``_block_train``): three steps of
``make_train_step`` under ``none`` / ``full`` / ``save_attn`` against the
JAX train step under the same mode, with dense and flash attention (the
port's flash takes its plain lse path on the CPU; JAX's goes dense on
the CPU); and what each mode keeps for the backward, counted with
``torch.autograd.graph.saved_tensors_hooks``.

Tolerances (fp32, as ``test_torch_train_step.py``): loss and grad_norm
to 1e-5 relative, every param after the last step to 1e-6 absolute, the
key projection's bias (no gradient but noise, ROADMAP C.7) to twice the
Adam bound. The port's three modes agree with each other bit for bit.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, jax_params

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JaxGPT
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu.trainer import optimizers as jopt
from frl_distributed_ml_scaffold_tpu.trainer import tasks as jtasks
from frl_distributed_ml_scaffold_tpu.trainer import train_state as jstate
from frl_distributed_ml_scaffold_tpu.trainer import train_step as jstep
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
from frl_distributed_ml_scaffold_tpu_torch.models.convert import params_from_jax
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import optimizers as topt
from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
    make_train_step,
)

MODES = ["none", "full", "save_attn"]
OPT = dict(name="adamw", learning_rate=1e-3, warmup_steps=1,
           schedule="cosine", weight_decay=0.1, b2=0.95, grad_clip_norm=1.0)
TRAINER = dict(total_steps=10, grad_accum=2)
LR_SUM = 1.5e-3  # lr(0) + lr(1) + lr(2): 0 + 1e-3 + 5e-4


def _batches():
    data = SyntheticLM(tschema.DataConfig(
        name="lm_synthetic", global_batch_size=4, seq_len=TINY["seq_len"],
        vocab_size=TINY["vocab_size"]), split="train")
    return [data.batch(s, 4) for s in range(3)]


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module", params=MODES)
def reference(request, params):
    """The JAX step's trajectory under ``block_remat=mode``."""
    cfg = jschema.GPTConfig(**TINY, block_remat=request.param)
    tx, _ = jopt.make_optimizer(jschema.OptimizerConfig(**OPT),
                                jschema.TrainerConfig(**TRAINER))
    state = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), tx)
    step = jax.jit(jstep.make_train_step(
        jtasks.make_lm_loss(JaxGPT(cfg, jax_policy("fp32"))), tx,
        jax_policy("fp32"), grad_accum=2))
    out = {"loss": [], "grad_norm": [], "mode": request.param}
    for batch in _batches():
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = params_from_jax(jax.device_get(state.params),
                                    tschema.GPTConfig(**TINY))
    return out


def _port_run(params, mode: str, attention: str):
    cfg = tschema.GPTConfig(**TINY, block_remat=mode, attention=attention)
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    tx, _ = topt.make_optimizer(tschema.OptimizerConfig(**OPT),
                                tschema.TrainerConfig(**TRAINER), cfg)
    state = TrainState.create(dict(model.named_parameters()), tx,
                              device="cpu")
    step = make_train_step(ttasks.make_lm_loss(model), tx,
                           get_policy("fp32"), grad_accum=2, device="cpu")
    out = {"loss": [], "grad_norm": []}
    for batch in _batches():
        state, m = step(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = state.params
    return out


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_block_remat_matches_jax(params, reference, attention):
    got = _port_run(params, reference["mode"], attention)
    np.testing.assert_allclose(got["loss"], reference["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], reference["grad_norm"],
                               rtol=1e-5)
    for name, want in reference["params"].items():
        atol = 4 * LR_SUM if name.endswith("attn.key.bias") else 1e-6
        np.testing.assert_allclose(got["params"][name].numpy(), want.numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def test_modes_agree_bit_for_bit(params):
    """Recomputation is deterministic on the CPU: the three modes take
    the same steps."""
    runs = {m: _port_run(params, m, "flash") for m in MODES}
    for m in ("full", "save_attn"):
        assert runs[m]["loss"] == runs["none"]["loss"], m
        for name, p in runs["none"]["params"].items():
            assert torch.equal(runs[m]["params"][name], p), (m, name)


def _saved(params, mode: str) -> tuple[int, int]:
    """(tensors, bytes) the autograd graph keeps from one training
    forward of the tiny GPT under ``mode``, as packed through
    ``saved_tensors_hooks`` (a checkpointed region packs only its
    inputs; what it recomputes is not kept)."""
    cfg = tschema.GPTConfig(**TINY, block_remat=mode)
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    toks = torch.from_numpy(_batches()[0]["tokens"][:, :-1].astype(np.int64))
    count, nbytes, seen = 0, 0, set()

    def pack(t):
        nonlocal count, nbytes
        key = (t.data_ptr(), tuple(t.shape), t.dtype)
        if t.numel() and key not in seen:
            seen.add(key)
            count += 1
            nbytes += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(toks, train=True).float().sum().backward()
    return count, nbytes


def test_what_each_mode_keeps(params):
    """``none`` keeps every block's internals; ``full`` keeps each
    block's input only; ``save_attn`` keeps each block's input and its
    ``x + attn_out`` as well: exactly one more [B, T, D] fp32 tensor a
    layer than ``full``."""
    none, full, save = (_saved(params, m) for m in MODES)
    b, t, d = 4, TINY["seq_len"], TINY["hidden_dim"]
    layers = TINY["num_layers"]
    assert none[1] > save[1] > full[1]
    assert save[0] - full[0] == layers
    assert save[1] - full[1] == layers * b * t * d * 4
