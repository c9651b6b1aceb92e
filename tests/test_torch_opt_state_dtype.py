"""The optimizer state's dtype under a bf16 params file, as the JAX
trainer keeps it: fp32 for adamw, lion and sgd (ROADMAP C.11), and for
adafactor fp32 at init and the param's dtype from the first update on,
as optax's ``scale_by_factored_rms`` writes its moments back with
``astype(param.dtype)`` (ROADMAP C.12).

A tiny ``gpt2_medium_zero1`` loaded from one params file under
``precision.policy=bf16`` in both packages, for ``adamw``, ``lion``,
``adafactor`` and ``sgd`` (``lion`` and ``adafactor`` in
``test_torch_opt_state_dtype_factored.py``, to split the time), three
steps: the params stay bf16, and every tensor of the optimizer state has
the JAX state's dtype at init, after one step and after three; every
param after the steps is within ``test_torch_init_params.py``'s bf16
bound of the JAX trainer's (two bf16 ulps of the value plus twice the
summed lr). The adafactor case runs at width 128, so its matrices keep
factored moments, and holds every moment tensor after one step and
after three to the JAX state's: within four bf16 ulps of the tensor's
largest value (the gradients of the two packages differ by the bf16
rounding of their backward passes; a square and the cast add two more),
but the key projection's bias, whose exact gradient is 0 (ROADMAP C.7).
A square matrix's row and column statistics trade places (numpy's
argsort of equal dims), which the comparison undoes. The checkpoint's
payload keeps the saved dtypes (the JAX checkpointer writes the bf16
moments as they are), a restore into the fp32 template widens them, as
the JAX restore does into its template, and equals the saved state
value for value.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_parity import ZERO_GRAD, recipe_pair
from _torch_sharded import _random_params
from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer as JaxTrainer
from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.checkpoint.manager import (
    STATE_FILE,
)
from frl_distributed_ml_scaffold_tpu_torch.models import convert
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

OV = ["model.num_layers=2", "model.hidden_dim=64", "model.num_heads=4",
      "model.vocab_size=512", "model.seq_len=32", "data.seq_len=32",
      "data.vocab_size=512", "data.global_batch_size=8",
      "trainer.grad_accum=1", "trainer.remat=none", "model.attention=dense",
      "trainer.total_steps=3", "trainer.log_every=1", "trainer.eval_every=0",
      "optimizer.warmup_steps=1", "optimizer.learning_rate=1e-3",
      "precision.policy=bf16"]


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


_BF16_EPS = 2.0 ** -7


def _per_layer(tree, num_layers: int) -> dict:
    """A JAX moment tree by the port's leaf key: each stacked block leaf
    cut into its layers, a ``(1,)`` placeholder kept whole."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(p.key for p in path)
        arr = np.asarray(leaf, np.float32)
        if names[0] == "blocks":
            for i in range(num_layers):
                out[("blocks", i) + names[1:]] = (
                    arr[i] if arr.shape[0] == num_layers else arr)
        else:
            out[names] = arr
    return out


def _jax_key(name: str) -> tuple:
    parts = name.split(".")
    if parts[0] != "blocks":
        return {"wte.weight": ("wte", "embedding"), "wpe": ("wpe",),
                "ln_f.weight": ("ln_f", "scale"),
                "ln_f.bias": ("ln_f", "bias")}[name]
    mod, leaf = tuple(parts[2:-1]), parts[-1]
    if mod[0] in ("attn", "mlp"):
        leaf = {"weight": "kernel", "bias": "bias"}[leaf]
    else:
        leaf = {"weight": "scale", "bias": "bias"}[leaf]
    return ("blocks", int(parts[1])) + mod + (leaf,)


def _hold_moments(jopt, topt: dict, shapes: dict, num_layers: int,
                  what: str) -> None:
    """Adafactor's moments, the port's against the JAX state's (module
    docstring)."""
    # The JAX chain's state: (clip, (factored moments, ...), decay).
    fs = jax.device_get(jopt)[1][0]
    jv = {n: _per_layer(getattr(fs, n), num_layers)
          for n in ("v_row", "v_col", "v")}
    for k, shape in shapes.items():
        if k.endswith(ZERO_GRAD):
            continue
        got = {n: topt[n][k].float().numpy() for n in ("v_row", "v_col", "v")}
        want = {n: jv[n][_jax_key(k)] for n in ("v_row", "v_col", "v")}
        if len(shape) == 2 and shape[0] == shape[1] and got["v_row"].size > 1:
            want["v_row"], want["v_col"] = want["v_col"], want["v_row"]
        if want["v"].ndim == 2 and want["v"].shape != got["v"].shape:
            want["v"] = want["v"].T  # flax's [in, out]
        for n, w in want.items():
            assert got[n].shape == w.shape, (what, k, n)
            bound = 4 * _BF16_EPS * np.abs(w).max()
            assert np.abs(got[n] - w).max() <= bound, (what, k, n)


def hold_fp32_state(tmp_path, opt: str) -> None:
    """One optimizer's case (module docstring)."""
    path = tmp_path / "gpt.msgpack"
    factored = opt == "adafactor"
    ov = OV + [f"optimizer.name={opt}", f"trainer.init_params_path={path}"]
    if factored:
        ov += ["model.hidden_dim=128"]
    jcfg, _ = recipe_pair("gpt2_medium_zero1",
                          ov + [f"workdir={tmp_path / 'jax'}"])
    tcfg = tconfig.apply_overrides(
        tconfig.get_config("gpt2_medium_zero1"),
        ov + [f"workdir={tmp_path / 'port'}", "checkpoint.enabled=true",
              "checkpoint.save_every=3", "checkpoint.async_save=false"])
    jt = JaxTrainer(jcfg)
    path.write_bytes(serialization.to_bytes(
        _random_params(jt.state_shapes.params, 3)))
    # optax writes adafactor's moments back in the param dtype.
    stepped = torch.bfloat16 if factored else torch.float32
    jstate = jt.init_state()
    assert all(leaf.dtype == np.float32
               for leaf in jax.tree.leaves(jstate.opt_state)
               if getattr(leaf, "ndim", 0) > 0)
    tt = Trainer(tcfg, device="cpu")
    for shapes in (tt.state_shapes, tt.init_state()):
        assert all(t.dtype == torch.bfloat16 for t in shapes.params.values())
        assert all(t.dtype == torch.float32
                   for t in _tensors(shapes.opt_state))
    layers = tcfg.model.num_layers
    shapes = {k: tuple(p.shape) for k, p in tt.state_shapes.params.items()}
    if factored:
        # One step in each, on the pipeline's first batch.
        one_j, one_t = jt.init_state(), tt.init_state()
        batch = {k: np.asarray(v)
                 for k, v in tt.pipeline.global_batch(0).items()}
        one_j, _ = jt.train_step(one_j, batch)
        one_t, _ = tt.train_step(one_t, batch)
        assert all(leaf.dtype == jax.numpy.bfloat16
                   for leaf in jax.tree.leaves(one_j.opt_state)
                   if getattr(leaf, "ndim", 0) > 0)
        assert all(t.dtype == stepped for t in _tensors(one_t.opt_state))
        _hold_moments(one_j.opt_state, one_t.opt_state, shapes, layers,
                      "step 1")
    jstate, _ = jt.fit(jstate)
    want_dtype = jax.numpy.bfloat16 if factored else np.float32
    assert all(leaf.dtype == want_dtype
               for leaf in jax.tree.leaves(jstate.opt_state)
               if getattr(leaf, "ndim", 0) > 0)
    tstate, _ = tt.fit()
    assert all(t.dtype == torch.bfloat16 for t in tstate.params.values())
    assert all(t.dtype == stepped for t in _tensors(tstate.opt_state))
    if factored:
        _hold_moments(jstate.opt_state, tstate.opt_state, shapes, layers,
                      "step 3")
    want = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32),
                     jax.device_get(jstate.params)), tcfg.model)
    lr_sum = sum(tt.schedule(c) for c in range(3))
    for k, w in want.items():
        bound = 2 * _bf16_ulp(w.numpy()) + 2 * lr_sum
        got = tstate.params[k].float().numpy()
        assert (np.abs(got - w.numpy()) <= bound).all(), k
    # The payload keeps the saved dtypes; a restore into the template
    # takes the template's fp32, value for value.
    ck = tt.checkpointer
    raw = torch.load(tmp_path / "port" / tcfg.name / "ckpt" / "3" / STATE_FILE,
                     weights_only=True)
    assert all(t.dtype == stepped for t in _tensors(raw["opt_state"]))
    restored = ck.restore(tt.state_shapes, device="cpu")
    assert restored.opt_state["count"] == tstate.opt_state["count"]
    for got, saved in zip(_tensors(restored.opt_state),
                          _tensors(tstate.opt_state)):
        assert got.dtype == torch.float32
        assert torch.equal(got, saved.float())
    for k, p in tstate.params.items():
        assert torch.equal(restored.params[k], p)
    ck.close()


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_bf16_file_keeps_fp32_optimizer_state(tmp_path, opt):
    hold_fp32_state(tmp_path, opt)
