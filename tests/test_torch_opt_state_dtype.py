"""The optimizer state is fp32 whatever dtype a params file brings
(ROADMAP C.11), as the JAX trainer builds it from its fp32 init.

A tiny ``gpt2_medium_zero1`` loaded from one params file under
``precision.policy=bf16`` in both packages, for ``adamw``, ``lion``,
``adafactor`` and ``sgd`` (``lion`` and ``adafactor`` in
``test_torch_opt_state_dtype_factored.py``, to split the time), three
steps: the params stay bf16 and every
tensor of the optimizer state is fp32 (the JAX state's too at init, and
after the steps but for adafactor's, which optax writes back in the
gradient's dtype, ROADMAP C.12); every param
after the steps is within ``test_torch_init_params.py``'s bf16 bound of
the JAX trainer's (two bf16 ulps of the value plus twice the summed lr);
the checkpoint's payload, the state template and a restore keep the fp32
state, and the restore equals the state that was saved, bit for bit.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_parity import recipe_pair
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


def hold_fp32_state(tmp_path, opt: str) -> None:
    """One optimizer's case (module docstring)."""
    path = tmp_path / "gpt.msgpack"
    ov = OV + [f"optimizer.name={opt}", f"trainer.init_params_path={path}"]
    jcfg, _ = recipe_pair("gpt2_medium_zero1",
                          ov + [f"workdir={tmp_path / 'jax'}"])
    tcfg = tconfig.apply_overrides(
        tconfig.get_config("gpt2_medium_zero1"),
        ov + [f"workdir={tmp_path / 'port'}", "checkpoint.enabled=true",
              "checkpoint.save_every=3", "checkpoint.async_save=false"])
    jt = JaxTrainer(jcfg)
    path.write_bytes(serialization.to_bytes(
        _random_params(jt.state_shapes.params, 3)))
    jstate = jt.init_state()
    assert all(leaf.dtype == np.float32
               for leaf in jax.tree.leaves(jstate.opt_state)
               if getattr(leaf, "ndim", 0) > 0)
    jstate, _ = jt.fit(jstate)
    # optax's adafactor writes its factored moments back in the
    # gradient's dtype: under a bf16 file the JAX state turns bf16 after
    # the first update (ROADMAP C.12); the port keeps them fp32.
    want_dtype = jax.numpy.bfloat16 if opt == "adafactor" else np.float32
    assert all(leaf.dtype == want_dtype
               for leaf in jax.tree.leaves(jstate.opt_state)
               if getattr(leaf, "ndim", 0) > 0)
    tt = Trainer(tcfg, device="cpu")
    for shapes in (tt.state_shapes, tt.init_state()):
        assert all(t.dtype == torch.bfloat16 for t in shapes.params.values())
        assert all(t.dtype == torch.float32
                   for t in _tensors(shapes.opt_state))
    tstate, _ = tt.fit()
    assert all(t.dtype == torch.bfloat16 for t in tstate.params.values())
    assert all(t.dtype == torch.float32 for t in _tensors(tstate.opt_state))
    want = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32),
                     jax.device_get(jstate.params)), tcfg.model)
    lr_sum = sum(tt.schedule(c) for c in range(3))
    for k, w in want.items():
        bound = 2 * _bf16_ulp(w.numpy()) + 2 * lr_sum
        got = tstate.params[k].float().numpy()
        assert (np.abs(got - w.numpy()) <= bound).all(), k
    # The payload, and a restore into the template, keep the fp32 state.
    ck = tt.checkpointer
    raw = torch.load(tmp_path / "port" / tcfg.name / "ckpt" / "3" / STATE_FILE,
                     weights_only=True)
    assert all(t.dtype == torch.float32 for t in _tensors(raw["opt_state"]))
    restored = ck.restore(tt.state_shapes, device="cpu")
    assert restored.opt_state["count"] == tstate.opt_state["count"]
    for got, saved in zip(_tensors(restored.opt_state),
                          _tensors(tstate.opt_state)):
        assert got.dtype == torch.float32 and torch.equal(got, saved)
    for k, p in tstate.params.items():
        assert torch.equal(restored.params[k], p)
    ck.close()


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_bf16_file_keeps_fp32_optimizer_state(tmp_path, opt):
    hold_fp32_state(tmp_path, opt)
