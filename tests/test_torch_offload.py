"""``trainer.offload_opt_state``: the optimizer state in pinned host
memory, brought to the card a leaf at a time for each update.

On the CPU the port's ``Trainer`` refuses it with a ``ValueError``
naming ``pinned_host``, beside the JAX trainer's refusal on the same
config (the JAX package's ``tests/test_optimizers.py``). On a card
(``cuda``, skipped here) three steps of a tiny GPT through the
``Trainer`` with the state offloaded give the resident state's losses
and params bit for bit, and every state tensor is pinned host memory.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

OV = ["model.num_layers=2", "model.hidden_dim=128", "model.num_heads=4",
      "model.vocab_size=512", "model.seq_len=32", "data.seq_len=32",
      "data.vocab_size=512", "data.global_batch_size=8",
      "optimizer.warmup_steps=1", "trainer.total_steps=10"]


@pytest.mark.parametrize("config", ["mnist_mlp", "gpt2_medium_zero1"])
def test_offload_refused_on_the_cpu_as_jax_refuses(tmp_path, config):
    from frl_distributed_ml_scaffold_tpu.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu.trainer.loop import (
        Trainer as JaxTrainer,
    )

    ov = ["trainer.offload_opt_state=true", f"workdir={tmp_path}"]
    if config != "mnist_mlp":
        ov += OV
    with pytest.raises(ValueError, match="pinned_host"):
        JaxTrainer(apply_overrides(get_config(config), ov))
    with pytest.raises(ValueError, match="pinned_host"):
        Trainer(tconfig.apply_overrides(tconfig.get_config(config), ov),
                device="cpu")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_offloaded_step_equals_resident_step(tmp_path, opt):
    def run(offload: bool):
        cfg = tconfig.apply_overrides(
            tconfig.get_config("gpt2_medium_zero1"),
            OV + [f"optimizer.name={opt}", f"workdir={tmp_path}",
                  f"trainer.offload_opt_state={str(offload).lower()}"])
        t = Trainer(cfg, device="cuda")
        state = t.init_state()
        losses = []
        for step in range(3):
            state, m = t.train_step(state, t.pipeline.global_batch(step))
            losses.append(float(m["loss"]))
        return state, losses

    resident, want = run(False)
    offloaded, got = run(True)
    assert got == want
    for k, p in resident.params.items():
        assert torch.equal(offloaded.params[k], p)
    for key, v in offloaded.opt_state.items():
        if isinstance(v, dict):
            for k, t in v.items():
                assert t.device.type == "cpu" and t.is_pinned()
                assert torch.equal(t.cuda(), resident.opt_state[key][k])
