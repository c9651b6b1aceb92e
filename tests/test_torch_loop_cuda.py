"""The port's training loop and checkpoints on the card: a tiny GPT
``fit`` through the flash kernels with the prefetching pipeline (the
side-stream copy and its event) against the same ``fit`` on the CPU, and
an async checkpoint whose pinned snapshot the next in-place step must not
change.

Marked ``cuda`` and skipped without a card. This file imports no JAX, so
it runs on a machine that has none; there, skip the repository conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_loop_cuda.py

Tolerance: fp32 (TF32 off), the kernels against the CPU's plain path:
the loss and ``grad_norm`` per step to 1e-4 relative (the forward
kernel's fp32 sums run in another order; chip_smoke.py's
``fp32_train_check`` holds the same at full width).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import json
import os

import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.config import (
    apply_overrides,
    get_config,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState

TINY_GPT = ["model.num_layers=2", "model.hidden_dim=128", "model.num_heads=4",
            "model.vocab_size=512", "model.seq_len=128", "data.seq_len=128",
            "data.vocab_size=512", "data.global_batch_size=16",
            "trainer.grad_accum=2", "model.attention=flash",
            "precision.policy=fp32", "trainer.total_steps=4",
            "trainer.log_every=1", "optimizer.warmup_steps=1",
            "data.prefetch=2"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _records(cfg):
    with open(os.path.join(cfg.workdir, cfg.name, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.cuda
def test_gpt_fit_on_the_card_matches_the_cpu(tmp_path):
    _card()
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention

    runs = {}
    init = None
    for dev in ("cpu", "cuda"):
        cfg = apply_overrides(get_config("gpt2_medium_zero1"),
                              TINY_GPT + [f"workdir={tmp_path / dev}"])
        t = Trainer(cfg, device=dev)
        init = init or t.init_state()
        state = TrainState.create(init.params, t.tx, device=dev)
        before = flash_attention.flash_attention.fallbacks
        state, last = t.fit(state)
        assert flash_attention.flash_attention.fallbacks == before
        assert state.step == 4
        assert all(p.device.type == dev for p in state.params.values())
        runs[dev] = _records(cfg)
    for c, g in zip(runs["cpu"], runs["cuda"]):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - c[k]) <= 1e-4 * abs(c[k]), (c["step"], k)
        assert g["lr"] == c["lr"]
    card = runs["cuda"][-1]
    assert "hbm_peak_gib" in card
    if "H100" in torch.cuda.get_device_name(0):
        assert card["flops_source"] == "analytic" and card["mfu"] > 0


@pytest.mark.cuda
def test_async_snapshot_on_the_card_is_the_saved_step(tmp_path):
    _card()
    cfg = apply_overrides(get_config("gpt2_medium_zero1"), TINY_GPT + [
        f"workdir={tmp_path}", "checkpoint.enabled=true",
        "checkpoint.async_save=true"])
    t = Trainer(cfg, device="cuda")
    state = t.init_state()
    for step in range(2):
        state, _ = t.train_step(state, t.pipeline.global_batch(step))
    before = {k: p.clone() for k, p in state.params.items()}
    nu = {k: v.clone() for k, v in state.opt_state["nu"].items()}
    assert t.checkpointer.save(2, state)
    for step in range(2, 4):  # in place, while the write may run
        state, _ = t.train_step(state, t.pipeline.global_batch(step))
    t.checkpointer.wait()
    restored = t.checkpointer.restore(t.state_shapes, device="cuda")
    assert restored.step == 2 and restored.opt_state["count"] == 2
    assert any(not torch.equal(state.params[k], p)
               for k, p in before.items())
    for k, p in before.items():
        assert torch.equal(restored.params[k], p)
        assert torch.equal(restored.opt_state["nu"][k], nu[k])
    t.checkpointer.close()
    t.pipeline.close()
