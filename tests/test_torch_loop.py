"""The port's training loop (frl_distributed_ml_scaffold_tpu_torch/
trainer/loop.py ``Trainer``, with data/pipeline.py, utils/ and
telemetry/) against the JAX package's ``Trainer`` on the same config:
``mnist_mlp`` (fp32, its recipe's policy) and a tiny
``gpt2_medium_zero1`` (``__graft_entry__``'s flagship shapes, fp32,
``model.attention=dense``).

The port's state is the JAX ``init_state()`` params carried across with
``models/convert.py`` and passed to ``fit(state=...)``; both loops then
read their own pipelines (the same seeded batches) and write their own
``<workdir>/<name>/metrics.jsonl``. Per logged step, ``loss``,
``grad_norm`` and the task metrics are held to ``TRAIN_TOL`` (fp32: 3e-5
relative; measured at most 2.0e-6 on the MLP, 1.1e-7 on the GPT),
``lr`` to 1e-6 relative (the schedule is fp64 here, fp32 there), and the
record key sets must be equal apart from ``ONLY_JAX``. ``evaluate`` after the run agrees to the same tolerance,
with and without ``trainer.ema_decay``.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import json

import jax
import numpy as np
import pytest

from _torch_parity import TRAIN_TOL, recipe_pair

from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer as JaxTrainer
from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
    mlp_params_from_jax,
    params_from_jax,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState

# Keys one package cannot have: the JAX trainer reports an MFU on the CPU
# against its nominal default peak; the port gives an MFU only on a card
# whose peak it knows (utils/flops.py), never on the CPU.
ONLY_JAX = {"mfu"}
# Host-clock fields: both packages write them, with their own values.
TIMING = {"wall_time_s", "step_time_median_s", "step_time_p50_s",
          "step_time_p95_s", "step_time_p99_s", "samples_per_sec_per_chip",
          "data_wait_s", "compute_s"}

TINY_GPT = ["model.num_layers=2", "model.hidden_dim=128", "model.num_heads=4",
            "model.vocab_size=512", "model.seq_len=128", "data.seq_len=128",
            "data.vocab_size=512", "data.global_batch_size=16",
            "trainer.grad_accum=2", "model.attention=dense",
            "precision.policy=fp32"]
CASES = {
    "mlp": ("mnist_mlp", ["model.hidden_sizes=64,32",
                          "data.global_batch_size=16"]),
    "gpt": ("gpt2_medium_zero1", TINY_GPT),
}
LOOP = ["trainer.total_steps=5", "trainer.log_every=1",
        "trainer.eval_every=0", "trainer.eval_steps=2",
        "optimizer.warmup_steps=1"]


def _records(workdir, name):
    with open(workdir / name / "metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


def _run_pair(tmp_path, family, extra=()):
    name, overrides = CASES[family]
    ov = overrides + LOOP + list(extra)
    jcfg, _ = recipe_pair(name, ov + [f"workdir={tmp_path / 'jax'}"])
    _, tcfg = recipe_pair(name, ov + [f"workdir={tmp_path / 'port'}"])
    jt = JaxTrainer(jcfg)
    jstate = jt.init_state()
    params = jax.device_get(jstate.params)
    sd = (mlp_params_from_jax(params) if family == "mlp"
          else params_from_jax(params, tcfg.model))
    tt = Trainer(tcfg, device="cpu")
    tstate = TrainState.create(sd, tt.tx, with_ema=tcfg.trainer.ema_decay > 0,
                               device="cpu")
    jstate, _ = jt.fit(jstate)
    tstate, _ = tt.fit(tstate)
    return (jt, jstate, _records(tmp_path / "jax", name)), (
        tt, tstate, _records(tmp_path / "port", name))


@pytest.mark.parametrize("family", sorted(CASES))
def test_fit_matches_jax(tmp_path, family):
    (jt, jstate, jrec), (tt, tstate, trec) = _run_pair(tmp_path, family)
    tol = TRAIN_TOL["fp32"]
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] == [
        1, 2, 3, 4, 5]
    for j, t in zip(jrec, trec):
        assert set(t) == set(j) - ONLY_JAX, (set(t) ^ set(j))
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6, atol=1e-9)
        for k in set(t) - TIMING - {"step", "lr"}:
            np.testing.assert_allclose(t[k], j[k], rtol=tol["loss"],
                                       err_msg=f"step {t['step']} {k}")
    assert tstate.step == int(jax.device_get(jstate.step)) == 5
    jev = {k: float(v) for k, v in jt.evaluate(jstate).items()}
    tev = tt.evaluate(tstate)
    assert tev.keys() == jev.keys()
    for k in jev:
        np.testing.assert_allclose(tev[k], jev[k], rtol=tol["loss"])


def test_evaluate_on_the_ema_matches_jax(tmp_path):
    """With ``trainer.ema_decay`` both trainers keep an EMA, update it
    every step and evaluate on it, not on the live params."""
    (jt, jstate, _), (tt, tstate, _) = _run_pair(
        tmp_path, "mlp", ["trainer.ema_decay=0.5"])
    assert tstate.ema_params is not None
    jev = {k: float(v) for k, v in jt.evaluate(jstate).items()}
    tev = tt.evaluate(tstate)
    for k in jev:
        np.testing.assert_allclose(tev[k], jev[k],
                                   rtol=TRAIN_TOL["fp32"]["loss"])
    live = tt.evaluate(TrainState(step=tstate.step, params=tstate.params,
                                  opt_state=tstate.opt_state))
    assert live["eval_loss"] != tev["eval_loss"]


def test_label_range_refusal_matches_jax():
    overrides = ["data.num_classes=5"]
    jcfg, tcfg = recipe_pair("mnist_mlp", overrides)
    with pytest.raises(ValueError) as jerr:
        JaxTrainer(jcfg)
    with pytest.raises(ValueError) as terr:
        Trainer(tcfg, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "data.num_classes=5 != model.num_classes=10" in str(terr.value)
