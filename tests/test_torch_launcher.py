"""The port's launcher (``python -m frl_distributed_ml_scaffold_tpu_torch.
launcher.launch``) on the CPU: its config registry and errors against the
JAX launcher's, the card by default (no silent CPU run), the refused
flags, ``--describe``, ``--eval-only`` after a run, and ``mnist_mlp`` end
to end with its loss halved."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from frl_distributed_ml_scaffold_tpu.config import apply_overrides as japply
from frl_distributed_ml_scaffold_tpu.config import get_config as jget
from frl_distributed_ml_scaffold_tpu_torch.config import list_configs
from frl_distributed_ml_scaffold_tpu_torch.launcher import launch

REPO = Path(__file__).resolve().parents[1]
MODULE = "frl_distributed_ml_scaffold_tpu_torch.launcher.launch"
TINY = ["model.hidden_sizes=32", "data.global_batch_size=16",
        "trainer.eval_every=0"]


def _records(workdir, name="mnist_mlp"):
    with open(Path(workdir) / name / "metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


def test_list_configs_is_the_port_registry(capsys):
    assert launch.main(["--list-configs"]) == 0
    assert capsys.readouterr().out.split() == list_configs()
    assert "mnist_mlp" in list_configs()
    assert launch.main([]) == 2


def test_unknown_config_or_field_fails_as_the_jax_launcher():
    with pytest.raises(KeyError) as jerr:
        jget("nope")
    with pytest.raises(KeyError) as terr:
        launch.main(["--config=nope", "--device=cpu"])
    prefix = "unknown config 'nope'; available: "
    assert str(jerr.value).startswith('"' + prefix)
    assert str(terr.value) == repr(prefix + str(list_configs()))
    with pytest.raises(KeyError) as jerr:
        japply(jget("mnist_mlp"), ["trainer.bogus=1"])
    with pytest.raises(KeyError) as terr:
        launch.main(["--config=mnist_mlp", "--device=cpu", "trainer.bogus=1"])
    assert str(terr.value) == str(jerr.value)


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--config=mnist_mlp", f"workdir={tmp_path}", *TINY])
    assert not (tmp_path / "mnist_mlp" / "metrics.jsonl").exists()
    out = subprocess.run(
        [sys.executable, "-m", MODULE, "--config=mnist_mlp",
         f"workdir={tmp_path}"], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not (tmp_path / "mnist_mlp" / "metrics.jsonl").exists()


@pytest.mark.parametrize("flags,exc,match", [
    (["--elastic"], NotImplementedError, "ROADMAP A13"),
    (["--coordinator=localhost:1234"], ValueError, "without a process count"),
    (["--num-processes=2"], ValueError, "needs a process id"),
    (["--process-id=2", "--num-processes=2", "--coordinator=localhost:1"],
     ValueError, "out of range"),
    (["--sim-devices=8", "--device=cuda"], ValueError, "--device=cpu"),
    (["--hlo-dump=/tmp/hlo"], NotImplementedError, "no XLA")])
def test_unported_flags_are_refused(flags, exc, match):
    """What stays unported names its ROADMAP item; the distributed flags
    (ported) refuse an incomplete or inconsistent topology."""
    with pytest.raises(exc, match=match):
        launch.main(["--config=mnist_mlp", "--device=cpu", *flags])


def test_sanitizer_variable_is_refused(monkeypatch):
    monkeypatch.setenv("FRL_TPU_SANITIZE", "nans")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        launch.main(["--config=mnist_mlp", "--device=cpu"])


def test_describe_is_a_dry_run(tmp_path, capsys):
    assert launch.main(["--config=mnist_mlp", "--device=cpu", "--describe",
                        f"workdir={tmp_path}", *TINY]) == 0
    out = capsys.readouterr().out
    assert "dense.0.weight" in out and "total params: 0.03M" in out
    assert "flop_counter" in out
    assert not (tmp_path / "mnist_mlp").exists()


def test_mnist_trains_end_to_end_then_evaluates(tmp_path):
    """``mnist_mlp`` through ``main`` on the CPU: the loss falls by half,
    the checkpoint commits, and ``--eval-only`` restores and evaluates."""
    args = ["--config=mnist_mlp", "--device=cpu", f"workdir={tmp_path}",
            *TINY, "trainer.total_steps=40", "trainer.log_every=5",
            "checkpoint.enabled=true", "checkpoint.save_every=20"]
    assert launch.main(args) == 0
    rec = _records(tmp_path)
    assert [r["step"] for r in rec] == list(range(5, 45, 5))
    assert rec[-1]["loss"] < 0.5 * rec[0]["loss"]
    for name in ("config.json", "telemetry.jsonl", "metrics.prom",
                 "trace_events.json"):
        assert (tmp_path / "mnist_mlp" / name).exists(), name
    assert sorted((tmp_path / "mnist_mlp" / "ckpt" / "commits").iterdir()
                  ) == [tmp_path / "mnist_mlp" / "ckpt" / "commits" / s
                        for s in ("step_20", "step_40")]
    assert launch.main(args + ["--eval-only"]) == 0
    with pytest.raises(RuntimeError, match="needs checkpoint.enabled"):
        launch.main(["--config=mnist_mlp", "--device=cpu", "--eval-only",
                     f"workdir={tmp_path / 'none'}", *TINY])
