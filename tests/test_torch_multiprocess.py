"""The port's launcher over two CPU processes (gloo): the counterpart of
the JAX package's ``tests/test_multiprocess.py``.

``mnist_mlp`` with its params split over ``fsdp`` (every Dense kernel of
1024 elements or more) trains in two ``launch`` processes
(``--device=cpu --num-processes=2 --process-id=i --coordinator=file://``)
to a checkpoint at step 10, then resumes to step 20. Held, exactly:

- rank 0 alone logs and writes ``metrics.jsonl`` (one record per log
  boundary) and the checkpoints (whole, gathered from both ranks);
- ``--sim-devices=2`` (one command: rank 0 starts rank 1) trains 0 to 20
  in one go with the same losses at every record, and the same params at
  step 20, bit for bit, as the run that stopped at 10 and resumed;
- the two-rank checkpoint at step 10 restores in one process (the whole
  state, as saved), which trains on to step 12; its params there equal
  those of a ``Trainer`` in this process that restores the same
  checkpoint and takes the same two steps, bit for bit.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.checkpoint.manager import (
    Checkpointer,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

REPO = Path(__file__).resolve().parents[1]
MODULE = "frl_distributed_ml_scaffold_tpu_torch.launcher.launch"
OV = ["data.global_batch_size=32", "trainer.log_every=5",
      "trainer.eval_every=0", "checkpoint.enabled=true",
      "checkpoint.save_every=10", "parallel.param_sharding=fsdp",
      "mesh.data=1", "mesh.fsdp=-1", "data.prefetch=0"]


def _launch(workdir, steps: int, *flags):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "FRL_TPU_INIT_TIMEOUT_S": "90"}
    return subprocess.Popen(
        [sys.executable, "-m", MODULE, "--config=mnist_mlp", "--device=cpu",
         *flags, f"workdir={workdir}", f"trainer.total_steps={steps}", *OV],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)


def _wait(procs) -> list[str]:
    outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _two(workdir, steps, rdv):
    return [_launch(workdir, steps, "--num-processes=2", f"--process-id={i}",
                    f"--coordinator=file://{rdv}") for i in range(2)]


def _records(workdir) -> list[dict]:
    with open(workdir / "mnist_mlp" / "metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


def _params(workdir, step) -> dict:
    return torch.load(workdir / "mnist_mlp" / "ckpt" / str(step) / "state.pt",
                      weights_only=True)["params"]


def test_two_processes_train_checkpoint_and_resume(tmp_path):
    resumed, sim, one = tmp_path / "resumed", tmp_path / "sim", tmp_path / "one"
    outs = _wait(_two(resumed, 10, tmp_path / "rdv0"))
    assert "step=10" in outs[0] and "step=" not in outs[1]
    assert [r["step"] for r in _records(resumed)] == [5, 10]
    shutil.copytree(resumed, one)
    procs = _two(resumed, 20, tmp_path / "rdv1") + [
        _launch(sim, 20, "--sim-devices=2"),
        _launch(one, 12)]
    _wait(procs)
    # Rank 0 alone wrote: one record per boundary, whole checkpoints.
    got, want = _records(resumed), _records(sim)
    assert [r["step"] for r in got] == [5, 10, 15, 20]
    assert [r["step"] for r in want] == [5, 10, 15, 20]
    for g, w in zip(got, want):
        assert g["loss"] == w["loss"] and g["grad_norm"] == w["grad_norm"]
    p_resumed, p_sim = _params(resumed, 20), _params(sim, 20)
    for k, v in p_sim.items():
        assert torch.equal(p_resumed[k], v), k
    steps = sorted(int(d) for d in os.listdir(resumed / "mnist_mlp" / "ckpt")
                   if d.isdigit())
    assert steps == [10, 20]
    # The two-rank checkpoint restores in one process and trains on.
    cfg = tconfig.apply_overrides(tconfig.get_config("mnist_mlp"), OV + [
        f"workdir={tmp_path / 'here'}", "trainer.total_steps=12"])
    here = Trainer(cfg, device="cpu")
    ck = Checkpointer(str(tmp_path / "resumed" / "mnist_mlp" / "ckpt"),
                      cfg.checkpoint)
    state = ck.restore(here.state_shapes, 10, device="cpu")
    assert state.step == 10
    for k, v in _params(one, 10).items():
        assert torch.equal(state.params[k], v), k
    for step in (10, 11):
        state, _ = here.train_step(state, here.pipeline.global_batch(step))
    for k, v in _params(one, 12).items():
        assert torch.equal(state.params[k], v), k
