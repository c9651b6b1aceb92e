"""The port's elastic supervisor (``launcher/elastic.py``) in one process
on the CPU: the counterpart of the JAX package's ``tests/test_elastic.py``
supervisor tier.

- The fault hook: one-shot through its marker, the KILL (``os._exit(43)``)
  and TERM (SIGTERM to itself) shapes, a bad ``FRL_FAULT_SIGNAL``
  refused, the ``--sim-devices`` ranks killed before the hard exit;
  SIGTERM through it preempts the loop, which checkpoints and resumes
  with no step repeated or lost.
- ``_child_command`` re-execs the port's launcher; on a re-formed world
  (a shrink, driven through ``supervise`` with recorded children) the
  port's child, like the JAX supervisor's, ends with
  ``checkpoint.restore_redistribute=true`` (a restore through the
  redistribution service), and the commands are the same; the
  supervisor's Prometheus sidecar has the JAX supervisor's series.
- A supervised ``mnist_mlp`` (children are real launcher processes)
  killed after step 9 and resumed: rc 0, steps [4, 8, 12] once each,
  child exit codes [43, 0] and the JAX test's spans; the final params
  equal, bit for bit, an unkilled port run's; both start from one flax
  msgpack of the JAX init (``trainer.init_params_path``), and the losses
  at steps 4, 8 and 12 are within 1e-5 (relative, fp32) of the JAX
  ``Trainer``'s uninterrupted run.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import argparse
import functools
import json
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _jit import jit_init
from _torch_parity import recipe_pair

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.launcher import elastic as jelastic
from frl_distributed_ml_scaffold_tpu.models.mlp import MLP as JaxMLP
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer as JaxTrainer
from frl_distributed_ml_scaffold_tpu_torch.launcher import elastic
from frl_distributed_ml_scaffold_tpu_torch.launcher import launch
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

OV = ["trainer.total_steps=12", "trainer.log_every=4", "trainer.eval_every=0",
      "data.global_batch_size=64", "model.hidden_sizes=32",
      "precision.policy=fp32", "checkpoint.save_every=4",
      "checkpoint.async_save=false", "elastic.backoff_s=0.1"]
LOSS_RTOL = 1e-5


def _records(run_dir) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture
def no_fault_env(monkeypatch):
    for var in ("FRL_FAULT_AT_STEP", "FRL_FAULT_SIGNAL", "FRL_STEP_DELAY_S"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_fault_hook_kill_term_and_one_shot(tmp_path, no_fault_env):
    mp = no_fault_env
    _, cfg = recipe_pair("mnist_mlp", OV + [f"workdir={tmp_path}"])
    assert elastic.fault_hook_from_env(cfg) is None
    mp.setenv("FRL_STEP_DELAY_S", "0.01")
    assert elastic.fault_hook_from_env(cfg) is not None
    mp.delenv("FRL_STEP_DELAY_S")
    mp.setenv("FRL_FAULT_SIGNAL", "HUP")
    mp.setenv("FRL_FAULT_AT_STEP", "4")
    with pytest.raises(ValueError, match="FRL_FAULT_SIGNAL='HUP'"):
        elastic.fault_hook_from_env(cfg)
    died = []

    class Died(Exception):
        pass

    def fake_exit(code):
        died.append(code)
        raise Died

    mp.setattr(elastic.os, "_exit", fake_exit)
    mp.setattr(elastic.os, "kill", lambda pid, sig: died.append(sig))
    marker = tmp_path / cfg.name / "fault_injected"
    for sig, want in (("KILL", elastic.FAULT_EXIT_CODE),
                      ("TERM", signal.SIGTERM)):
        if marker.exists():
            marker.unlink()
        mp.setenv("FRL_FAULT_SIGNAL", sig)
        hook = elastic.fault_hook_from_env(cfg)
        hook(0, {})  # not the fault step: survives
        hook(2, {})
        assert died == [] and not marker.exists()
        try:
            hook(3, {})  # step + 1 == 4
        except Died:
            pass
        assert died == [want] and marker.read_text() == "4"
        died.clear()
        # The marker disarms the next process's hook.
        assert elastic.fault_hook_from_env(cfg) is None
    assert elastic.FAULT_EXIT_CODE == jelastic.FAULT_EXIT_CODE == 43


def test_hard_exit_kills_the_sim_ranks_first(tmp_path, no_fault_env):
    """Before its ``os._exit`` the hook runs the launcher's cleanup of a
    ``--sim-devices`` run: the ranks it started are killed and their
    rendezvous file removed (the hard exit runs no ``finally``)."""
    mp = no_fault_env
    _, cfg = recipe_pair("mnist_mlp", OV + [f"workdir={tmp_path}"])
    rank = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(120)"])
    rdv = tmp_path / "rendezvous"
    rdv.write_text("")
    exits = []
    mp.setattr(elastic.os, "_exit", exits.append)
    mp.setenv("FRL_FAULT_AT_STEP", "1")
    hook = elastic.fault_hook_from_env(cfg, before_hard_exit=functools.partial(
        launch._abandon_sim_ranks, [rank], f"file://{rdv}"))
    try:
        hook(0, {})
        assert exits == [elastic.FAULT_EXIT_CODE]
        assert rank.poll() is not None and not rdv.exists()
    finally:
        if rank.poll() is None:
            rank.kill()
            rank.wait()


def test_sigterm_through_the_hook_preempts_and_resumes(tmp_path,
                                                       no_fault_env):
    """``FRL_FAULT_SIGNAL=TERM`` after step 5: the loop finishes the step,
    checkpoints at 5 and returns; a fresh run resumes from 5."""
    mp = no_fault_env
    mp.setenv("FRL_FAULT_AT_STEP", "5")
    mp.setenv("FRL_FAULT_SIGNAL", "TERM")
    _, cfg = recipe_pair("mnist_mlp", [
        "trainer.total_steps=10", "trainer.log_every=2",
        "trainer.eval_every=0", "data.global_batch_size=32",
        "model.hidden_sizes=32", "checkpoint.enabled=true",
        "checkpoint.save_every=100", "checkpoint.async_save=false",
        f"workdir={tmp_path}"])
    handler_before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(cfg, device="cpu")
    state, last = trainer.fit(on_step=elastic.fault_hook_from_env(cfg))
    assert int(state.step) == 5 and last.get("event") == "preempted"
    assert trainer.checkpointer.latest_step() == 5
    assert signal.getsignal(signal.SIGTERM) is handler_before
    trainer.checkpointer.close()
    resumed = Trainer(cfg, device="cpu")
    state, _ = resumed.fit(on_step=elastic.fault_hook_from_env(cfg))
    resumed.checkpointer.close()
    assert int(state.step) == 10
    assert [r["step"] for r in _records(tmp_path / cfg.name)] == [
        2, 4, 5, 6, 8, 10]


class _Child:
    """A recorded child: its command line, and the exit code it returns
    at once."""

    def __init__(self, log, codes, cmd, **kwargs):
        log.append(list(cmd))
        self.rc = codes.pop(0)

    def wait(self):
        return self.rc

    def terminate(self):
        pass


def _shrink_through_supervise(mod, parse, tmp_path, monkeypatch) -> tuple:
    """``mod.supervise`` as host 1 of two whose peer never beats: the
    first child fails, the settled survivor set is this host alone, and
    the supervisor re-forms a world of one whose child exits 0."""
    log, codes = [], [1, 0]
    monkeypatch.setattr(mod.subprocess, "Popen",
                        lambda cmd, **kw: _Child(log, codes, cmd, **kw))
    monkeypatch.setenv("FRL_TPU_HOST_ADDRESS", "127.0.0.1")
    overrides = OV + ["elastic.shrink_after=1", "elastic.peer_timeout_s=2",
                      f"workdir={tmp_path}"]
    args = argparse.Namespace(
        config="mnist_mlp", device="cpu", sim_devices=0,
        coordinator="127.0.0.1:1", num_processes=2, process_id=1,
        overrides=overrides)
    assert mod.supervise(args, parse(overrides)) == 0
    run_dir = tmp_path / "mnist_mlp"
    with open(run_dir / "supervisor_1.prom") as fh:
        prom = fh.read()
    with open(run_dir / "supervisor_1_trace.json") as fh:
        spans = [e for e in json.load(fh)["traceEvents"] if e["ph"] == "X"]
    return log, prom, spans


def _series(prom: str) -> dict:
    return dict(line.rsplit(" ", 1) for line in prom.splitlines()
                if line and not line.startswith("#"))


def test_reformed_child_and_sidecar_against_jax(tmp_path, monkeypatch):
    jcmds, jprom, jspans = _shrink_through_supervise(
        jelastic, lambda ov: recipe_pair("mnist_mlp", ov)[0],
        tmp_path / "jax", monkeypatch)
    tcmds, tprom, tspans = _shrink_through_supervise(
        elastic, lambda ov: recipe_pair("mnist_mlp", ov)[1],
        tmp_path / "port", monkeypatch)
    assert tcmds[0][1:3] == ["-m", launch.MODULE]
    assert tcmds[0][3:7] == ["--config", "mnist_mlp", "--device", "cpu"]
    assert tcmds[0][-2:] == ["checkpoint.enabled=true",
                             "checkpoint.resume=true"]
    # The world of one: rank 0, no coordinator, the restore through the
    # redistribution service, as JAX's.
    assert "--coordinator" not in tcmds[1]
    assert tcmds[1][7:11] == ["--num-processes", "1", "--process-id", "0"]
    assert not any("restore_redistribute" in a for a in tcmds[0])
    assert tcmds[1][-1] == "checkpoint.restore_redistribute=true"
    assert jcmds[1][-1] == "checkpoint.restore_redistribute=true"
    swap = lambda c: [a.replace(jelastic.__name__.rsplit(".", 1)[0],  # noqa
                                elastic.__name__.rsplit(".", 1)[0])
                      for a in c if "workdir=" not in a]
    assert [swap(c) for c in jcmds] == [swap(c) for c in tcmds]
    jseries, tseries = _series(jprom), _series(tprom)
    assert sorted(tseries) == sorted(jseries)
    for name in ("elastic_membership_changes_total", "elastic_shrinks_total",
                 "elastic_grows_total", "elastic_restarts_total",
                 "elastic_world_size", "heartbeat_write_failures_total"):
        assert float(tseries[name]) == float(jseries[name]), name
    assert float(tseries["elastic_world_size"]) == 1.0
    assert ([(e["name"], e["args"].get("rc")) for e in tspans]
            == [(e["name"], e["args"].get("rc")) for e in jspans])


def _jax_init_file(path) -> None:
    tree = jit_init(JaxMLP(jschema.MLPConfig(hidden_sizes=(32,)),
                           jax_policy("fp32")), jnp.zeros((1, 784)),
                    train=False)["params"]
    path.write_bytes(serialization.to_bytes(tree))


def test_supervised_kill_and_resume_against_unkilled_and_jax(tmp_path,
                                                             no_fault_env):
    mp = no_fault_env
    init = tmp_path / "init.msgpack"
    _jax_init_file(init)
    ov = OV + [f"trainer.init_params_path={init}"]
    jcfg, _ = recipe_pair("mnist_mlp", ov + [f"workdir={tmp_path / 'jax'}"])
    sup_ov = ov + [f"workdir={tmp_path / 'sup'}"]
    _, tcfg = recipe_pair("mnist_mlp", sup_ov)
    mp.setenv("FRL_FAULT_AT_STEP", "9")
    mp.setenv("OMP_NUM_THREADS", "1")  # the children's, as this process's
    args = launch._parse_args(["--config=mnist_mlp", "--device=cpu",
                               "--elastic", *sup_ov])
    assert elastic.supervise(args, tcfg) == 0

    run_dir = tmp_path / "sup" / "mnist_mlp"
    assert (run_dir / "fault_injected").exists()
    recs = _records(run_dir)
    assert [r["step"] for r in recs] == [4, 8, 12]
    with open(run_dir / "supervisor_0.prom") as fh:
        assert _series(fh.read())["elastic_restarts_total"] == "1"
    with open(run_dir / "supervisor_0_trace.json") as fh:
        spans = [e for e in json.load(fh)["traceEvents"] if e["ph"] == "X"]
    assert [e["args"]["rc"] for e in spans if e["name"] == "child_run"] == [
        43, 0]
    assert [e["name"] for e in spans].count("restart_wait") == 1
    roots = [e for e in spans if e["name"] == "supervise"]
    assert len(roots) == 1
    assert all(e["args"]["parent"] == roots[0]["args"]["span"]
               for e in spans if e is not roots[0])

    # The unkilled port run from the same file, in this process.
    mp.delenv("FRL_FAULT_AT_STEP")
    _, plain = recipe_pair("mnist_mlp", ov + [f"workdir={tmp_path / 'one'}",
                                              "checkpoint.enabled=false"])
    state, _ = Trainer(plain, device="cpu").fit()
    saved = torch.load(run_dir / "ckpt" / "12" / "state.pt",
                       weights_only=True)["params"]
    assert saved.keys() == state.params.keys()
    for k, v in state.params.items():
        assert torch.equal(saved[k], v), k

    JaxTrainer(jcfg).fit()
    jrecs = _records(tmp_path / "jax" / "mnist_mlp")
    assert [r["step"] for r in jrecs] == [4, 8, 12]
    np.testing.assert_allclose([r["loss"] for r in recs],
                               [r["loss"] for r in jrecs], rtol=LOSS_RTOL)
