"""The port's checkpoints (frl_distributed_ml_scaffold_tpu_torch/
checkpoint/manager.py) through its ``Trainer`` on the CPU, at a tiny
``mnist_mlp``: the reference's commit-marker protocol (torn writes
skipped, a corrupt committed step falls back down the chain,
``max_to_keep``, EMA bridging), async saves that snapshot the state the
step then updates in place, resume bit-equal to the uninterrupted run,
and a SIGTERM during ``fit``. The format is the port's own, so these hold
the port to itself and to the JAX package's protocol, not to its
files."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import json
import os
import signal

import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch import faults
from frl_distributed_ml_scaffold_tpu_torch.checkpoint.manager import (
    Checkpointer,
    StateMismatch,
)
from frl_distributed_ml_scaffold_tpu_torch.config import (
    apply_overrides,
    get_config,
)
from frl_distributed_ml_scaffold_tpu_torch.faults import FaultPlan
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
from frl_distributed_ml_scaffold_tpu_torch.utils.trees import tree_leaves


def _cfg(tmp_path, *extra):
    return apply_overrides(get_config("mnist_mlp"), [
        "model.hidden_sizes=32", "data.global_batch_size=8",
        "trainer.total_steps=6", "trainer.log_every=1",
        "trainer.eval_every=0", "optimizer.warmup_steps=1",
        "checkpoint.enabled=true", "checkpoint.save_every=2",
        f"workdir={tmp_path}", *extra])


def _ckpt_dir(cfg):
    return os.path.join(cfg.workdir, cfg.name, "ckpt")


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert a.opt_state["count"] == b.opt_state["count"]
    la, lb = list(tree_leaves(a.params)), list(tree_leaves(b.params))
    la += list(tree_leaves(a.opt_state)) + list(tree_leaves(a.ema_params))
    lb += list(tree_leaves(b.opt_state)) + list(tree_leaves(b.ema_params))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def _records(cfg):
    with open(os.path.join(cfg.workdir, cfg.name, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("async_save", [True, False])
def test_save_restore_round_trip_is_bit_equal(tmp_path, async_save):
    cfg = _cfg(tmp_path, f"checkpoint.async_save={async_save}",
               "trainer.ema_decay=0.9")
    t = Trainer(cfg, device="cpu")
    state, _ = t.fit(num_steps=3)
    ck = t.checkpointer
    assert ck.all_steps() == [2, 3]
    restored = ck.restore(t.state_shapes, device="cpu")
    _assert_states_equal(restored, state)
    meta = ck.meta(3)
    payload = sum(x.nbytes for x in tree_leaves(
        [state.params, state.opt_state, state.ema_params]) if
        isinstance(x, torch.Tensor)) + 8  # + the int64 step
    assert meta["step"] == 3 and meta["payload_bytes"] == payload
    params = ck.restore_params_only(t.state_shapes, 2, device="cpu")
    assert params.keys() == state.params.keys()
    ck.close()


@pytest.mark.parametrize("async_save", [True, False])
def test_resumed_fit_equals_the_uninterrupted_fit(tmp_path, async_save):
    """``fit`` for 6 steps equals ``fit`` for 3 and then a new
    ``Trainer`` resumed to 6, bit for bit: params, moments, metrics."""
    opt = f"checkpoint.async_save={async_save}"
    full = _cfg(tmp_path / "full", opt, "checkpoint.save_every=3")
    whole, _ = Trainer(full, device="cpu").fit()
    part = _cfg(tmp_path / "part", opt, "checkpoint.save_every=3")
    Trainer(part, device="cpu").fit(num_steps=3)
    resumed = Trainer(part, device="cpu")
    state, _ = resumed.fit()
    _assert_states_equal(state, whole)
    want = {r["step"]: r for r in _records(full)}
    got = _records(part)
    assert [r["step"] for r in got] == [1, 2, 3, 4, 5, 6]
    for r in got:
        for k in ("loss", "grad_norm", "lr", "accuracy"):
            assert r[k] == want[r["step"]][k], (r["step"], k)


def test_torn_write_is_skipped(tmp_path):
    """A torn write at the third save (step 6) leaves the step directory
    without a marker: ``latest_step`` skips it, ``restore_or_init``
    resumes from step 4 and the directory stays on disk."""
    cfg = _cfg(tmp_path, "checkpoint.async_save=false")
    with faults.active(FaultPlan([dict(site="checkpoint.torn_write",
                                       at=3)])):
        Trainer(cfg, device="cpu").fit()
    fresh = Trainer(cfg, device="cpu")
    ck = fresh.checkpointer
    assert ck.all_steps(include_uncommitted=True) == [2, 4, 6]
    assert ck.all_steps() == [2, 4] and ck.latest_step() == 4
    assert ck.uncommitted_steps() == [6]
    assert os.path.isdir(os.path.join(_ckpt_dir(cfg), "6"))
    assert ck.restore_or_init(fresh).step == 4
    assert ck.corrupt_steps == []
    state, _ = fresh.fit()
    assert state.step == 6


def test_corrupt_committed_step_falls_back_down_the_chain(tmp_path):
    cfg = _cfg(tmp_path)
    Trainer(cfg, device="cpu").fit()
    victim = os.path.join(_ckpt_dir(cfg), "6", "state.pt")
    with open(victim, "r+b") as fh:
        fh.truncate(3)
    fresh = Trainer(cfg, device="cpu")
    assert fresh.checkpointer.latest_step() == 6
    restored = fresh.checkpointer.restore_or_init(fresh)
    assert restored.step == 4
    assert fresh.checkpointer.corrupt_steps == [6]
    assert os.path.isdir(os.path.join(_ckpt_dir(cfg), "6"))


def test_max_to_keep_keeps_the_newest_committed_steps(tmp_path):
    cfg = _cfg(tmp_path, "checkpoint.save_every=1", "checkpoint.max_to_keep=2")
    Trainer(cfg, device="cpu").fit()
    ck = Checkpointer(_ckpt_dir(cfg), cfg.checkpoint)
    assert ck.all_steps(include_uncommitted=True) == [5, 6]
    assert sorted(os.listdir(os.path.join(_ckpt_dir(cfg), "commits"))) == [
        "step_5", "step_6"]


def test_ema_is_bridged_across_a_resume(tmp_path):
    """A checkpoint without an EMA restores into a trainer that keeps
    one (seeded from the restored params), and one with an EMA into a
    trainer that keeps none (dropped)."""
    plain = _cfg(tmp_path)
    t = Trainer(plain, device="cpu")
    state, _ = t.fit(num_steps=2)
    with_ema = Trainer(_cfg(tmp_path, "trainer.ema_decay=0.9"), device="cpu")
    bridged = with_ema.checkpointer.restore_or_init(with_ema)
    assert bridged.step == 2 and with_ema.checkpointer.corrupt_steps == []
    for k, p in state.params.items():
        assert torch.equal(bridged.ema_params[k], p)
        assert bridged.ema_params[k].data_ptr() != bridged.params[k].data_ptr()
    bridged, _ = with_ema.fit(bridged, num_steps=4)
    again = Trainer(plain, device="cpu")
    dropped = again.checkpointer.restore_or_init(again)
    assert dropped.step == 4 and dropped.ema_params is None
    for k, p in bridged.params.items():
        assert torch.equal(dropped.params[k], p)


def test_async_save_is_not_changed_by_the_next_step(tmp_path):
    """``save`` returns before the write; the step after it updates the
    params and moments in place, and the checkpoint still holds the
    state as it was at the save."""
    cfg = _cfg(tmp_path)
    t = Trainer(cfg, device="cpu")
    state = t.init_state()
    for step in range(2):
        state, _ = t.train_step(state, t.pipeline.global_batch(step))
    before = {k: p.clone() for k, p in state.params.items()}
    mu = {k: m.clone() for k, m in state.opt_state["mu"].items()}
    assert t.checkpointer.save(2, state)
    state, _ = t.train_step(state, t.pipeline.global_batch(2))
    assert any(not torch.equal(state.params[k], p) for k, p in before.items())
    t.checkpointer.wait()
    restored = t.checkpointer.restore(t.state_shapes, device="cpu")
    assert restored.step == 2 and restored.opt_state["count"] == 2
    for k, p in before.items():
        assert torch.equal(restored.params[k], p)
        assert torch.equal(restored.opt_state["mu"][k], mu[k])
    t.pipeline.close()


def test_save_skips_old_steps_and_refuses_to_overwrite(tmp_path):
    cfg = _cfg(tmp_path)
    t = Trainer(cfg, device="cpu")
    state = t.init_state()
    ck = t.checkpointer
    assert ck.save(4, state)
    assert not ck.save(4, state) and not ck.save(2, state)
    with pytest.raises(ValueError, match="already exists"):
        ck.save(4, state, force=True)
    ck.wait()
    assert ck.all_steps() == [4]
    other = Trainer(_cfg(tmp_path, "model.hidden_sizes=16"), device="cpu")
    with pytest.raises(StateMismatch, match="mismatches"):
        other.checkpointer.restore(other.state_shapes, device="cpu")
    assert other.checkpointer.restore_or_init(other).step == 0
    assert other.checkpointer.corrupt_steps == [4]


def test_sigterm_during_fit_checkpoints_and_exits_cleanly(tmp_path):
    """SIGTERM at step 2: the step in flight finishes, a forced
    checkpoint of step 3 commits, ``fit`` returns the preempted record
    and the previous handler is back; a new run resumes at step 3."""
    cfg = _cfg(tmp_path, "checkpoint.save_every=100")
    prev = signal.getsignal(signal.SIGTERM)

    def kill(step, metrics):
        assert isinstance(metrics["loss"], torch.Tensor)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    t = Trainer(cfg, device="cpu")
    state, last = t.fit(on_step=kill)
    assert last["event"] == "preempted" and last["step"] == 3
    assert state.step == 3 and t.checkpointer.latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is prev
    state, _ = Trainer(cfg, device="cpu").fit()
    assert state.step == 6
    assert [r["step"] for r in _records(cfg)] == [1, 2, 3, 3, 4, 5, 6]


def test_a_failed_async_write_is_never_committed(tmp_path, monkeypatch):
    from frl_distributed_ml_scaffold_tpu_torch.checkpoint import manager

    cfg = _cfg(tmp_path)
    t = Trainer(cfg, device="cpu")
    state = t.init_state()
    ck = t.checkpointer

    def broken(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(manager.torch, "save", broken)
    assert ck.save(2, state)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.close()
    assert ck.all_steps(include_uncommitted=True) == []
    assert not os.path.exists(os.path.join(_ckpt_dir(cfg), "commits"))
