"""Checkpoint manager: the port of the JAX package's
``checkpoint/manager.py``, on ``torch.save`` in one process.

Format. ``<directory>/<step>/state.pt`` is one ``torch.save`` file of
``{"step": int64 tensor, "params", "opt_state", "extras",
"ema_params"}`` (the ``TrainState``'s fields; the optimizer's count stays
a Python int), beside ``meta.json`` (the step, the tensor payload's
bytes, the seconds the snapshot and the write took). A step is written
into ``<step>.tmp.<pid>`` and renamed into place once its bytes are
flushed to disk. ``torch.distributed.checkpoint`` was not used: the port
has one process, and one file per step is all that one process needs.

Checkpoints do not cross packages: the port cannot read the JAX
package's Orbax directories, and the JAX package cannot read these.
Parameters cross through ``models/convert.py``.

Crash consistency, as the reference's: a checkpoint only counts once its
commit marker ``commits/step_<N>`` exists, published by write-temp plus
rename after the step's bytes are complete. ``latest_step`` /
``all_steps`` judge committed steps only, so a write torn by a crash
(step directory present, marker absent) is skipped, reported by
``uncommitted_steps`` and never deleted. ``restore_or_init`` also
survives damage a marker cannot see: a committed step that fails to
load is recorded in ``corrupt_steps`` (its directory left in place) and
the restore falls back down the committed chain. Unlike the reference, a
directory without ``commits/`` holds no committed step: the port has
never written a checkpoint without markers.

Async saves. The train step updates the state in place
(``trainer/train_step.py``), so ``save`` snapshots the state before it
returns: tensors on the card are copied into pinned host buffers on the
current stream (ordered before any later step's in-place update, and
waited for by the writer through an event), tensors on the CPU are
cloned. A background thread writes the snapshot; the step is committed
at the next ``save`` / ``wait`` / ``close``, once the write has
returned. ``max_to_keep`` keeps the newest committed steps and deletes
older committed ones when a step commits.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import time
from typing import Any

import torch

from frl_distributed_ml_scaffold_tpu_torch import faults, resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import CheckpointConfig
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import TrainState
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import (
    get_logger,
    is_primary_process,
)
from frl_distributed_ml_scaffold_tpu_torch.utils.trees import tree_size_bytes

STATE_FILE = "state.pt"
META_FILE = "meta.json"


class StateMismatch(ValueError):
    """A checkpoint whose tree differs from the trainer's state."""


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _state_tree(state: TrainState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state,
            "extras": state.extras, "ema_params": state.ema_params}


def _check_tree(raw: dict, want: dict, step: int) -> None:
    """Raise ``StateMismatch`` unless ``raw`` has the paths, tensor
    shapes and dtypes of ``want``, and non-tensor leaves where ``want``
    has them."""
    got, want = _flatten(raw), _flatten(want)
    if got.keys() != want.keys():
        missing = sorted(want.keys() - got.keys())[:5]
        extra = sorted(got.keys() - want.keys())[:5]
        raise StateMismatch(f"checkpoint step {step} does not match the "
                            f"state (missing {missing}, unexpected {extra})")
    bad = []
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            if (not isinstance(g, torch.Tensor) or g.shape != w.shape
                    or g.dtype != w.dtype):
                bad.append(f"{k}: {getattr(g, 'shape', g)} "
                           f"{getattr(g, 'dtype', '')} != {tuple(w.shape)} "
                           f"{w.dtype}")
        elif isinstance(g, torch.Tensor):
            bad.append(f"{k}: a tensor where the state has {type(w)}")
    if bad:
        raise StateMismatch(f"checkpoint step {step} mismatches at "
                            + ", ".join(bad[:5]))


class Checkpointer:
    """Async save and restore of a ``TrainState`` (module docstring).

    ``restore_or_init(trainer)`` is the entry the ``Trainer`` uses: the
    newest committed step that loads, restored into the trainer's state
    template on its device, falling back down the committed chain past
    torn or corrupt steps; otherwise a fresh init."""

    def __init__(self, directory: str, cfg: CheckpointConfig):
        if cfg.restore_redistribute:
            raise NotImplementedError(
                "checkpoint.restore_redistribute (a restore through the "
                "redistribution service) is not ported yet (ROADMAP queue "
                "A item 13)"
            )
        self.directory = directory
        self.cfg = cfg
        self.logger = get_logger()
        os.makedirs(directory, exist_ok=True)
        self._commits_dir = os.path.join(directory, "commits")
        # Steps written (or being written) but not yet committed.
        self._uncommitted: list[int] = []
        self._pending: concurrent.futures.Future | None = None
        self._ex: concurrent.futures.ThreadPoolExecutor | None = None
        # Pinned host buffers of the card's tensors, by path, reused by
        # every save (the previous write is finished before they refill).
        self._pinned: dict[str, torch.Tensor] = {}
        #: Committed steps that failed to restore, left on disk.
        self.corrupt_steps: list[int] = []

    # ------------------------------------------------------ commit markers

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _marker(self, step: int) -> str:
        return os.path.join(self._commits_dir, f"step_{int(step)}")

    def _commit(self, step: int) -> None:
        """Publish the marker atomically (write-temp + rename: a reader
        sees a whole marker or none), then drop committed steps past
        ``max_to_keep``. Only the primary process writes."""
        if not is_primary_process():
            return
        os.makedirs(self._commits_dir, exist_ok=True)
        tmp = self._marker(step) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(f"{int(step)}\n")
        os.replace(tmp, self._marker(step))
        keep = self.cfg.max_to_keep
        committed = self.all_steps()
        if keep and keep > 0 and len(committed) > keep:
            for old in committed[:-keep]:
                os.remove(self._marker(old))
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _finish_pending(self) -> None:
        """Wait for the write in flight, then publish the markers of the
        writes now complete. A failed write's exception propagates and
        its step is never committed."""
        pending, self._pending = self._pending, None
        steps, self._uncommitted = self._uncommitted, []
        if pending is not None:
            pending.result()
        for step in steps:
            self._commit(step)

    def is_committed(self, step: int) -> bool:
        return os.path.exists(self._marker(step))

    def _disk_steps(self) -> list[int]:
        """Every complete step directory, committed or not."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def uncommitted_steps(self) -> list[int]:
        """Step directories with no commit marker: torn writes (or a
        write still in flight). Reported, never deleted."""
        return [s for s in self._disk_steps() if not self.is_committed(s)]

    # --------------------------------------------------------------- save

    def _snapshot(self, state: TrainState):
        """(host copy of the state, the event its card copies end with,
        or None)."""
        event_dev = None

        def copy(path: str, x):
            nonlocal event_dev
            if isinstance(x, dict):
                return {k: copy(f"{path}/{k}", v) for k, v in x.items()}
            if not isinstance(x, torch.Tensor):
                return x
            if x.device.type != "cuda":
                return x.detach().clone()
            buf = self._pinned.get(path)
            if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                self._pinned[path] = buf
            buf.copy_(x.detach(), non_blocking=True)
            event_dev = x.device
            return buf

        tree = copy("", _state_tree(state))
        tree["step"] = torch.tensor(int(state.step), dtype=torch.int64)
        event = None
        if event_dev is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(event_dev))
        return tree, event

    def _write(self, step: int, tree: dict, event, snapshot_s: float) -> dict:
        """Write ``tree`` as step ``step``: into a temp directory, flushed
        to disk, then renamed into place."""
        if event is not None:
            event.synchronize()
        t0 = time.perf_counter()
        tmp = self._step_dir(step) + f".tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as fh:
            torch.save(tree, fh)
            fh.flush()
            os.fsync(fh.fileno())
        meta = {"step": int(step), "payload_bytes": tree_size_bytes(tree),
                "snapshot_s": snapshot_s,
                "write_s": time.perf_counter() - t0}
        with open(os.path.join(tmp, META_FILE), "w") as fh:
            json.dump(meta, fh)
        os.rename(tmp, self._step_dir(step))
        return meta

    def save(self, step: int, state: TrainState, *,
             force: bool = False) -> bool:
        """Save ``state`` as step ``step``; returns whether it saved. As
        the reference's manager: without ``force`` a step at or below the
        newest step on disk (committed or not) is skipped; with it, a
        step already on disk raises."""
        self._finish_pending()
        on_disk = self._disk_steps()
        if not force and on_disk and on_disk[-1] >= step:
            return False
        if step in on_disk:
            raise ValueError(f"checkpoint step {step} already exists under "
                             f"{self.directory}")
        if not is_primary_process():
            return True
        t0 = time.perf_counter()
        tree, event = self._snapshot(state)
        snapshot_s = time.perf_counter() - t0
        if faults.fire("checkpoint.torn_write") is not None:
            # Injected torn write: the step directory is complete on disk
            # but a payload file is truncated and NO marker is published,
            # what a crash mid-serialisation leaves behind.
            self._write(step, tree, event, snapshot_s)
            self._tear(step)
            self.logger.warning(
                "fault injection: torn checkpoint write at step %d (file "
                "truncated, commit marker withheld)", step)
            return True
        if self.cfg.async_save:
            if self._ex is None:
                self._ex = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="frl-ckpt-write")
            self._pending = self._ex.submit(self._write, step, tree, event,
                                            snapshot_s)
            self._uncommitted.append(step)
        else:
            self._write(step, tree, event, snapshot_s)
            self._commit(step)
        self.logger.info("checkpoint saved at step %d -> %s", step,
                         self.directory)
        return True

    def _tear(self, step: int) -> None:
        """Truncate the largest file under the step directory to half
        (the shape of a crash mid-write)."""
        victim, size = None, 0
        for root, _, files in os.walk(self._step_dir(step)):
            for name in files:
                p = os.path.join(root, name)
                sz = os.path.getsize(p)
                if sz > size:
                    victim, size = p, sz
        if victim is not None:
            with open(victim, "r+b") as fh:
                fh.truncate(size // 2)

    # ------------------------------------------------------------ queries

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self, *, include_uncommitted: bool = False) -> list[int]:
        steps = self._disk_steps()
        if include_uncommitted:
            return steps
        return [s for s in steps if self.is_committed(s)]

    def meta(self, step: int) -> dict:
        """The step's ``meta.json``: payload bytes and the seconds of
        its snapshot and write."""
        with open(os.path.join(self._step_dir(step), META_FILE)) as fh:
            return json.load(fh)

    # ---------------------------------------------------------- restores

    def _load(self, step: int, device, *, mmap: bool = False) -> dict:
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location=device, weights_only=True, mmap=mmap)

    @staticmethod
    def _as_state(raw: dict, shapes: TrainState, step: int) -> TrainState:
        want = _state_tree(shapes)
        _check_tree({k: raw.get(k) for k in want}, want, step)
        return TrainState(step=int(raw["step"]), params=raw["params"],
                          opt_state=raw["opt_state"], extras=raw["extras"],
                          ema_params=raw["ema_params"])

    def restore(self, state_shapes: TrainState, step: int | None = None, *,
                device=None) -> TrainState | None:
        """The state of committed step ``step`` (default: the newest) on
        ``device`` (``None`` means ``cuda``); its tree must match
        ``state_shapes`` (a template, e.g. on the meta device) or
        ``StateMismatch`` is raised. None when nothing is committed."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        state = self._as_state(self._load(step, resolve_device(device)),
                               state_shapes, step)
        self.logger.info("restored checkpoint step %d from %s", step,
                         self.directory)
        return state

    def restore_params_only(self, state_shapes: TrainState, step: int, *,
                            device=None) -> dict[str, torch.Tensor]:
        """Only the params of step ``step`` on ``device``: the file is
        memory-mapped, so the optimizer moments are never read."""
        raw = self._load(step, "cpu", mmap=True)
        _check_tree({"params": raw["params"]},
                    {"params": state_shapes.params}, step)
        dev = resolve_device(device)
        return {k: v.to(dev, copy=True) for k, v in raw["params"].items()}

    def _restore_bridging_ema(self, shapes: TrainState, step: int,
                              device) -> TrainState:
        """One step's restore, bridging an ``ema_decay`` toggle across
        the resume (the checkpoint has or lacks ``ema_params`` against the
        new run's template); a corrupt step raises and the caller falls
        back down the chain."""
        raw = self._load(step, device)
        try:
            return self._as_state(raw, shapes, step)
        except StateMismatch:
            if shapes.ema_params is not None and raw["ema_params"] is None:
                # The new run keeps an EMA, the checkpoint predates it:
                # seed the EMA from the restored params.
                state = self._as_state(
                    raw, dataclasses.replace(shapes, ema_params=None), step)
                self.logger.warning(
                    "checkpoint step %d has no ema_params (ema_decay was "
                    "enabled after it was written): seeding EMA from the "
                    "restored params", step)
                return dataclasses.replace(state, ema_params={
                    k: p.clone() for k, p in state.params.items()})
            if shapes.ema_params is None and raw["ema_params"] is not None:
                state = self._as_state(
                    raw, dataclasses.replace(shapes,
                                             ema_params=shapes.params), step)
                self.logger.warning(
                    "checkpoint step %d carries ema_params but ema_decay=0 "
                    "now: discarding the EMA tree", step)
                return dataclasses.replace(state, ema_params=None)
            raise

    def restore_or_init(self, trainer) -> TrainState:
        torn = self.uncommitted_steps()
        if torn:
            self.logger.warning(
                "checkpoint dir %s holds uncommitted step(s) %s (torn "
                "write or crash mid-save): skipping them; directories "
                "left in place for inspection", self.directory, torn)
        steps = self.all_steps()
        for step in reversed(steps):
            try:
                state = self._restore_bridging_ema(
                    trainer.state_shapes, step, trainer.device)
                self.logger.info("restored checkpoint step %d from %s",
                                 step, self.directory)
                return state
            except Exception as e:
                # Damage a commit marker cannot see: report it, keep the
                # directory, fall back to the previous committed step.
                self.corrupt_steps.append(step)
                self.logger.error(
                    "checkpoint step %d is committed but unreadable "
                    "(%s: %s); falling back to the previous committed "
                    "step; directory left in place for inspection",
                    step, type(e).__name__, e)
        if steps:
            self.logger.error(
                "no committed checkpoint under %s was restorable (%d "
                "tried); initializing fresh", self.directory, len(steps))
        return trainer.init_state()

    def wait(self) -> None:
        self._finish_pending()

    def close(self) -> None:
        try:
            self._finish_pending()
        finally:
            if self._ex is not None:
                self._ex.shutdown(wait=True)
                self._ex = None
            self._pinned.clear()
