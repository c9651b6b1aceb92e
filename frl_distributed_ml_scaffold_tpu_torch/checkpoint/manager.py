"""Checkpoint manager: the port of the JAX package's
``checkpoint/manager.py``, on ``torch.save`` in one process.

Format. ``<directory>/<step>/state.pt`` is one ``torch.save`` file of
``{"step": int64 tensor, "params", "opt_state", "extras",
"ema_params"}`` (the ``TrainState``'s fields; the optimizer's count stays
a Python int), beside ``meta.json`` (the step, the tensor payload's
bytes, the seconds the snapshot and the write took). A step is written
into ``<step>.tmp.<pid>`` and renamed into place once its bytes are
flushed to disk. The file holds the whole state whatever the mesh:
under a sharded layout (the ``Trainer`` sets ``layout``) every rank
takes part in gathering it and rank 0 alone writes it, so the payload
is byte for byte what one rank writes; the other ranks wait for it on
a barrier. A restore reads the whole state and re-shards it by the
layout, so a checkpoint of N ranks restores on any mesh. Over ``pipe``
ranks the gather takes every stage's layers (the layout's ``owner``),
so the file holds the plain GPT's names whatever the pipeline, and a
restore keeps each rank's stage or, on one rank, the whole model.
``torch.distributed.checkpoint`` was not used: one file per step, whole,
is what every mesh can read.

With ``checkpoint.restore_redistribute`` (the elastic supervisor's
re-formed world sets it) a restore goes through the redistribution
service instead: each rank memory-maps the one ``state.pt`` and reads
its region of every leaf at ``restore_layout_spec``'s even layout (the
target spec with every unused mesh axis laid onto a dim: about 1/N of
the leaf a rank, never a whole copy), then the plan moves each leaf to
the layout's target spec (a pure drop program, all-gathers on their own
dims, or point-to-point chunks where a split is uneven) with each even
leaf released as its target exists. ``last_restore_plan`` keeps the
executed plan and ``last_restore_read_bytes`` the bytes this rank read.
The ranks agree on the path before they restore: the flag on any rank
takes them all through the service.

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

import numpy as np
import torch

from frl_distributed_ml_scaffold_tpu_torch import faults, resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import CheckpointConfig
from frl_distributed_ml_scaffold_tpu_torch.dist.collectives import (
    barrier,
    host_all_gather,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import one_rank_mesh
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


def _cast_like(raw: Any, want: Any) -> Any:
    """``raw`` with each floating-point tensor cast to the dtype of the
    template's tensor at its path, as the JAX checkpointer restores into
    its template's dtypes: Adafactor's moments are saved in the param
    dtype and come back in the fp32 the state is built with (an exact
    widening). Anything else is left for ``_check_tree`` to judge."""
    if isinstance(raw, dict) and isinstance(want, dict):
        return {k: _cast_like(v, want.get(k)) for k, v in raw.items()}
    if (isinstance(raw, torch.Tensor) and isinstance(want, torch.Tensor)
            and raw.dtype != want.dtype and raw.is_floating_point()
            and want.is_floating_point()):
        return raw.to(want.dtype)
    return raw


def _to_device(state: TrainState, device) -> TrainState:
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return x.to(device) if isinstance(x, torch.Tensor) else x

    return TrainState(step=state.step, params=move(state.params),
                      opt_state=move(state.opt_state),
                      extras=move(state.extras),
                      ema_params=(None if state.ema_params is None
                                  else move(state.ema_params)))


def _targets(state: TrainState, layout, env) -> dict:
    """The target ``Placement`` of every tensor of ``state`` (whole), by
    its ``_flatten`` path: the params and the EMA at the layout's param
    specs, the parameter-shaped optimizer tensors at its opt specs,
    anything else whole on every rank; under ``pipe`` the tensors of a
    name-keyed dict are held by its owner's stage."""
    from frl_distributed_ml_scaffold_tpu_torch.redistribute import Placement

    names = ({} if layout is None
             else (layout.whole_shapes or layout.shapes))
    owner = {} if layout is None else layout.owner

    def spec(which: str, name: str, t: torch.Tensor):
        if layout is not None and tuple(t.shape) == names.get(name):
            s = getattr(layout, which).get(name)
            if s is not None:
                return s
        return (None,) * t.dim()

    out = {}
    for top, which in (("params", "param"), ("ema_params", "param"),
                       ("opt_state", "opt"), ("extras", None)):
        for path, t in _flatten(getattr(state, top) or {}, f"{top}/").items():
            if not isinstance(t, torch.Tensor):
                continue
            name = path.rsplit("/", 1)[-1]
            keyed = which is not None and name in names
            out[path] = Placement(
                env, spec(which, name, t) if keyed else (None,) * t.dim(),
                owner.get(name) if keyed else None)
    return out


def _rebuild(state: TrainState, targets: dict, local: dict) -> TrainState:
    """``state`` with every target tensor replaced by this rank's
    ``local`` one, and the tensors this rank holds none of left out
    (another pipeline stage's)."""
    def walk(tree, prefix):
        if not isinstance(tree, dict):
            if prefix.rstrip("/") in targets:
                return local.get(prefix.rstrip("/"))
            return tree
        out = {}
        for k, v in tree.items():
            path = f"{prefix}{k}"
            if path in targets and path not in local:
                continue
            out[k] = walk(v, f"{path}/" if isinstance(v, dict) else path)
        return out

    return TrainState(step=state.step, params=walk(state.params, "params/"),
                      opt_state=walk(state.opt_state, "opt_state/"),
                      extras=walk(state.extras, "extras/"),
                      ema_params=(None if state.ema_params is None else
                                  walk(state.ema_params, "ema_params/")))


class Checkpointer:
    """Async save and restore of a ``TrainState`` (module docstring).

    ``restore_or_init(trainer)`` is the entry the ``Trainer`` uses: the
    newest committed step that loads, restored into the trainer's state
    template on its device, falling back down the committed chain past
    torn or corrupt steps; otherwise a fresh init."""

    def __init__(self, directory: str, cfg: CheckpointConfig):
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
        #: The state's specs over the mesh (``parallel/layout.py``), set
        #: by the ``Trainer``; None holds the state as it is given.
        self.layout = None
        #: The plan of the last restore through the redistribution
        #: service, and the tensor bytes this rank read for it.
        self.last_restore_plan = None
        self.last_restore_read_bytes = 0

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
        try:
            if pending is not None:
                pending.result()
            for step in steps:
                self._commit(step)
        finally:
            barrier("checkpoint")  # every rank sees rank 0's commits

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
        barrier("checkpoint")  # every rank has decided before rank 0 writes
        if self.layout is not None:
            state = self.layout.gather_state(state)
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
        raw = _cast_like(raw, want)
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
                              device, *, mmap: bool = False) -> TrainState:
        """One step's restore, bridging an ``ema_decay`` toggle across
        the resume (the checkpoint has or lacks ``ema_params`` against the
        new run's template); a corrupt step raises and the caller falls
        back down the chain."""
        raw = self._load(step, device, mmap=mmap)
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
        layout = self.layout
        split = layout is not None and not layout.trivial
        # The service's restore takes every rank, so the ranks agree on
        # it: one rank's flag (a re-formed child beside a host started
        # afresh) takes them all through it.
        via = bool(host_all_gather(
            np.array([self.cfg.restore_redistribute])).any())
        for step in reversed(steps):
            # Reading a step is this rank's own work (through the service
            # too: each rank narrows its regions of the memory map), so a
            # step one rank cannot read is skipped by all of them, before
            # any of them takes part in a move.
            err = None
            try:
                state = self._restore_bridging_ema(
                    trainer.state_shapes, step,
                    "cpu" if split or via else trainer.device, mmap=via)
                if via:
                    even = self._read_even(state, trainer.device)
                elif split:
                    state = _to_device(layout.shard_state(state),
                                       trainer.device)
            except Exception as e:  # noqa: BLE001 (reported below)
                err = e
            bad = host_all_gather(np.array([err is not None]))
            if not bad.any():
                if via:
                    # Outside the fallback: a failed plan or send raises
                    # on every rank, it never restores an older step.
                    return self._redistribute(state, even, trainer.device,
                                              step)
                self.logger.info("restored checkpoint step %d from %s",
                                 step, self.directory)
                return state
            # Damage a commit marker cannot see: report it, keep the
            # directory, fall back to the previous committed step.
            self.corrupt_steps.append(step)
            why = (f"{type(err).__name__}: {err}" if err is not None else
                   f"unreadable on rank(s) {np.flatnonzero(bad).tolist()}")
            self.logger.error(
                "checkpoint step %d is committed but unreadable (%s); "
                "falling back to the previous committed step; directory "
                "left in place for inspection", step, why)
        if steps:
            self.logger.error(
                "no committed checkpoint under %s was restorable (%d "
                "tried); initializing fresh", self.directory, len(steps))
        return trainer.init_state()

    def _read_even(self, state: TrainState, device) -> tuple:
        """This rank's regions of ``state`` (memory-mapped, whole) at
        ``restore_layout_spec``'s even layout, read with no
        communication: ``(targets, even placements, local tensors)``."""
        from frl_distributed_ml_scaffold_tpu_torch import redistribute as rd

        env = (self.layout.env if self.layout is not None
               else one_rank_mesh())
        targets = _targets(state, self.layout, env)
        flat = _flatten(_state_tree(state))
        even, src = {}, {}
        for path, target in targets.items():
            x = flat[path]
            spec = rd.restore_layout_spec(tuple(x.shape), target.spec, env,
                                          owner=target.owner)
            even[path] = rd.Placement(env, spec, target.owner)
            src[path] = rd.Abstract.of(x.shape, x.dtype, None)
        read = rd.compile_tree_plan(src, even)
        local = rd.execute(read, {p: flat[p] for p in targets},
                           donate=False, device=device)
        return targets, {p: rd.Abstract.of(src[p].shape, src[p].dtype,
                                           even[p]) for p in targets}, local

    def _redistribute(self, state: TrainState, even: tuple, device,
                      step: int) -> TrainState:
        """``state``'s leaves from this rank's even regions (``even``, as
        ``_read_even`` gives them) onto the layout's target specs through
        the redistribution service (module docstring). Every rank of the
        layout's mesh takes part."""
        from frl_distributed_ml_scaffold_tpu_torch import redistribute as rd

        targets, src, local = even
        self.last_restore_read_bytes = sum(
            t.numel() * t.element_size() for t in local.values())
        scratch = (int(self.cfg.redistribute_scratch_mb * 1024 * 1024)
                   if self.cfg.redistribute_scratch_mb else None)
        plan = rd.compile_tree_plan(src, dict(targets),
                                    scratch_limit_bytes=scratch)
        local = rd.execute(plan, local, donate=True, device=device)
        self.last_restore_plan = plan
        self.logger.info(
            "restored checkpoint step %d from %s via redistribution "
            "(%d leaves, %d bytes moved, lower bound %d, peak scratch %d)",
            step, self.directory, len(plan.leaves), plan.bytes_moved,
            plan.bytes_lower_bound, plan.peak_scratch_bytes)
        self.logger.info("%s; this rank read %d bytes", plan.summary_lines()[0],
                         self.last_restore_read_bytes)
        return _rebuild(state, targets, local)

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
