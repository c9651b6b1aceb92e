"""Logging and metric sinks: the port of the JAX package's
``utils/logging.py``.

Metrics stay on the device between log boundaries (the step returns 0-d
tensors); ``MetricLogger.log`` moves them to the host in one transfer
and writes a stdout line and a JSONL record. Only the primary process
writes (rank 0 of an initialised ``torch.distributed`` group, else this
process).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import IO, Any, Mapping

import torch

_LOGGERS: dict[str, logging.Logger] = {}


def is_primary_process() -> bool:
    """True on the process that writes logs: rank 0 when a
    ``torch.distributed`` process group is initialised, else True. It
    never initialises anything itself."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def get_logger(name: str = "frl_torch") -> logging.Logger:
    """Primary-gated stdout logger; other processes log at ERROR."""
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO if is_primary_process()
                        else logging.ERROR)
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


def _truncate_partial_line(path: str) -> None:
    """Drop a torn final line (a process killed mid-``write``) before
    appending resumes, so every later line-by-line reader still parses
    the file."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return  # no file yet
    if size == 0:
        return
    with open(path, "rb+") as fh:
        fh.seek(size - 1)
        if fh.read(1) == b"\n":
            return  # clean shutdown last time
        pos = size
        while pos > 0:
            step = min(65536, pos)
            fh.seek(pos - step)
            idx = fh.read(step).rfind(b"\n")
            if idx >= 0:
                fh.truncate(pos - step + idx + 1)
                return
            pos -= step
        fh.truncate(0)  # a single torn line: the whole file is the tear


def _json_default(x: Any) -> Any:
    if hasattr(x, "item"):
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return str(x)


class JsonlWriter:
    """Append-only JSONL sink, primary process only. Reopening an
    existing file first truncates a torn final line."""

    def __init__(self, path: str | None):
        self._fh: IO[str] | None = None
        if path and is_primary_process():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            _truncate_partial_line(path)
            self._fh = open(path, "a", buffering=1)

    def write(self, record: Mapping[str, Any]) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(record, default=_json_default) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TensorBoardWriter:
    """Optional TensorBoard scalar sink (``torch.utils.tensorboard``),
    primary only. Imported lazily; a missing or broken writer package
    turns the sink off with a warning and the run goes on (JSONL is the
    record of truth)."""

    def __init__(self, logdir: str | None):
        self._writer = None
        if logdir and is_primary_process():
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(logdir)
            except Exception as e:  # missing/broken package: sink off
                get_logger().warning("tensorboard sink disabled: %s", e)

    def write(self, step: int, record: Mapping[str, Any]) -> None:
        if self._writer is None:
            return
        for k, v in record.items():
            if k != "step" and isinstance(v, (int, float)):
                self._writer.add_scalar(k, float(v), int(step))
        self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def to_host(metrics: Mapping[str, Any]) -> dict[str, Any]:
    """Tensors of ``metrics`` as Python floats, moved in one transfer;
    other values pass through."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = dict(metrics)
    if keys:
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in keys]).tolist()
        out.update(zip(keys, vals))
    return out


class MetricLogger:
    """Periodic metric emitter: stdout line + JSONL record (+ the
    optional TensorBoard sink)."""

    def __init__(self, jsonl_path: str | None = None,
                 name: str = "frl_torch", tb_dir: str | None = None):
        self._logger = get_logger(name)
        self._jsonl = JsonlWriter(jsonl_path)
        self._tb = TensorBoardWriter(tb_dir)
        self._start = time.monotonic()

    def log(self, step: int, metrics: Mapping[str, Any],
            extra: Mapping[str, Any] | None = None) -> dict[str, Any]:
        record: dict[str, Any] = {
            "step": int(step),
            "wall_time_s": round(time.monotonic() - self._start, 3),
        }
        for k, v in to_host(metrics).items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if extra:
            record.update(extra)
        parts = [f"step={record['step']}"]
        parts += [f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in record.items() if k != "step"]
        self._logger.info(" ".join(parts))
        self._jsonl.write(record)
        self._tb.write(record["step"], record)
        return record

    def close(self) -> None:
        self._jsonl.close()
        self._tb.close()
