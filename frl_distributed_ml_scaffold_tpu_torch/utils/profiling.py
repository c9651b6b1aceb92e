"""Profiler windows, host annotations and device memory: the port of the
JAX package's ``utils/profiling.py``.

- ``WindowProfiler`` wraps a window of training steps in
  ``torch.profiler`` (host and, on the card, device activity) and writes
  a Chrome trace to ``<run_dir>/trace/trace.json``; set by
  ``trainer.profile_start_step`` / ``trainer.profile_steps``, and free
  when off.
- ``annotate`` / ``annotate_step`` mark host phases with
  ``torch.profiler.record_function``, so a loader stall shows between
  device steps in the same trace.
- ``device_memory_stats`` reads the card's allocator.

Only the primary process captures a trace.
"""

from __future__ import annotations

import os

import torch

from frl_distributed_ml_scaffold_tpu_torch.utils.logging import (
    get_logger,
    is_primary_process,
)


class WindowProfiler:
    """A ``torch.profiler`` trace of steps [start, start + steps). Call
    ``step_start(step)`` at the top of each iteration and ``stop()``
    after the loop (covers runs shorter than the window)."""

    def __init__(self, trace_dir: str, start_step: int, num_steps: int):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self._prof = None
        self._done = num_steps <= 0 or not is_primary_process()

    def step_start(self, step: int) -> None:
        if self._done:
            return
        if self._prof is None and step >= self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
            get_logger().info("profiler: tracing steps %d..%d -> %s", step,
                              step + self.num_steps - 1, self.trace_dir)
        elif (self._prof is not None
              and step >= self.start_step + self.num_steps):
            self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            path = os.path.join(self.trace_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            self._done = True
            get_logger().info("profiler: trace written to %s", path)


def annotate(name: str):
    """A host phase, visible in the profiler timeline."""
    return torch.profiler.record_function(name)


def annotate_step(step: int):
    """The per-step annotation that groups a step's launches."""
    return torch.profiler.record_function(f"train step {step}")


def device_memory_stats(device=None) -> dict[str, float]:
    """The card's allocator in GiB: bytes in use, the peak, and the
    card's total (the JAX package's keys). Empty off the card; never
    raises (observability must not kill a run)."""
    try:
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_initialized():
            return {}
        stats = torch.cuda.memory_stats(dev)
        total = torch.cuda.get_device_properties(dev).total_memory
    except Exception:
        return {}
    gib = 1024**3
    out = {}
    if "allocated_bytes.all.current" in stats:
        out["hbm_in_use_gib"] = round(
            stats["allocated_bytes.all.current"] / gib, 3)
    if "allocated_bytes.all.peak" in stats:
        out["hbm_peak_gib"] = round(stats["allocated_bytes.all.peak"] / gib,
                                    3)
    out["hbm_limit_gib"] = round(total / gib, 3)
    return out
