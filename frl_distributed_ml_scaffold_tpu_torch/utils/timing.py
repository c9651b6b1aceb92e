"""Step timing and throughput: the port of the JAX package's
``utils/timing.py``.

Timings exclude the warm-up window, and each window ends with a
synchronise of the device that holds the step's output, so a window
measures the device's work and not the launches. The training loop reads
the device only at a window boundary (``tick_window``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _force(out) -> None:
    """Wait for the card that holds ``out`` (a step's scalar tensor) to
    finish its queued work; a CPU tensor or None is already done."""
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


@dataclass
class StepTimer:
    """Per-step wall times after a warm-up window.

    ``tick(out)`` marks the end of one step; ``tick_window(out, steps)``
    the end of a window of ``steps`` steps (the loop's log boundary),
    recording the window's per-step average for each of its steps."""

    warmup: int = 3
    _times: list[float] = field(default_factory=list)
    _seen: int = 0
    _last: float | None = None

    def tick(self, out=None) -> float | None:
        """End of a step; its time, or None while warming up."""
        _force(out)
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                dt = now - self._last
                self._times.append(dt)
        self._last = now
        return dt

    def tick_window(self, out, steps: int) -> float | None:
        """End of a window of ``steps`` steps; the per-step average, or
        None for the first window and the warm-up ones."""
        _force(out)
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                dt = (now - self._last) / max(steps, 1)
                self._times.extend([dt] * steps)
        self._last = now
        return dt

    def reset(self) -> None:
        self._times.clear()
        self._seen = 0
        self._last = None

    @property
    def count(self) -> int:
        return len(self._times)

    def summary(self, samples_per_step: int | None = None,
                n_chips: int = 1) -> dict:
        """Step-time percentiles, mean and (given the global batch)
        samples/s, in all and per chip over ``n_chips``."""
        if not self._times:
            return {"steps_timed": 0}
        arr = np.asarray(self._times)
        out = {
            "steps_timed": int(arr.size),
            "step_time_median_s": float(np.median(arr)),
            "step_time_p50_s": float(np.median(arr)),
            "step_time_p90_s": float(np.percentile(arr, 90)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
            "step_time_p99_s": float(np.percentile(arr, 99)),
            "step_time_mean_s": float(arr.mean()),
            "steps_per_sec": float(1.0 / np.median(arr)),
        }
        if samples_per_step is not None:
            out["samples_per_sec"] = float(samples_per_step / np.median(arr))
            out["samples_per_sec_per_chip"] = out["samples_per_sec"] / n_chips
        return out
