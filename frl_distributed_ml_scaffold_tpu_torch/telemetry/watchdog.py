"""Stall watchdog: the port of the JAX package's
``telemetry/watchdog.py``, a host thread that notices when progress
stops.

A hung data loader or a wedged device leaves the process alive but the
step loop silent. If no ``beat()`` lands within ``timeout_s`` the
watchdog

1. increments the registry's ``stalls_total`` counter,
2. appends a dump to ``dump_path``: ``faulthandler`` tracebacks of
   every thread, the live metric snapshot and the timeline tail, and
3. logs an ERROR.

It then stays quiet until the next ``beat()`` re-arms it: one report per
silence. ``beat()`` is a single clock store; the watchdog never touches
the device, so it cannot deadlock on what it diagnoses.
"""

from __future__ import annotations

import faulthandler
import json
import threading
import time
from typing import Any

from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger


class StallWatchdog:
    """Fire when no ``beat()`` arrives within ``timeout_s`` (see module
    docstring). ``timeout_s <= 0`` constructs a disabled no-op watchdog
    (no thread), so callers can wire it unconditionally.

    ``first_beat_scale`` stretches the deadline until the FIRST beat
    lands: the initial silence includes the first step's set-up (kernel
    builds, allocator and library warm-up), so with the default ~5x
    grace a deadline sized to the slowest expected *step* tolerates it;
    once any beat arrives the normal deadline applies.
    """

    def __init__(
        self,
        timeout_s: float,
        *,
        name: str = "train",
        registry: Any | None = None,
        timeline: Any | None = None,
        dump_path: str | None = None,
        poll_s: float | None = None,
        first_beat_scale: float = 5.0,
    ):
        self.timeout_s = float(timeout_s)
        self.first_beat_scale = max(float(first_beat_scale), 1.0)
        self._beaten = False  # first beat seen -> normal deadline
        self.name = name
        self._registry = registry
        self._timeline = timeline
        self._dump_path = dump_path
        self._counter = (
            registry.counter(
                "stalls_total",
                help="watchdog firings: no progress within the deadline",
            )
            if registry is not None
            else None
        )
        self._last = time.monotonic()
        self._armed = True  # one report per silence window
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self.timeout_s > 0:
            poll = poll_s if poll_s is not None else max(self.timeout_s / 4, 0.25)
            self._thread = threading.Thread(
                target=self._loop,
                args=(max(poll, 0.005),),
                name=f"stall-watchdog-{name}",
                daemon=True,
            )
            self._thread.start()

    @property
    def enabled(self) -> bool:
        return self._thread is not None

    def beat(self) -> None:
        """Progress landed; re-arm. A host-side store only."""
        self._last = time.monotonic()
        self._beaten = True
        self._armed = True

    @property
    def fired(self) -> int:
        return int(self._counter.value) if self._counter is not None else 0

    def _loop(self, poll: float) -> None:
        while not self._stop.wait(poll):
            # Read _armed BEFORE _beaten BEFORE _last — the mirror of
            # beat()'s _last-then-_beaten-then-_armed write order.
            # Reading them the other way around can pair a stale _last
            # with a freshly-set _armed and fire a spurious "stall" right
            # after progress resumed. (A stale _beaten=False only widens
            # the deadline — delays a fire, never invents one.)
            armed = self._armed
            deadline = self.timeout_s * (
                1.0 if self._beaten else self.first_beat_scale
            )
            silent = time.monotonic() - self._last
            if armed and silent > deadline:
                self._armed = False  # quiet until the next beat
                try:
                    self._fire(silent, deadline)
                except Exception as e:  # the reporter must never kill a run
                    get_logger().warning(
                        "watchdog[%s]: stall report failed (%s)", self.name, e
                    )

    def _fire(self, silent_s: float, deadline_s: float | None = None) -> None:
        if self._counter is not None:
            self._counter.inc()
        get_logger().error(
            "watchdog[%s]: no progress for %.1fs (deadline %.1fs)%s",
            self.name,
            silent_s,
            deadline_s if deadline_s is not None else self.timeout_s,
            f" — dumping to {self._dump_path}" if self._dump_path else "",
        )
        if self._dump_path is None:
            return
        with open(self._dump_path, "a") as fh:
            fh.write(
                f"=== watchdog[{self.name}] stall at {time.time():.3f}: "
                f"no progress for {silent_s:.1f}s ===\n"
            )
            faulthandler.dump_traceback(file=fh, all_threads=True)
            if self._registry is not None:
                fh.write("\n--- metric snapshot ---\n")
                fh.write(json.dumps(self._registry.snapshot(), indent=1))
                fh.write("\n")
            if self._timeline is not None:
                fh.write("--- timeline tail ---\n")
                for rec in self._timeline.tail():
                    fh.write(json.dumps(rec) + "\n")
            fh.flush()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()
