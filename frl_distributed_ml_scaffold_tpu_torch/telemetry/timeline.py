"""Per-step timeline event log (the host-side phase record): the port
of the JAX package's ``telemetry/timeline.py``.

Where the metrics registry aggregates, the timeline remembers ORDER: one
record per host-loop phase (``load_batch``, ``dispatch``, ...),
ring-buffered so a stalled exporter can never grow the host heap,
drained into the telemetry JSONL at log boundaries. The stall watchdog
dumps its tail, so a stall report carries the last phases that did
complete.
"""

from __future__ import annotations

import collections
import time
from typing import Any


class Timeline:
    """Bounded in-memory event log; ``drain()`` empties it for export."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.enabled = enabled
        self._events: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=capacity
        )
        self.dropped = 0  # overwritten by the ring before being drained

    def event(
        self,
        name: str,
        *,
        dur_s: float | None = None,
        step: int | None = None,
        **fields: Any,
    ) -> None:
        if not self.enabled:
            return
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        rec: dict[str, Any] = {
            "event": "timeline",
            "name": name,
            "ts": round(time.time(), 6),
        }
        if step is not None:
            rec["step"] = int(step)
        if dur_s is not None:
            rec["dur_s"] = round(float(dur_s), 6)
        if fields:
            rec.update(fields)
        self._events.append(rec)

    def tail(self, n: int = 32) -> list[dict[str, Any]]:
        """Last ``n`` events WITHOUT consuming them (the watchdog's view)."""
        return list(self._events)[-n:]

    def drain(self) -> list[dict[str, Any]]:
        out = list(self._events)
        self._events.clear()
        return out

    def __len__(self) -> int:
        return len(self._events)
