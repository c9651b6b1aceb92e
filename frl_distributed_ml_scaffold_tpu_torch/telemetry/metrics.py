"""One metrics layer for the training loop (and, later, serving): the
port of the JAX package's ``telemetry/metrics.py``.

- **Counter**: monotone event counts. ``inc()`` only.
- **Gauge**: last-written level. ``set()`` only.
- **Histogram**: latency distributions over FIXED log2 buckets
  (``LOG2_LATENCY_BUCKETS_S``), so snapshots from different runs merge
  by summing counts. ``quantile()`` interpolates linearly inside the
  containing bucket (within 2x of truth by construction).

Everything is host-side state: the loop mutates metrics between
launches, never inside the device work. A registry built
``enabled=False`` keeps the same metric objects and no-ops their
mutators.

Export is two pull-based snapshots of the same state: ``snapshot()`` (a
JSON-able dict, written through ``JsonlWriter``) and
``prometheus_text()`` (the Prometheus text exposition format,
byte-for-byte the JAX package's for the same observations).
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Mapping

#: Fixed log2 latency buckets, in seconds: 2^-17 (~7.6 us) .. 2^6 (64 s).
#: One shared ladder for every latency histogram in the repo — merges and
#: cross-run diffs stay well-defined (see module docstring).
LOG2_LATENCY_BUCKETS_S: tuple[float, ...] = tuple(
    float(2.0**e) for e in range(-17, 7)
)


def _fmt(x: float) -> str:
    """Deterministic float rendering for the text format (golden-tested):
    integers print bare, everything else via repr-shortest %.10g."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return format(x, ".10g")


class Counter:
    """Monotone event counter."""

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self._reg = registry
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        with self._reg._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Gauge:
    """Last-written level."""

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self._reg = registry
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._reg._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Histogram:
    """Fixed-bucket histogram (log2 latency ladder by default).

    Observations land in the first bucket whose upper bound is >= the
    value; values past the last bound land in the implicit +Inf bucket.
    """

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help: str,
        buckets: Iterable[float] = LOG2_LATENCY_BUCKETS_S,
    ):
        self._reg = registry
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name}: no buckets")
        self._counts = [0] * (len(self.buckets) + 1)  # +1: +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        with self._reg._lock:
            i = 0
            for i, b in enumerate(self.buckets):  # noqa: B007
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate in [bucket lo, bucket hi].

        The +Inf bucket clamps to the last finite bound (a deliberate
        floor-of-truth: the table can understate, never invent, a tail).
        Empty histogram -> 0.0.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile({q}) outside [0, 1]")
        if self._count == 0:
            return 0.0
        target = q * self._count
        cum = 0.0
        for i, n in enumerate(self._counts):
            if n == 0:
                continue
            if cum + n >= target:
                if i >= len(self.buckets):  # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (target - cum) / n
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += n
        return self.buckets[-1]

    def _reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0


class MetricsRegistry:
    """Get-or-create home of a tier's metrics; the snapshot/export unit.

    One registry per publishing component (a ``ServingEngine``, a
    ``Trainer.fit`` run, an elastic supervisor) — no process-global
    state, so tests and multi-engine hosts never share counters.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, cls, name: str, **kw: Any):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help=help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Iterable[float] = LOG2_LATENCY_BUCKETS_S,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help=help, buckets=buckets)

    def reset(self) -> None:
        """Zero every metric, keeping registrations (observations from a
        warm-up are dropped before the measured pass)."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()

    def snapshot(self) -> dict[str, Any]:
        """JSON-able state of every metric, sorted by name.

        Counters/gauges flatten to their value; histograms carry count,
        sum, the p50/p95/p99 estimates AND the raw cumulative bucket
        counts, so offline tools can recompute any quantile and merge
        runs without re-observing.
        """
        with self._lock:
            out: dict[str, Any] = {}
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if isinstance(m, Histogram):
                    cum, buckets = 0, {}
                    for b, n in zip(m.buckets, m._counts):
                        cum += n
                        buckets[_fmt(b)] = cum
                    buckets["+Inf"] = m._count
                    out[name] = {
                        "type": "histogram",
                        "count": m._count,
                        "sum": m._sum,
                        "p50": m.quantile(0.50),
                        "p95": m.quantile(0.95),
                        "p99": m.quantile(0.99),
                        "buckets": buckets,
                    }
                else:
                    out[name] = m.value
            return out


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition format snapshot of ``registry``.

    Deterministic (metrics sorted by name, floats via ``_fmt``) so the
    output is golden-testable byte-for-byte; histograms emit cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count`` per convention.
    """
    lines: list[str] = []
    # Render entirely under the registry lock (like ``snapshot``): the
    # watchdog thread mutates ``_counts``/``_count``/``_sum`` under it,
    # and rendering outside it could scrape a histogram whose
    # ``_bucket`` rows disagree with its ``_count``.
    with registry._lock:
        for name in sorted(registry._metrics):
            m = registry._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for b, n in zip(m.buckets, m._counts):
                    cum += n
                    lines.append(f'{name}_bucket{{le="{_fmt(b)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
    return "\n".join(lines) + "\n"


def write_prometheus_file(registry: MetricsRegistry, path: str) -> None:
    """Atomically publish the snapshot as a scrape-able sidecar file
    (node-exporter textfile-collector style: no listener port needed).
    Primary-process gating is the caller's job; this never publishes a
    torn file."""
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(prometheus_text(registry))
    os.replace(tmp, path)


def jsonl_record(
    registry: MetricsRegistry,
    *,
    step: int | None = None,
    extra: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """The telemetry JSONL record shape (``{"event": "telemetry", ...}``)
    the trainer exports, the JAX package's shape."""
    import time

    rec: dict[str, Any] = {"event": "telemetry", "ts": round(time.time(), 3)}
    if step is not None:
        rec["step"] = int(step)
    if extra:
        rec.update(extra)
    rec["metrics"] = registry.snapshot()
    return rec
