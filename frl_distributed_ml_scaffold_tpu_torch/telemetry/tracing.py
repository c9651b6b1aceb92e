"""Host-side tracing: spans, the port of the JAX package's
``telemetry/tracing.py``.

Where the metrics registry aggregates and the ``Timeline`` remembers
order, a trace remembers causality: one connected tree of named, timed
spans per unit of work (a training step from data wait to launch).

Vocabulary:

- **trace**: an integer lane id from ``new_trace()``, one per causally
  connected unit (a request, a fit run); the Chrome export renders each
  as its own named thread lane.
- **span**: a named ``[t0, t0+dur]`` interval with a ``span_id`` and an
  optional ``parent`` span id; ``span()`` context managers nest through
  a context variable.

Three ways to record, all host-side:

- ``with tracer.span(name, ...):``, a scoped span; with
  ``annotate=True`` it also enters ``torch.profiler.record_function``
  (labelled ``"<name> <step_num>"`` when ``step_num`` is passed, as the
  JAX package enters a ``StepTraceAnnotation``), so host spans line up
  with the device timeline of a profiler window
  (``trainer.profile_steps``);
- ``span = tracer.begin(name, ...); ...; span.end()``, a cross-call
  lifetime (no profiler annotation);
- ``tracer.emit(name, t0=..., dur_s=..., ...)``, a span recorded after
  the fact.

Finished spans land in a ring buffer and, with a ``timeline`` attached,
are also teed into it as timeline events (``telemetry.jsonl``). The
export is Chrome-trace-event JSON (``{"traceEvents": [...]}``), loadable
by ``chrome://tracing`` and ui.perfetto.dev: the same names, categories
and parents as the JAX package's for the same spans.

``enabled=False`` builds a no-op tracer: every call returns the shared
null span, no clock reads, no annotations.
"""

from __future__ import annotations

import collections
import contextvars
import threading
import time
from typing import Any

#: Implicit parent for nested ``span()`` context managers (per-thread /
#: per-task via contextvars; ``begin()`` spans never become implicit
#: parents — their lifetime is not lexically scoped).
_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "frl_current_span", default=None
)


class Span:
    """An open span; ``end()`` (or context-manager exit) records it."""

    __slots__ = (
        "_tracer", "name", "cat", "trace", "span_id", "parent_id",
        "t0", "attrs", "_annotation", "_token", "_ended", "_step_num",
    )

    def __init__(
        self, tracer, name, cat, trace, span_id, parent_id, t0, attrs,
        step_num=None,
    ):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace = trace
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.attrs = attrs
        self._annotation = None
        self._token = None
        self._ended = False
        self._step_num = step_num

    def end(self, **attrs: Any) -> None:
        """Close the span at "now"; extra attrs merge into the record.
        Host-side store only."""
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs = {**self.attrs, **attrs}
        self._tracer._finish(self, time.perf_counter())

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        if self._tracer.annotate:
            import torch

            label = (self.name if self._step_num is None
                     else f"{self.name} {self._step_num}")
            self._annotation = torch.profiler.record_function(label)
            self._annotation.__enter__()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self.end()


class _NullSpan:
    """The disabled tracer's span: accepted everywhere, records nothing."""

    __slots__ = ()
    name = ""
    cat = None
    trace = 0
    span_id = 0
    parent_id = None

    def end(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


def _parent_id_of(parent: Any) -> "int | None":
    if parent is None:
        return None
    if isinstance(parent, int):
        return parent
    if isinstance(parent, _NullSpan):
        return None
    return parent.span_id


class Tracer:
    """Span recorder + ring buffer + Chrome-trace exporter (module
    docstring). One tracer per publishing component, like the metrics
    registry — engines, fit() runs, and supervisors never share lanes."""

    def __init__(
        self,
        capacity: int = 8192,
        enabled: bool = True,
        *,
        annotate: bool = False,
        timeline: Any = None,
        origin: float | None = None,
    ):
        self.enabled = enabled
        self.annotate = annotate and enabled
        self._timeline = timeline
        self._origin = time.perf_counter() if origin is None else origin
        self._spans: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=capacity
        )
        self.dropped = 0
        self._lock = threading.Lock()
        self._next_trace = 0
        self._next_span = 0
        # Lane labels, bounded like the span ring (a long-lived engine
        # allocates one trace per request forever — the oldest label is
        # evicted with roughly the spans that referenced it).
        self._name_capacity = max(int(capacity), 1)
        self._trace_names: dict[int, str] = {}

    # ------------------------------------------------------------ recording

    def new_trace(self, name: str | None = None) -> int:
        """Allocate a trace (lane) id; ``name`` labels the Perfetto lane.
        Returns 0 when disabled — no state is touched, same contract as
        the null span."""
        if not self.enabled:
            return 0
        with self._lock:
            self._next_trace += 1
            tid = self._next_trace
            if name is not None:
                self._trace_names[tid] = name
                while len(self._trace_names) > self._name_capacity:
                    self._trace_names.pop(next(iter(self._trace_names)))
            return tid

    def _alloc_span(self) -> int:
        with self._lock:
            self._next_span += 1
            return self._next_span

    def _resolve(self, trace, parent):
        """(trace_id, parent_id) with contextvar fallback for both."""
        if parent is None:
            parent = _CURRENT.get()
        pid = _parent_id_of(parent)
        if trace is None:
            trace = getattr(parent, "trace", 0) if parent is not None else 0
        return trace, pid

    def span(
        self,
        name: str,
        *,
        trace: int | None = None,
        parent: Any = None,
        cat: str | None = None,
        step_num: int | None = None,
        **attrs: Any,
    ) -> "Span | _NullSpan":
        """A context-manager span; nests implicitly (children created in
        its body inherit it as parent) and carries the profiler
        annotation when the tracer was built ``annotate=True``."""
        if not self.enabled:
            return _NULL_SPAN
        trace, pid = self._resolve(trace, parent)
        return Span(
            self, name, cat, trace, self._alloc_span(), pid,
            time.perf_counter(), attrs, step_num=step_num,
        )

    def begin(
        self,
        name: str,
        *,
        trace: int | None = None,
        parent: Any = None,
        cat: str | None = None,
        **attrs: Any,
    ) -> "Span | _NullSpan":
        """An open span with cross-call lifetime; close with ``end()``."""
        if not self.enabled:
            return _NULL_SPAN
        trace, pid = self._resolve(trace, parent)
        return Span(
            self, name, cat, trace, self._alloc_span(), pid,
            time.perf_counter(), attrs,
        )

    def emit(
        self,
        name: str,
        *,
        t0: float,
        dur_s: float,
        trace: int | None = None,
        parent: Any = None,
        cat: str | None = None,
        **attrs: Any,
    ) -> int:
        """Record a completed span with explicit clock values (``t0`` in
        the ``time.perf_counter`` domain). Returns its span id (0 when
        disabled) so retrospective children can chain."""
        if not self.enabled:
            return 0
        trace, pid = self._resolve(trace, parent)
        span_id = self._alloc_span()
        self._record(name, cat, trace, span_id, pid, t0, dur_s, attrs)
        return span_id

    def _finish(self, span: Span, t1: float) -> None:
        self._record(
            span.name, span.cat, span.trace, span.span_id, span.parent_id,
            span.t0, t1 - span.t0, span.attrs,
        )

    def _record(self, name, cat, trace, span_id, parent_id, t0, dur, attrs):
        rec: dict[str, Any] = {
            "name": name,
            "trace": int(trace),
            "span": int(span_id),
            "t0_s": round(t0 - self._origin, 9),
            "dur_s": round(max(float(dur), 0.0), 9),
        }
        if cat is not None:
            rec["cat"] = cat
        if parent_id is not None:
            rec["parent"] = int(parent_id)
        if attrs:
            rec.update(attrs)
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(rec)
        if self._timeline is not None:
            self._timeline.event(
                name, dur_s=rec["dur_s"],
                **{k: v for k, v in rec.items()
                   if k not in ("name", "t0_s", "dur_s", "cat")},
            )

    # -------------------------------------------------------------- reading

    @property
    def timeline(self) -> Any:
        """The ``Timeline`` finished spans tee into (None when detached) —
        lets an owner check whether its own timeline already receives the
        phase records or needs a bare-event fallback."""
        return self._timeline

    def spans(self) -> list[dict[str, Any]]:
        """Finished spans, oldest first, WITHOUT consuming them."""
        with self._lock:
            return list(self._spans)

    def drain(self) -> list[dict[str, Any]]:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def __len__(self) -> int:
        return len(self._spans)

    # ------------------------------------------------------------ exporting

    def chrome_trace(self, *, pid: int = 0) -> dict[str, Any]:
        return chrome_trace_events(
            self.spans(), trace_names=dict(self._trace_names), pid=pid
        )

    def write_chrome_trace(self, path: str, *, pid: int = 0) -> None:
        """Atomically write the Chrome-trace-event JSON next to the run's
        other artifacts (load in chrome://tracing or ui.perfetto.dev)."""
        import json
        import os

        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.chrome_trace(pid=pid), fh, indent=1)
        os.replace(tmp, path)


def chrome_trace_events(
    spans: list[dict[str, Any]],
    *,
    trace_names: dict[int, str] | None = None,
    pid: int = 0,
    process_name: str = "frl_tpu host",
) -> dict[str, Any]:
    """Convert span records to the Chrome trace-event JSON object format.

    Each span becomes a complete ("ph": "X") event on thread lane
    ``tid = trace id`` (one Perfetto lane per request or run);
    trace/span/parent ids and user attrs ride in ``args``, which is how
    the span TREE survives a format whose events are flat. Metadata
    events name the process and each lane that actually carries spans
    (labels for lanes whose spans were all evicted or drained would
    render as empty rows). Deterministic for fixed inputs
    (golden-tested)."""
    trace_names = trace_names or {}
    events: list[dict[str, Any]] = [
        {
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }
    ]
    tids = sorted({rec["trace"] for rec in spans})
    for tid in tids:
        events.append(
            {
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": trace_names.get(tid, f"trace {tid}")},
            }
        )
    for rec in spans:
        args = {
            k: v for k, v in rec.items()
            if k not in ("name", "cat", "t0_s", "dur_s")
        }
        events.append(
            {
                "name": rec["name"],
                "cat": rec.get("cat", "host"),
                "ph": "X",
                "ts": round(rec["t0_s"] * 1e6, 3),
                "dur": round(rec["dur_s"] * 1e6, 3),
                "pid": pid,
                "tid": rec["trace"],
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
