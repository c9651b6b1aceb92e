"""Runtime telemetry of the training loop and the serving engines:
metrics (``metrics.py``), the phase timeline (``timeline.py``), spans
(``tracing.py``) and the stall watchdog (``watchdog.py``). The port's
copies of the JAX package's ``telemetry/``."""

from frl_distributed_ml_scaffold_tpu_torch.telemetry.metrics import (
    LOG2_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    jsonl_record,
    prometheus_text,
    write_prometheus_file,
)
from frl_distributed_ml_scaffold_tpu_torch.telemetry.timeline import Timeline
from frl_distributed_ml_scaffold_tpu_torch.telemetry.tracing import (
    Span,
    Tracer,
    chrome_trace_events,
)
from frl_distributed_ml_scaffold_tpu_torch.telemetry.watchdog import (
    StallWatchdog,
)

__all__ = [
    "LOG2_LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "StallWatchdog",
    "Timeline",
    "Tracer",
    "chrome_trace_events",
    "jsonl_record",
    "prometheus_text",
    "write_prometheus_file",
]
