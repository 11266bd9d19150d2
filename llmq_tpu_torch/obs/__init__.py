"""Observability subsystem: metrics registry, request tracing, export (the
port's copy of ``llmq_tpu/obs``).

Import-cheap and dependency-free by design — ``obs`` is imported from
the engine, scheduler, broker, and worker hot paths, so it must never
pull in torch, pydantic, or rich. Export surfaces (the Prometheus
endpoint, the JSONL sink) are opt-in via env; the recording primitives
are always on and cost a dict write or a bucket increment.
"""

from llmq_tpu_torch.obs.exporter import (
    MetricsExporter,
    maybe_start_exporter,
    stop_exporter,
)
from llmq_tpu_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    to_ms,
)
from llmq_tpu_torch.obs.trace import (
    TRACE_FIELD,
    emit_trace_event,
    mono_to_wall,
    new_trace,
    timeline,
    trace_event,
    trace_event_at,
    trace_from_payload,
    trace_log_path,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsExporter",
    "MetricsRegistry",
    "TRACE_FIELD",
    "emit_trace_event",
    "get_registry",
    "maybe_start_exporter",
    "mono_to_wall",
    "new_trace",
    "stop_exporter",
    "timeline",
    "to_ms",
    "trace_event",
    "trace_event_at",
    "trace_from_payload",
    "trace_log_path",
]
