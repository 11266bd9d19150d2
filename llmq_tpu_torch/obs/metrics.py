"""Dependency-free metrics primitives: counters, gauges, histograms (the
port's copy of ``llmq_tpu/obs/metrics.py``).

The export plane (Prometheus text, heartbeat summaries, the JSONL trace
sink) hangs off one process-wide :class:`MetricsRegistry`; the hot paths
only ever touch the primitives, whose record operations are a float add
or a bucket increment — cheap enough to leave on unconditionally, which
is the whole design: instrumentation is always recording, *export* is
what is opt-in (``LLMQ_METRICS_PORT`` / ``LLMQ_TRACE_LOG``).

Two registration styles, matching the two ownership patterns in the
stack:

- ``registry.counter(...)`` / ``.gauge(...)`` / ``.histogram(...)``:
  get-or-create by (name, labels). Used by process-wide singletons (the
  broker session, the worker loop) where every caller should share one
  series.
- Construct a metric directly and ``registry.register(metric)``: used by
  the engine/scheduler, which own per-instance metrics (``stats()``
  percentiles must not mix across the many engines a test process
  builds). ``register`` replaces any same-named series — one engine per
  worker process, and in tests the latest engine owns the exported
  series.

Durations are recorded in **seconds** (Prometheus convention) from
``time.monotonic()``/``perf_counter()`` — never ``time.time()``.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: Default latency buckets (seconds): 1 ms .. 60 s, roughly 2.5x apart.
#: Wide enough for TTFT under queueing, fine enough for per-token ITL.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def to_ms(seconds: Optional[float]) -> Optional[float]:
    """Seconds → rounded milliseconds for stats()/heartbeat display."""
    return None if seconds is None else round(seconds * 1000.0, 3)


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _merge_labels(
    labels: Optional[Dict[str, str]], extra: Dict[str, str]
) -> str:
    merged = dict(labels or {})
    merged.update(extra)
    return _fmt_labels(merged)


class Metric:
    """Common surface: a name, optional static labels, render lines."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help_text: str = "",
        *,
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        self.name = name
        self.help_text = help_text
        self.labels = dict(labels) if labels else None

    @property
    def key(self) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        return (self.name, tuple(sorted((self.labels or {}).items())))

    def render(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def summary_value(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing count (float adds; no locking — CPython
    float += on distinct attributes is safe enough for stats, and the
    hot paths are single-threaded per instance)."""

    kind = "counter"

    def __init__(self, name, help_text="", *, labels=None) -> None:
        super().__init__(name, help_text, labels=labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def render(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} {self.value:g}"]

    def summary_value(self) -> float:
        return self.value


class Gauge(Metric):
    """Point-in-time value; ``fn`` makes it a live read-through gauge
    (collected lazily at render time, so idle exporters cost nothing)."""

    kind = "gauge"

    def __init__(
        self,
        name,
        help_text="",
        *,
        labels=None,
        fn: Optional[Callable[[], float]] = None,
    ) -> None:
        super().__init__(name, help_text, labels=labels)
        self.value = 0.0
        self.fn = fn

    def set(self, value: float) -> None:
        self.value = value

    def current(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # noqa: BLE001 — a dead callback reads 0
                return 0.0
        return self.value

    def render(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} {self.current():g}"]

    def summary_value(self) -> float:
        return self.current()


class Histogram(Metric):
    """Fixed-bucket histogram with percentile snapshots.

    ``observe`` is a bisect + two int/float adds — the cost budget that
    lets TTFT/ITL record on every generated token. Percentiles come
    from linear interpolation inside the winning cumulative bucket
    (upper-bounded by the bucket edge), the standard Prometheus
    ``histogram_quantile`` estimate computed host-side.
    """

    kind = "histogram"

    def __init__(
        self,
        name,
        help_text="",
        *,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labels=None,
    ) -> None:
        super().__init__(name, help_text, labels=labels)
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +Inf tail
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += 1
        self.sum += value

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1]; None when empty."""
        if self.total == 0:
            return None
        rank = q * self.total
        cum = 0
        for i, count in enumerate(self.counts):
            prev_cum = cum
            cum += count
            if cum >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1] if self.bounds else None
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                if count == 0:
                    return hi
                frac = (rank - prev_cum) / count
                return lo + (hi - lo) * frac
        return self.bounds[-1] if self.bounds else None

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {
            "count": self.total,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def render(self) -> List[str]:
        lines = []
        cum = 0
        for bound, count in zip(self.bounds, self.counts):
            cum += count
            lines.append(
                f"{self.name}_bucket"
                f"{_merge_labels(self.labels, {'le': f'{bound:g}'})} {cum}"
            )
        lines.append(
            f"{self.name}_bucket"
            f"{_merge_labels(self.labels, {'le': '+Inf'})} {self.total}"
        )
        lines.append(
            f"{self.name}_sum{_fmt_labels(self.labels)} {self.sum:g}"
        )
        lines.append(
            f"{self.name}_count{_fmt_labels(self.labels)} {self.total}"
        )
        return lines

    def summary_value(self) -> Dict[str, Optional[float]]:
        return self.snapshot()


class MetricsRegistry:
    """Ordered collection of metrics + the Prometheus text renderer."""

    def __init__(self) -> None:
        # Keyed by (name, labels) of instrumented code sites — a static
        # set fixed at import/startup, not per-request state.
        self._metrics: Dict[Tuple, Metric] = {}
        self._lock = threading.Lock()

    # --- registration -----------------------------------------------------
    def register(self, metric: Metric) -> Metric:
        """Register (or replace) a metric under its (name, labels) key."""
        with self._lock:
            self._metrics[metric.key] = metric
        return metric

    def _get_or_create(self, cls, name, help_text, labels, **kwargs) -> Metric:
        probe = cls(name, help_text, labels=labels, **kwargs)
        with self._lock:
            existing = self._metrics.get(probe.key)
            if isinstance(existing, cls):
                return existing
            self._metrics[probe.key] = probe
            return probe

    def counter(self, name, help_text="", *, labels=None) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name, help_text="", *, labels=None, fn=None) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels, fn=fn)

    def histogram(
        self, name, help_text="", *, buckets=DEFAULT_BUCKETS, labels=None
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, labels, buckets=buckets
        )

    # --- export -----------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        seen_headers = set()
        for m in metrics:
            if m.name not in seen_headers:
                seen_headers.add(m.name)
                if m.help_text:
                    lines.append(f"# HELP {m.name} {m.help_text}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def summary(self) -> Dict[str, Any]:
        """Compact {series: value} snapshot for heartbeats. Histogram
        values are ms-scaled percentile dicts (heartbeats are read by
        humans and `monitor top`, where seconds-scale latencies render
        as 0.00)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, Any] = {}
        for m in metrics:
            series = m.name + _fmt_labels(m.labels)
            val = m.summary_value()
            if isinstance(val, dict):
                val = {
                    k: (round(v * 1000.0, 3) if k != "count" and v is not None
                        else v)
                    for k, v in val.items()
                }
                series += "_ms"
            out[series] = val
        return out


#: Process-wide default registry: engine/scheduler/broker/worker metrics
#: all land here, and the exporter serves it.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
