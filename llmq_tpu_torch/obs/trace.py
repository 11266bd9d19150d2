"""Per-request lifecycle tracing (the port's copy of
``llmq_tpu/obs/trace.py``).

A trace is a plain dict that rides inside the job payload (pydantic
``extra="allow"`` passthrough), so it survives broker hops, redeliveries
and multi-stage pipeline handoffs without any broker support:

    {"job_id": "...", "redeliveries": 0,
     "events": [{"name": "submitted", "t_wall": ..., "t_mono": ...,
                 "host": "..."}, ...]}

Events carry BOTH clocks: ``t_mono`` (CLOCK_MONOTONIC — comparable
across processes on one host, immune to NTP steps) for durations, and
``t_wall`` (epoch seconds) for cross-host ordering and display. The
timeline renderer prefers monotonic deltas whenever consecutive events
share a host and falls back to wall clock across hosts.

Redelivery semantics are free: a redelivered message carries the
*original* payload, so worker-side events stamped on a failed attempt
never duplicate — the retry re-reads the submit-time trace, and the
worker records how many attempts it took in ``redeliveries``
(``delivery_count - 1``).

The optional JSONL sink (``LLMQ_TRACE_LOG=<path>``) appends one line per
lifecycle transition as it happens locally — including the paths that
cannot stamp the payload (requeues, dead-letters) because the payload is
about to be abandoned or re-read.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Any, Dict, List, Optional

from llmq_tpu_torch.utils import clock

TRACE_FIELD = "trace"
_HOST = socket.gethostname()

_sink_lock = threading.Lock()


def new_trace(job_id: str) -> Dict[str, Any]:
    return {"job_id": job_id, "redeliveries": 0, "events": []}


def trace_event(
    trace: Optional[Dict[str, Any]], name: str, **fields: Any
) -> Optional[Dict[str, Any]]:
    """Append a lifecycle event (host-side dict write; no device work).

    Returns the trace for chaining; a None/malformed trace is ignored so
    instrumentation can never break the hot loop.
    """
    if not isinstance(trace, dict):
        return trace
    event = {
        "name": name,
        "t_wall": clock.wall(),
        "t_mono": clock.monotonic(),
        "host": _HOST,
    }
    event.update(fields)
    trace.setdefault("events", []).append(event)
    return trace


def trace_event_at(
    trace: Optional[Dict[str, Any]],
    name: str,
    t_mono: Optional[float],
    **fields: Any,
) -> Optional[Dict[str, Any]]:
    """Append an event stamped at a *recorded* monotonic time from this
    host — engine lifecycle stamps are taken in the hot loop (plain float
    writes) and attached to the trace after the request finishes. A
    zero/None stamp means the phase never happened and is skipped."""
    if not isinstance(trace, dict) or not t_mono:
        return trace
    event = {
        "name": name,
        "t_wall": mono_to_wall(t_mono),
        "t_mono": t_mono,
        "host": _HOST,
    }
    event.update(fields)
    trace.setdefault("events", []).append(event)
    return trace


def trace_from_payload(payload: Any) -> Optional[Dict[str, Any]]:
    """Extract a well-formed trace dict from a job's extras, or None."""
    if not isinstance(payload, dict):
        return None
    trace = payload.get(TRACE_FIELD)
    if isinstance(trace, dict) and isinstance(trace.get("events"), list):
        return trace
    return None


def mono_to_wall(t_mono: float) -> float:
    """Project a monotonic stamp from THIS host onto the wall clock."""
    return clock.wall() - (clock.monotonic() - t_mono)


# --- JSONL event-log sink ---------------------------------------------------

def trace_log_path() -> Optional[str]:
    return os.environ.get("LLMQ_TRACE_LOG") or None


def emit_trace_event(
    job_id: str, name: str, **fields: Any
) -> None:
    """Append one structured event line to the LLMQ_TRACE_LOG sink.

    No-op (one env read) when the sink is off. Failures are swallowed:
    an unwritable log must never take down a worker.
    """
    path = trace_log_path()
    if path is None:
        return
    record = {
        "job_id": job_id,
        "event": name,
        "t_wall": clock.wall(),
        "t_mono": clock.monotonic(),
        "host": _HOST,
    }
    record.update(fields)
    try:
        line = json.dumps(record, default=str)
        with _sink_lock:
            with open(path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
    except Exception:  # noqa: BLE001 — observability is best-effort
        pass


def record_transition(
    trace: Optional[Dict[str, Any]],
    job_id: str,
    name: str,
    *,
    on_trace: Optional[Dict[str, Any]] = None,
    on_sink: Optional[Dict[str, Any]] = None,
    **fields: Any,
) -> None:
    """One lifecycle transition: an event on ``trace`` (when there is one)
    with ``fields`` and then ``on_trace``, and a sink line with ``on_sink``
    and then ``fields``."""
    trace_event(trace, name, **fields, **(on_trace or {}))
    emit_trace_event(job_id, name, **(on_sink or {}), **fields)


# --- timeline rendering -----------------------------------------------------

def timeline(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flatten a trace into renderable rows: name, wall time, delta from
    the previous event (monotonic when both events share a host, wall
    otherwise), and any extra fields the event carried."""
    events = [
        e for e in trace.get("events", [])
        if isinstance(e, dict) and "name" in e
    ]
    events.sort(key=lambda e: e.get("t_wall", 0.0))
    rows: List[Dict[str, Any]] = []
    prev: Optional[Dict[str, Any]] = None
    for event in events:
        delta: Optional[float] = None
        if prev is not None:
            same_host = event.get("host") == prev.get("host")
            if same_host and "t_mono" in event and "t_mono" in prev:
                delta = event["t_mono"] - prev["t_mono"]
            elif "t_wall" in event and "t_wall" in prev:
                delta = event["t_wall"] - prev["t_wall"]
        extras = {
            k: v
            for k, v in event.items()
            if k not in ("name", "t_wall", "t_mono", "host")
        }
        rows.append(
            {
                "name": event["name"],
                "t_wall": event.get("t_wall"),
                "delta_s": delta,
                "extras": extras,
            }
        )
        prev = event
    return rows
