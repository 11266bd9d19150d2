"""Operator commands (port of ``llmq_tpu/cli/monitor.py``).

``status`` (connection probe / queue table / pipeline view), ``health``
(queue heuristics + live worker heartbeats), ``errors`` (dead-letter listing
and requeue), ``clear`` (purge), ``monitor top`` (:func:`monitor_top`, the
fleet dashboard over the fresh heartbeats: tok/s, occupancy, prefix hit
rate, TTFT / ITL percentiles, the self-heal, integrity, role and
interactive columns once a worker reports them) and ``trace``
(:func:`trace_job`, a job's lifecycle timeline from the trace in its
result, or from its dead letter). Each prints the reference's fields,
cells and messages on stdout as plain text tables (the reference renders
them with ``rich``, which the port does not carry; its colour markup is
dropped, the text kept).
"""

from __future__ import annotations

import asyncio
import json
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence, Tuple

from llmq_tpu_torch.broker.manager import (
    FAILED_SUFFIX,
    QUARANTINE_SUFFIX,
    STALE_AFTER_S,
    BrokerManager,
    decode_queue_name,
    interactive_queue_name,
    results_queue_name,
)
from llmq_tpu_torch.core.config import get_config
from llmq_tpu_torch.core.models import QueueStats, WorkerHealth, utcnow
from llmq_tpu_torch.core.pipeline import load_pipeline_config
from llmq_tpu_torch.obs.trace import timeline, trace_from_payload

BACKLOG_WARN_THRESHOLD = 10_000


def _table_text(title: str, columns: Sequence[str], rows: List[Sequence[str]]) -> str:
    """A titled table, its columns padded to their widest cell."""
    widths = [max([len(c)] + [len(str(r[i])) for r in rows]) for i, c in enumerate(columns)]

    def line(cells) -> str:
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()

    return "\n".join([title, line(columns), line("-" * w for w in widths)]
                     + [line(row) for row in rows])


def _print_table(title: str, columns: Sequence[str], rows: List[Sequence[str]]) -> None:
    print(_table_text(title, columns, rows))


def _stale_window_text() -> str:
    """The heartbeat freshness window in words, from ``STALE_AFTER_S``."""
    secs = int(STALE_AFTER_S)
    if secs % 60 == 0:
        return f"{secs // 60} min"
    return f"{secs}s"


async def show_connection_status() -> None:
    cfg = get_config()
    mgr = BrokerManager(cfg)
    try:
        await mgr.connect()
        print(f"✓ Connected to broker at {cfg.broker_url}")
        await mgr.disconnect()
    except Exception as exc:  # noqa: BLE001
        print(f"✗ Cannot connect to {cfg.broker_url}: {exc}")


def _stats_row(stats: QueueStats) -> List[str]:
    def fmt(v) -> str:
        return "-" if v is None else str(v)

    return [
        stats.queue_name,
        fmt(stats.message_count),
        fmt(stats.message_count_ready),
        fmt(stats.message_count_unacknowledged),
        fmt(stats.consumer_count),
        _fmt_bytes(stats.message_bytes),
    ]


def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024:
            return f"{n:.0f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


async def show_status(queue: str) -> None:
    async with BrokerManager(get_config()) as mgr:
        rows = [_stats_row(await mgr.get_queue_stats(q))
                for q in (queue, f"{queue}.results", f"{queue}.failed")]
        _print_table(f"Queue status: {queue}",
                     ("queue", "total", "ready", "unacked", "consumers", "bytes"), rows)
        _print_warnings(await mgr.get_queue_stats(queue))


def _print_warnings(stats: QueueStats) -> None:
    if (stats.consumer_count or 0) == 0 and (stats.message_count_ready or 0) > 0:
        print("⚠ No consumers — jobs will sit in the queue until a worker attaches")
    if (stats.message_count_ready or 0) > BACKLOG_WARN_THRESHOLD:
        print(f"⚠ Large backlog ({stats.message_count_ready} ready messages)")


async def check_health(queue: str) -> None:
    """Queue heuristics + live worker heartbeats (non-destructive peek of
    ``<queue>.health``)."""
    async with BrokerManager(get_config()) as mgr:
        stats = await mgr.get_queue_stats(queue)
        healthy = True
        if stats.stats_source == "unavailable":
            print(f"✗ Queue '{queue}' does not exist")
            return
        if (stats.message_count_ready or 0) > BACKLOG_WARN_THRESHOLD:
            healthy = False
            print(f"⚠ Backlog: {stats.message_count_ready} ready")
        beats: Dict[str, WorkerHealth] = await mgr.get_worker_health(queue)
        # A heartbeat older than 2x the interval means a missed beat:
        # wedged, or cut off from the broker. Stale workers are not live.
        now = utcnow()
        stale_ids = {wid for wid, health in beats.items()
                     if (now - health.last_seen).total_seconds() > STALE_AFTER_S}
        fresh = {wid: h for wid, h in beats.items() if wid not in stale_ids}
        # Liveness: the broker's consumer census where it has one
        # (memory/tcp), else the heartbeats (the file broker cannot see
        # other processes' consumers).
        if stats.consumer_count is not None:
            if stats.consumer_count == 0 and not fresh:
                healthy = False
                print("✗ No workers consuming")
        elif not fresh:
            healthy = False
            print(f"✗ No fresh worker heartbeats in the last {_stale_window_text()}")
        if stale_ids:
            healthy = False
            print(f"✗ {len(stale_ids)} worker(s) stale (no heartbeat in {STALE_AFTER_S:.0f}s)")
        if beats:
            rows = []
            for wid, health in beats.items():
                rows.append([
                    health.worker_id,
                    "stale" if wid in stale_ids else health.status,
                    str(health.jobs_processed),
                    f"{health.avg_duration_ms:.0f}" if health.avg_duration_ms else "-",
                    str(health.reconnects) if health.reconnects is not None else "-",
                    health.last_seen.strftime("%H:%M:%S"),
                ])
            _print_table(f"Worker heartbeats (last {_stale_window_text()})",
                         ("worker", "status", "jobs", "avg ms", "reconnects", "last seen"), rows)
        if healthy:
            print(f"✓ Queue '{queue}' looks healthy")


async def show_errors(queue: str, *, limit: int = 10) -> None:
    async with BrokerManager(get_config()) as mgr:
        errors = await mgr.get_failed_jobs(queue, limit=limit)
        if not errors:
            print(f"No dead-lettered jobs in '{queue}.failed'")
            return
        rows = [[err.job_id, err.error_message, err.failure_reason or "-",
                 str(err.redeliveries), err.worker_id or "-"] for err in errors]
        _print_table(f"Dead-lettered jobs: {queue}.failed",
                     ("job id", "error", "reason", "redeliveries", "worker"), rows)


async def requeue_errors(queue: str, *, limit: Optional[int] = 10) -> None:
    async with BrokerManager(get_config()) as mgr:
        n = await mgr.requeue_failed(queue, limit=limit)
        remaining = (await mgr.get_queue_stats(queue + ".failed")).message_count
        if n:
            tail = (f" ({remaining} still dead-lettered — raise --limit or use --limit 0)"
                    if remaining else "")
            print(f"Requeued {n} failed job(s) from '{queue}.failed' back to '{queue}'{tail}")
        else:
            print(f"No dead-lettered jobs in '{queue}.failed'")


async def clear_queue(queue: str) -> None:
    async with BrokerManager(get_config()) as mgr:
        n = await mgr.purge_queue(queue)
        print(f"Purged {n} messages from '{queue}'")


async def show_pipeline_status(pipeline_path: str) -> None:
    """Per-stage stats, the flow line and each stage's status."""
    pipeline = load_pipeline_config(pipeline_path)
    async with BrokerManager(get_config()) as mgr:
        rows: List[List[str]] = []
        flow_parts: List[str] = []
        warnings: List[str] = []
        for stage in pipeline.stages:
            stats = await mgr.get_queue_stats(pipeline.get_stage_queue_name(stage.name))
            ready = stats.message_count_ready or 0
            consumers = stats.consumer_count or 0
            if consumers == 0 and ready > 0:
                status = "NO WORKERS"
                warnings.append(f"Stage '{stage.name}' has {ready} jobs but no workers")
            elif ready > BACKLOG_WARN_THRESHOLD:
                status = "BACKLOG"
                warnings.append(f"Stage '{stage.name}' backlog: {ready}")
            else:
                status = "HEALTHY"
            rows.append([stage.name, stage.worker, str(ready),
                         str(stats.message_count_unacknowledged or 0),
                         str(consumers) if stats.consumer_count is not None else "-", status])
            flow_parts.append(f"{stage.name}({ready})")
        results_stats = await mgr.get_queue_stats(pipeline.get_pipeline_results_queue_name())
        flow_parts.append(f"results({results_stats.message_count_ready or 0})")
        _print_table(f"Pipeline: {pipeline.name}",
                     ("stage", "worker", "ready", "unacked", "consumers", "status"), rows)
        print("flow: " + " → ".join(flow_parts))
        for warning in warnings:
            print(f"⚠ {warning}")


# --- live dashboard -----------------------------------------------------------

def _fmt_pcts(es: dict, lo_key: str, hi_key: str) -> str:
    lo, hi = es.get(lo_key), es.get(hi_key)
    if lo is None and hi is None:
        return "-"

    def f(v):
        return "-" if v is None else f"{v:.0f}"

    return f"{f(lo)}/{f(hi)}"


def _selfheal_cell(es: dict) -> str:
    """Compact per-worker robustness summary from the heartbeat's engine
    stats: "-" until some counter moved."""
    parts = []
    for key, tag in (("jobs_deadline_exceeded", "ddl"), ("jobs_quarantined", "quar"),
                     ("kv_fetch_failures", "kvf"), ("kv_serve_busy_rejects", "busy"),
                     ("engine_rebuilds", "rbld"), ("watchdog_trips", "wdt"),
                     ("hbm_oom_events", "oom")):
        value = es.get(key)
        if value:
            parts.append(f"{tag}:{value}")
    if es.get("wedged_dispatch"):
        # A dispatch in flight past its watchdog deadline right now.
        parts.append(f"WEDGED:{es['wedged_dispatch']}")
    if es.get("breaker_tripped"):
        parts.append("BRK")
    return " ".join(parts) if parts else "-"


def _integrity_cell(health: WorkerHealth, es: dict) -> str:
    """The heartbeat's integrity verdict and corruption counters: "-" until
    an integrity knob is on."""
    parts = []
    if health.integrity == "suspect":
        parts.append("SUSPECT")
    elif health.integrity == "ok":
        parts.append("ok")
    for key, tag in (("guard_trips", "grd"), ("weight_audit_mismatches", "wam"),
                     ("canary_failures", "cnr"), ("result_digest_mismatches", "rdm")):
        value = es.get(key)
        if value:
            parts.append(f"{tag}:{value}")
    return " ".join(parts) if parts else "-"


def _median(values: List[float]) -> float:
    ordered = sorted(values)
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def _role_summary(fresh: Dict[str, WorkerHealth], decode_depth: Optional[int]) -> str:
    """The per-role fleet line of a disaggregated fleet ("" for a unified
    one). Handoff percentiles are the fleet median of each worker's own
    (heartbeats carry no raw samples)."""
    roles = [h.role for h in fresh.values() if h.role]
    if not roles and decode_depth is None:
        return ""
    counts: Dict[str, int] = {}
    for role in roles:
        counts[role] = counts.get(role, 0) + 1
    # auto workers report their ACTIVE role; role_mode=auto marks them.
    autos = sum(1 for h in fresh.values() if (h.engine_stats or {}).get("role_mode") == "auto")
    parts = [f"roles p:{counts.get('prefill', 0)} d:{counts.get('decode', 0)}"
             + (f" (auto:{autos})" if autos else "")]
    if decode_depth is not None:
        parts.append(f"decode ready {decode_depth}")
    p50s = [v for v in ((h.engine_stats or {}).get("handoff_ms_p50") for h in fresh.values())
            if v is not None]
    p95s = [v for v in ((h.engine_stats or {}).get("handoff_ms_p95") for h in fresh.values())
            if v is not None]
    if p50s:
        parts.append(f"handoff p50/p95 {_median(p50s):.0f}/{_median(p95s):.0f} ms")
    return " | ".join(parts)


def _top_frame(
    queue: str,
    beats: Dict[str, WorkerHealth],
    stats: QueueStats,
    quarantine_depth: Optional[int] = None,
    top: int = 40,
    decode_depth: Optional[int] = None,
    interactive_depth: Optional[int] = None,
) -> Tuple[str, str, List[str], List[List[str]], Optional[str]]:
    """One refresh of the dashboard as (summary, title, columns, rows,
    caption), from the freshest heartbeat per worker: the summary covers
    the whole fleet, the rows the ``top`` busiest workers by batch
    occupancy (a caption counts the rest). Each optional column appears
    only once some worker reports it, as in the reference."""
    now = utcnow()
    fresh = {wid: h for wid, h in beats.items()
             if (now - h.last_seen).total_seconds() <= STALE_AFTER_S}
    fleet_toks = sum((h.engine_stats or {}).get("tokens_per_sec") or 0.0
                     for h in fresh.values())
    occs = [o for o in ((h.engine_stats or {}).get("batch_occupancy") for h in fresh.values())
            if o is not None]
    suspects = sum(1 for h in beats.values() if h.integrity == "suspect")
    header = (f"queue {queue} — {len(fresh)} fresh worker(s), {len(beats) - len(fresh)} stale"
              f" | ready {stats.message_count_ready or 0} | fleet {fleet_toks:.1f} tok/s")
    if occs:
        header += f" | occupancy {sum(occs) / len(occs):.0%}"
    if suspects:
        header += f" | suspect {suspects}"
    if quarantine_depth:
        header += f" | quarantined {quarantine_depth}"
    if interactive_depth is not None:
        header += f" | interactive ready {interactive_depth}"
    preempts = sum((h.engine_stats or {}).get("priority_preemptions") or 0
                   for h in fresh.values())
    if preempts:
        header += f" | preempts {preempts}"
    role_line = _role_summary(fresh, decode_depth)
    if role_line:
        header += "\n" + role_line
    show_selfheal = any(_selfheal_cell(h.engine_stats or {}) != "-" for h in beats.values())
    show_integrity = any(_integrity_cell(h, h.engine_stats or {}) != "-"
                         for h in beats.values())
    cols = ["worker", "status", "jobs", "tok/s", "occ", "pfx hit", "ttft p50/p95 ms",
            "itl p50/p95 ms", "reconnects", "last seen"]
    show_priority = any("ttft_p95_ms_interactive" in (h.engine_stats or {})
                        for h in beats.values())
    if show_priority:
        cols.insert(8, "int ttft/itl p95 ms")
    if show_integrity:
        cols.insert(8, "integrity")
    if show_selfheal:
        cols.insert(8, "self-heal")
    # Inserted last, so its index (after status) is unaffected by the
    # tail inserts above; the cells follow the same order.
    show_role = any(h.role for h in beats.values())
    if show_role:
        cols.insert(2, "role")

    def occupancy_key(item):
        wid, health = item
        occ = (health.engine_stats or {}).get("batch_occupancy")
        # Busiest first; ties (and workers not reporting it) by worker id.
        return (-(occ if occ is not None else -1.0), wid)

    ranked = sorted(beats.items(), key=occupancy_key)
    hidden = len(ranked) - top if top and len(ranked) > top else 0
    caption = None
    if hidden:
        ranked = ranked[:top]
        caption = f"+{hidden} more worker(s) below the top {top} by occupancy"
    rows = []
    for wid, health in ranked:
        es = health.engine_stats or {}
        is_stale = (now - health.last_seen).total_seconds() > STALE_AFTER_S
        occ = es.get("batch_occupancy")
        hit = es.get("prefix_hit_rate")
        cells = [
            wid,
            "stale" if is_stale else health.status,
            str(health.jobs_processed),
            f"{es['tokens_per_sec']:.1f}" if "tokens_per_sec" in es else "-",
            f"{occ:.0%}" if occ is not None else "-",
            f"{hit:.0%}" if hit is not None else "-",
            _fmt_pcts(es, "ttft_p50_ms", "ttft_p95_ms"),
            _fmt_pcts(es, "itl_p50_ms", "itl_p95_ms"),
            str(health.reconnects) if health.reconnects is not None else "-",
            health.last_seen.strftime("%H:%M:%S"),
        ]
        if show_priority:
            cells.insert(8, _fmt_pcts(es, "ttft_p95_ms_interactive", "itl_p95_ms_interactive"))
        if show_integrity:
            cells.insert(8, _integrity_cell(health, es))
        if show_selfheal:
            cells.insert(8, _selfheal_cell(es))
        if show_role:
            cells.insert(2, health.role or "-")
        rows.append(cells)
    return header, f"Worker heartbeats (last {_stale_window_text()})", cols, rows, caption


def _render_top(queue: str, beats: Dict[str, WorkerHealth], stats: QueueStats,
                **kwargs: Any) -> str:
    """One refresh of the dashboard as plain text."""
    header, title, cols, rows, caption = _top_frame(queue, beats, stats, **kwargs)
    text = header + "\n" + _table_text(title, cols, rows)
    return text + ("\n" + caption if caption else "")


async def monitor_top(queue: str, *, interval: float = 2.0, iterations: Optional[int] = None,
                      top: int = 40) -> None:
    """``monitor top``: the live fleet dashboard over the heartbeats, one
    refresh every ``interval`` seconds until interrupted (or
    ``iterations`` refreshes: ``--once`` is one)."""
    async with BrokerManager(get_config()) as mgr:
        count = 0
        while True:
            beats = await mgr.get_worker_health(queue)
            stats = await mgr.get_queue_stats(queue)
            # Each depth reads None while its queue does not exist: a
            # quarantine only exists once a worker filed something, the
            # decode pool only on a disaggregated fleet.
            qstats = await mgr.get_queue_stats(queue + QUARANTINE_SUFFIX)
            qdepth = qstats.message_count if qstats.stats_source != "unavailable" else None
            dstats = await mgr.get_queue_stats(decode_queue_name(queue))
            ddepth = (dstats.message_count_ready if dstats.stats_source != "unavailable"
                      else None)
            istats = await mgr.get_queue_stats(interactive_queue_name(queue))
            idepth = (istats.message_count_ready if istats.stats_source != "unavailable"
                      else None)
            # The fast lane's depth shows once it has a backlog or some
            # worker serves the interactive class.
            if not idepth and not any("ttft_p95_ms_interactive" in (h.engine_stats or {})
                                      for h in beats.values()):
                idepth = None
            frame = _render_top(queue, beats, stats, quarantine_depth=qdepth, top=top,
                                decode_depth=ddepth, interactive_depth=idepth)
            if iterations is None:
                print("\x1b[2J\x1b[H", end="")  # a terminal: redraw in place
            print(frame, flush=True)
            count += 1
            if iterations is not None and count >= iterations:
                return
            await asyncio.sleep(interval)


# --- per-request trace ----------------------------------------------------------

async def _find_message(mgr: BrokerManager, queue: str, job_id: str):
    """Peek ``queue`` for the message of ``job_id`` without consuming it
    (every message taken is requeued): (its payload, its headers), or None."""
    found = None
    peeked = []
    while True:
        msg = await mgr.broker.get(queue)
        if msg is None:
            break
        peeked.append(msg)
        try:
            payload = json.loads(msg.body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue  # not a JSON message; skip it
        if isinstance(payload, dict) and payload.get("id") == job_id:
            found = (payload, dict(msg.headers or {}))
            break
    for msg in peeked:
        await msg.reject(requeue=True)
    return found


async def trace_job(queue: str, job_id: str) -> None:
    """``trace JOB_ID -q QUEUE``: the request's lifecycle timeline from the
    trace record in its result (the results queue is peeked, not
    consumed). Without a result, the dead letter on ``<q>.failed`` (the
    original payload with its submit-time events, and headers saying where
    and after how many deliveries it died) explains why."""
    async with BrokerManager(get_config()) as mgr:
        found = await _find_message(mgr, results_queue_name(queue), job_id)
        dead_headers = None
        if found is None:
            found = await _find_message(mgr, queue + FAILED_SUFFIX, job_id)
            if found is not None:
                dead_headers = found[1]
        if found is None:
            print(f"✗ No result for job '{job_id}' in '{results_queue_name(queue)}' "
                  f"(and no dead-letter in '{queue + FAILED_SUFFIX}')")
            return
        record = found[0]
        if dead_headers is not None:
            print(f"Job '{job_id}' was dead-lettered from "
                  f"'{dead_headers.get('x-death-queue', queue)}' after "
                  f"{dead_headers.get('x-delivery-count', '?')} deliveries "
                  "(retry budget exhausted)")
        trace = trace_from_payload(record)
        if trace is None:
            print(f"Result for '{job_id}' carries no trace record "
                  "(submitted before tracing was deployed?)")
            return
        rows = timeline(trace)
        if dead_headers is not None:
            # The dying attempt's record never shipped (a redelivery
            # re-reads the original payload): the terminal event from the
            # dead letter's headers.
            rows.append({"name": "retry_exhausted", "t_wall": None, "delta_s": None,
                         "extras": {"redeliveries": dead_headers.get("x-delivery-count", "?")}})
        redeliveries = trace.get("redeliveries", 0)
        cells = []
        for row in rows:
            wall = (datetime.fromtimestamp(row["t_wall"], tz=timezone.utc)
                    .strftime("%H:%M:%S.%f")[:-3] if row["t_wall"] else "-")
            delta = f"+{row['delta_s'] * 1000:.2f}" if row["delta_s"] is not None else ""
            details = ", ".join(f"{k}={v}" for k, v in row["extras"].items())
            cells.append([row["name"], wall, delta, details])
        _print_table(f"Trace: {job_id}"
                     + (f" ({redeliveries} redelivery(s))" if redeliveries else ""),
                     ("event", "wall clock (UTC)", "Δ ms", "details"), cells)
        if len(rows) > 1 and rows[0]["t_wall"] and rows[-1]["t_wall"]:
            total_ms = (rows[-1]["t_wall"] - rows[0]["t_wall"]) * 1000.0
            print(f"total {total_ms:.1f} ms across {len(rows)} events")
