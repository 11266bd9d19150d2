"""Operator commands (port of the first part of ``llmq_tpu/cli/monitor.py``,
:1-293).

``status`` (connection probe / queue table / pipeline view), ``health``
(queue heuristics + live worker heartbeats), ``errors`` (dead-letter listing
and requeue), ``clear`` (purge). Each prints the reference's fields and
messages on stdout as plain text tables (the reference renders them with
``rich``, which the port does not carry). ``monitor top`` and ``trace`` read
the heartbeats' metrics and the lifecycle trace, which come with M16
(ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from llmq_tpu_torch.broker.manager import STALE_AFTER_S, BrokerManager
from llmq_tpu_torch.core.config import get_config
from llmq_tpu_torch.core.models import QueueStats, WorkerHealth, utcnow
from llmq_tpu_torch.core.pipeline import load_pipeline_config

BACKLOG_WARN_THRESHOLD = 10_000


def _print_table(title: str, columns: Sequence[str], rows: List[Sequence[str]]) -> None:
    """A titled table, its columns padded to their widest cell."""
    widths = [max([len(c)] + [len(str(r[i])) for r in rows]) for i, c in enumerate(columns)]

    def line(cells) -> str:
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()

    print(title)
    print(line(columns))
    print(line("-" * w for w in widths))
    for row in rows:
        print(line(row))


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
