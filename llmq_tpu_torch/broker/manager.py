"""High-level broker facade used by workers (port of the worker-facing part
of ``llmq_tpu/broker/manager.py``).

One broker session, always a :class:`~llmq_tpu_torch.broker.resilient.ResilientBroker`
(re-dial, topology and consumer replay, settle fencing, a bounded outbox),
plus the llmq queue conventions: the topology a worker declares with its
TTL and redelivery caps, heartbeats peeked from ``<queue>.health``, job
publishing with deadline stamping, the ``<queue>.interactive`` fast lane
and deadline admission control, results, stats and the dead-letter queue.

Pipelines: ``setup_pipeline_infrastructure`` declares every stage queue
and the final results queue, and ``publish_pipeline_result`` routes a
stage's result to the next stage as a job built by
``build_next_stage_job`` (the next stage's own template over the
previous output as ``{result}`` and every passthrough extra), or to
``pipeline.<name>.results`` after the last stage.

Left for later slices: the lifecycle trace the reference stamps into each
published payload (``TRACE_FIELD``; ROADMAP.md queue 1, M16), and
prefix-affinity routing, the decode-peer discovery and the orphan
janitor (``affinity_targets``, ``decode_targets``,
``reclaim_orphaned_affinity_queues``, with the names of the per-worker
queues they use; M6's second part, whose settings
``core/config.py::refuse_unported`` refuses). The queue names the port
uses are ``broker/base.py``'s, re-exported here.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, List, Optional

from llmq_tpu_torch.broker.base import (
    DECODE_SUFFIX,
    INTERACTIVE_SUFFIX,
    RESULTS_SUFFIX,
    Broker,
    DeliveredMessage,
    MessageHandler,
    decode_queue_name,
    interactive_queue_name,
    results_queue_name,
)
from llmq_tpu_torch.broker.resilient import ResilientBroker, SessionStats
from llmq_tpu_torch.core.config import Config, get_config
from llmq_tpu_torch.core.models import ErrorInfo, Job, QueueStats, Result, WorkerHealth, utcnow
from llmq_tpu_torch.core.pipeline import PipelineConfig, PipelineStage
from llmq_tpu_torch.core.template import resolve_template_string, resolve_template_value
from llmq_tpu_torch.utils import clock

logger = logging.getLogger(__name__)

__all__ = [
    "AFFINITY_REFRESH_S", "BrokerManager", "DECODE_SUFFIX", "FAILED_SUFFIX", "HEALTH_SUFFIX",
    "HEARTBEAT_INTERVAL_S", "INTERACTIVE_SUFFIX", "QUARANTINE_SUFFIX", "RESULTS_SUFFIX",
    "STALE_AFTER_S", "decode_queue_name", "interactive_queue_name", "results_queue_name",
]

FAILED_SUFFIX = ".failed"
HEALTH_SUFFIX = ".health"
QUARANTINE_SUFFIX = ".quarantine"

# Heartbeat cadence (workers publish WorkerHealth this often) and the
# fleet-wide staleness threshold derived from it: a worker that missed two
# beats is treated as gone.
HEARTBEAT_INTERVAL_S = 30.0
STALE_AFTER_S = 2 * HEARTBEAT_INTERVAL_S

# How long an observed fleet rate is trusted before re-peeking heartbeats.
AFFINITY_REFRESH_S = 10.0


class BrokerManager:
    """One broker session + the llmq queue topology conventions."""

    def __init__(self, config: Optional[Config] = None, url: Optional[str] = None):
        self.config = config or get_config()
        self.url = url or self.config.broker_url
        self._broker: Optional[Broker] = None
        # Per-queue observed fleet service rate (stamp, jobs/s) for
        # deadline admission control; one entry per served queue.
        self._fleet_rate: Dict[str, tuple] = {}
        self.jobs_shed = 0
        self.jobs_shed_interactive = 0
        self.interactive_routed = 0

    @property
    def broker(self) -> Broker:
        if self._broker is None:
            raise RuntimeError("BrokerManager is not connected")
        return self._broker

    @property
    def connected(self) -> bool:
        return self._broker is not None

    @property
    def transport_connected(self) -> bool:
        """Is the underlying transport live right now (vs. reconnecting)?"""
        return self._broker is not None and self._broker.is_connected

    @property
    def session_stats(self) -> Optional[SessionStats]:
        """Reconnect/outbox/fence counters for the current session."""
        return getattr(self._broker, "session", None)

    async def connect(self) -> None:
        if self._broker is None:
            broker = ResilientBroker(
                self.url,
                reconnect_base_delay=self.config.reconnect_base_delay_s,
                reconnect_max_delay=self.config.reconnect_max_delay_s,
                outbox_limit=self.config.outbox_limit,
            )
            await broker.connect()
            self._broker = broker
            logger.debug("Connected to broker at %s", self.url)

    async def disconnect(self) -> None:
        if self._broker is not None:
            await self._broker.close()
            self._broker = None

    async def __aenter__(self) -> "BrokerManager":
        await self.connect()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.disconnect()

    # --- topology ---------------------------------------------------------
    async def setup_queue_infrastructure(self, queue: str) -> None:
        """Declare ``<q>`` (the job TTL and redelivery cap), ``<q>.results``
        (cap 1e9), ``<q>.failed``, and when configured ``<q>.interactive``,
        ``<q>.quarantine`` and ``<q>.decode``."""
        await self.broker.declare_queue(
            queue,
            ttl_ms=self.config.job_ttl_ms,
            max_redeliveries=self.config.max_redeliveries,
        )
        # Results are durable downloads: receivers may requeue (e.g. past a
        # --limit) arbitrarily often without the message dead-lettering.
        await self.broker.declare_queue(
            results_queue_name(queue), max_redeliveries=1_000_000_000
        )
        await self.broker.declare_queue(queue + FAILED_SUFFIX)
        if self.config.priority_classes:
            # SLO fast lane: same retention policy as the shared queue.
            await self.broker.declare_queue(
                interactive_queue_name(queue),
                ttl_ms=self.config.job_ttl_ms,
                max_redeliveries=self.config.max_redeliveries,
            )
        if self.config.quarantine_attempts > 0:
            await self.broker.declare_queue(queue + QUARANTINE_SUFFIX)
        if self.config.worker_role != "unified":
            # Disaggregated fleets need the decode-pool queue up front.
            await self.broker.declare_queue(
                decode_queue_name(queue),
                ttl_ms=self.config.job_ttl_ms,
                max_redeliveries=self.config.max_redeliveries,
            )
        # The reference starts its affinity-orphan janitor here when prefix
        # affinity is on or the role is not unified. The port creates no
        # per-worker queue for it to reclaim (M6's second part; prefix
        # affinity is refused by core/config.py::refuse_unported).

    async def setup_pipeline_infrastructure(self, pipeline: PipelineConfig) -> None:
        """Declare every stage queue (the job TTL and redelivery cap) with
        its ``.failed``, and the single final results queue (cap 1e9)."""
        for qname in pipeline.stage_queue_names():
            await self.broker.declare_queue(
                qname,
                ttl_ms=self.config.job_ttl_ms,
                max_redeliveries=self.config.max_redeliveries,
            )
            await self.broker.declare_queue(qname + FAILED_SUFFIX)
        await self.broker.declare_queue(
            pipeline.get_pipeline_results_queue_name(), max_redeliveries=1_000_000_000
        )

    # --- worker heartbeats ------------------------------------------------
    async def get_worker_health(self, queue: str) -> Dict[str, WorkerHealth]:
        """Non-destructive heartbeat peek: the freshest WorkerHealth per
        worker on ``<queue>.health``. Every message is requeued so the
        next reader still sees it."""
        beats: Dict[str, WorkerHealth] = {}
        peeked: List[DeliveredMessage] = []
        try:
            while True:
                msg = await self.broker.get(queue + HEALTH_SUFFIX)
                if msg is None:
                    break
                peeked.append(msg)
                try:
                    health = WorkerHealth.model_validate_json(msg.body)
                except Exception as exc:  # noqa: BLE001 — skip malformed
                    logger.debug("Skipping malformed heartbeat: %s", exc)
                    continue
                prev = beats.get(health.worker_id)
                if prev is None or health.last_seen >= prev.last_seen:
                    beats[health.worker_id] = health
        finally:
            for msg in peeked:
                await msg.reject(requeue=True)
        return beats

    # --- deadline admission control ---------------------------------------
    async def _observed_fleet_rate(self, queue: str) -> Optional[float]:
        """Aggregate fleet service rate (jobs/s) from fresh heartbeats'
        avg_duration_ms. None when no worker has reported a duration yet
        (then admission control stays out of the way). Cached for
        ``AFFINITY_REFRESH_S``."""
        now = clock.monotonic()
        cached = self._fleet_rate.get(queue)
        if cached is not None and now - cached[0] < AFFINITY_REFRESH_S:
            return cached[1]
        try:
            beats = await self.get_worker_health(queue)
        except Exception:  # noqa: BLE001
            beats = {}
        wall = utcnow()
        rate = 0.0
        for health in beats.values():
            if (wall - health.last_seen).total_seconds() > STALE_AFTER_S:
                continue
            if health.avg_duration_ms and health.avg_duration_ms > 0:
                rate += 1000.0 / health.avg_duration_ms
        result = rate if rate > 0 else None
        self._fleet_rate[queue] = (now, result)
        return result

    async def _should_shed(
        self, queue: str, deadline_at: float, depth_queue: Optional[str] = None
    ) -> bool:
        """Publish-side load shedding: when queue depth divided by the
        observed fleet service rate cannot meet this job's deadline, fail
        it now. ``depth_queue`` judges a fast-lane job against its lane's
        backlog (the rate still comes from the base queue's heartbeats)."""
        budget_s = deadline_at - clock.wall()
        if budget_s <= 0:
            return True  # already expired at submit
        rate = await self._observed_fleet_rate(queue)
        if rate is None:
            return False  # no observed service rate: don't guess
        try:
            depth = (await self.get_queue_stats(depth_queue or queue)).message_count_ready
        except Exception:  # noqa: BLE001
            depth = None
        if depth is None:
            return False
        return depth / rate > budget_s

    async def shed_job(self, queue: str, job: Job, *, reason: str) -> None:
        """Dead-letter a job at admission time as ``deadline_exceeded``,
        with the same headers a worker-side deadline expiry produces."""
        payload = job.model_dump(mode="json")
        await self.broker.publish(
            queue + FAILED_SUFFIX,
            json.dumps(payload, default=str).encode("utf-8"),
            message_id=job.id,
            headers={
                "x-error": "deadline_exceeded",
                "x-failure-reason": "deadline_exceeded",
                "x-shed": reason,
            },
        )
        self.jobs_shed += 1
        if job.priority_class == "interactive":
            self.jobs_shed_interactive += 1

    # --- publish ----------------------------------------------------------
    async def publish_job(self, queue: str, job: Job) -> None:
        # Deadline stamping: a fresh submit converts the relative budget
        # (job field, else config default) into an absolute deadline_at.
        # Re-publishes already carry deadline_at and keep it.
        if job.deadline_at is None:
            budget_ms = job.deadline_ms or self.config.deadline_ms or 0
            if budget_ms > 0:
                job.deadline_at = clock.wall() + budget_ms / 1000.0
        interactive = (
            self.config.priority_classes
            and job.priority_class == "interactive"
            and not queue.endswith(INTERACTIVE_SUFFIX)
        )
        if job.deadline_at is not None:
            try:
                shed = await self._should_shed(
                    queue,
                    job.deadline_at,
                    depth_queue=interactive_queue_name(queue) if interactive else None,
                )
            except Exception:  # noqa: BLE001 — admission control best-effort
                shed = False
            if shed:
                await self.shed_job(queue, job, reason="admission_control")
                return
        target = queue
        if interactive:
            target = interactive_queue_name(queue)
            self.interactive_routed += 1
        payload = job.model_dump(mode="json")
        await self.broker.publish(
            target,
            json.dumps(payload, default=str).encode("utf-8"),
            message_id=job.id,
        )

    async def publish_result(self, queue: str, result: Result) -> None:
        await self.broker.publish(
            results_queue_name(queue),
            result.model_dump_json().encode("utf-8"),
            message_id=result.id,
        )

    async def publish_pipeline_result(
        self, pipeline: PipelineConfig, stage_name: str, result: Result
    ) -> None:
        """Route a stage result: the last stage's to the pipeline's results
        queue, any other's as the next stage's job (its template applied)."""
        nxt = pipeline.next_stage(stage_name)
        if nxt is None:
            await self.broker.publish(
                pipeline.get_pipeline_results_queue_name(),
                result.model_dump_json().encode("utf-8"),
                message_id=result.id,
            )
            return
        job = self.build_next_stage_job(result, nxt)
        await self.publish_job(pipeline.get_stage_queue_name(nxt.name), job)

    @staticmethod
    def build_next_stage_job(result: Result, next_stage: PipelineStage) -> Job:
        """Result -> the next stage's Job, under the next stage's own
        template. Its variables: every passthrough extra, ``{result}``
        (the previous stage's output) and ``{prompt}`` (its formatted
        prompt). With no template the previous output is the prompt. The
        upstream output stays as ``previous_result`` (the first stage's
        kept through later stages)."""
        extras = {
            k: v
            for k, v in result.model_dump().items()
            if k not in {"id", "prompt", "result", "worker_id", "duration_ms", "timestamp",
                         "usage"}
        }
        template_vars: Dict[str, Any] = {**extras, "result": result.result,
                                         "prompt": result.prompt}
        payload: Dict[str, Any] = {"id": result.id, **extras}
        messages_tpl = next_stage.messages_template()
        prompt_tpl = next_stage.prompt_template()
        if messages_tpl is not None:
            payload["messages"] = resolve_template_value(messages_tpl, template_vars)
        elif prompt_tpl is not None:
            payload["prompt"] = resolve_template_string(prompt_tpl, template_vars)
        else:
            payload["prompt"] = result.result
        payload.setdefault("previous_result", result.result)
        return Job(**payload)

    # --- consume ----------------------------------------------------------
    async def consume_jobs(
        self, queue: str, handler: MessageHandler, *, prefetch: Optional[int] = None
    ) -> str:
        return await self.broker.consume(
            queue, handler, prefetch=prefetch or self.config.queue_prefetch
        )

    async def consume_results(
        self, queue: str, handler: MessageHandler, *, prefetch: int = 100
    ) -> str:
        """Consume from a results queue; bare queue names get ``.results``
        appended (and the queue's topology declared)."""
        qname = results_queue_name(queue)
        if qname != queue:
            await self.setup_queue_infrastructure(queue)
        return await self.broker.consume(qname, handler, prefetch=prefetch)

    async def cancel(self, consumer_tag: str, *, requeue: bool = True) -> None:
        await self.broker.cancel(consumer_tag, requeue=requeue)

    # --- ops --------------------------------------------------------------
    async def get_queue_stats(self, queue: str) -> QueueStats:
        return await self.broker.stats(queue)

    async def get_failed_jobs(self, queue: str, limit: int = 10) -> List[ErrorInfo]:
        """Peek the DLQ non-destructively (messages are requeued after read)."""
        dlq = queue + FAILED_SUFFIX
        errors: List[ErrorInfo] = []
        fetched: List[DeliveredMessage] = []
        for _ in range(limit):
            msg = await self.broker.get(dlq)
            if msg is None:
                break
            fetched.append(msg)
            try:
                data = json.loads(msg.body.decode("utf-8"))
            except json.JSONDecodeError:
                data = {"id": msg.message_id}
            errors.append(
                ErrorInfo(
                    job_id=str(data.get("id", msg.message_id)),
                    error_message=str(msg.headers.get("x-error", "exceeded redelivery limit")),
                    worker_id=msg.headers.get("x-worker-id"),
                    redeliveries=int(msg.headers.get("x-delivery-count", 0) or 0),
                    failure_reason=msg.headers.get("x-failure-reason"),
                )
            )
        for msg in fetched:
            await msg.reject(requeue=True)  # put back for later inspection
        return errors

    async def requeue_failed(self, queue: str, limit: Optional[int] = None) -> int:
        """Move dead-lettered jobs back onto the main queue for retry
        (destructive on the DLQ). Returns the count moved. The re-published
        copy drops the ``x-`` bookkeeping headers so the redelivery counter
        starts fresh. The drain is bounded by the DLQ's initial depth, so a
        worker that re-dead-letters requeued jobs meanwhile cannot loop it."""
        dlq = queue + FAILED_SUFFIX
        depth = (await self.get_queue_stats(dlq)).message_count
        seen: set = set()
        moved = 0
        cap = 10_000 if depth is None and limit is None else None
        while limit is None or moved < limit:
            if depth is not None and moved >= depth:
                break
            if cap is not None and moved >= cap:
                break
            msg = await self.broker.get(dlq)
            if msg is None:
                break
            if msg.message_id is not None:
                if msg.message_id in seen:  # came around again: stop
                    await msg.reject(requeue=True)
                    break
                seen.add(msg.message_id)
            headers = {k: v for k, v in (msg.headers or {}).items() if not k.startswith("x-")}
            await self.broker.publish(queue, msg.body, message_id=msg.message_id,
                                      headers=headers)
            await msg.ack()
            moved += 1
        return moved

    async def purge_queue(self, queue: str) -> int:
        return await self.broker.purge(queue)
