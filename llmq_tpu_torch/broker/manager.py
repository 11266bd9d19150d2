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

Prefix-affinity routing (``Config.prefix_affinity``): workers advertise
the text-chain digests of their hottest prompt prefixes in heartbeats;
``publish_job`` peeks them (non-destructively, cached for
``AFFINITY_REFRESH_S``) and sends a job whose prompt shares an advertised
prefix to that worker's private queue ``<queue>.w.<worker_id>``, where its
KV pages already are. No match, a stale heartbeat, or the flag off: the
shared queue. ``decode_targets`` finds the fresh decode-role workers a
prefill worker offers its handoffs to. The orphan janitor
(``start_affinity_janitor``, started by ``setup_queue_infrastructure``
when affinity is on or the role is not unified) returns what a dead
worker's private queues hold to the shared queues and deletes them.

Lifecycle trace: ``publish_job`` stamps a ``submitted`` event (and
``shed_job`` a ``shed`` one) into the payload's ``TRACE_FIELD`` record,
starting one when the job carries none, so the record rides every broker
hop and pipeline stage; the janitor logs an ``affinity_reclaimed`` event
to the ``LLMQ_TRACE_LOG`` sink for each message it moves. The shared
queue names are ``broker/base.py``'s, re-exported here; the per-worker
and per-request ones (``ctl_queue_name``, ``stream_queue_name``) are
defined here, as in the reference.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

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
from llmq_tpu_torch.obs.trace import (
    TRACE_FIELD,
    emit_trace_event,
    new_trace,
    record_transition,
    trace_event,
    trace_from_payload,
)
from llmq_tpu_torch.utils import clock
from llmq_tpu_torch.utils.aio import reap_all, spawn
from llmq_tpu_torch.utils.hashing import rendezvous_pick, text_prefix_chain

logger = logging.getLogger(__name__)

__all__ = [
    "AFFINITY_REFRESH_S", "BrokerManager", "DECODE_SUFFIX",
    "FAILED_SUFFIX", "HEALTH_SUFFIX", "HEARTBEAT_INTERVAL_S", "INTERACTIVE_SUFFIX",
    "QUARANTINE_SUFFIX", "RECLAIM_INTERVAL_S", "RESULTS_SUFFIX", "STALE_AFTER_S",
    "affinity_queue_name", "ctl_queue_name", "decode_adopt_queue_name", "decode_queue_name",
    "interactive_queue_name", "job_affinity_text", "kv_fetch_queue_name",
    "results_queue_name", "stream_queue_name", "watchdog_reclaim_s",
]

FAILED_SUFFIX = ".failed"
HEALTH_SUFFIX = ".health"
QUARANTINE_SUFFIX = ".quarantine"

# Heartbeat cadence (workers publish WorkerHealth this often) and the
# fleet-wide staleness threshold derived from it: a worker that missed two
# beats is treated as gone: its advertised pages stop routing jobs and its
# private queues become reclaimable.
HEARTBEAT_INTERVAL_S = 30.0
STALE_AFTER_S = 2 * HEARTBEAT_INTERVAL_S

# How long the fresh heartbeats of a queue (the affinity map, the decode
# pool and the fleet rate are read from them) are trusted before they are
# peeked again. A heartbeat older than STALE_AFTER_S routes no job, takes
# no offer and adds no rate: its worker may be gone.
AFFINITY_REFRESH_S = 10.0

# The orphan janitor's cadence (one reclaim pass a queue).
RECLAIM_INTERVAL_S = 15.0


def watchdog_reclaim_s() -> float:
    """``LLMQ_WATCHDOG_RECLAIM``: a worker whose heartbeat reports
    ``last_dispatch_ok_age_s`` at or past this many seconds is reclaimed
    although it still beats (a wedged engine under a live event loop).
    Unset, empty or 0 (the default): only silent workers reclaim."""
    raw = os.environ.get("LLMQ_WATCHDOG_RECLAIM", "").strip()
    if not raw:
        return 0.0
    try:
        return float(raw)
    except ValueError as exc:
        raise ValueError(
            f"LLMQ_WATCHDOG_RECLAIM must be a number of seconds, got {raw!r}") from exc


def affinity_queue_name(queue: str, worker_id: str) -> str:
    """The per-worker job queue that prefix-affinity routing targets."""
    return f"{queue}.w.{worker_id}"


def kv_fetch_queue_name(queue: str, worker_id: str) -> str:
    """The per-worker queue of prefix-page fetch requests and of the KV
    adoption offers of a disaggregated fleet; replies go to its ``.r``."""
    return f"{queue}.kv.{worker_id}"


def ctl_queue_name(queue: str, worker_id: str) -> str:
    """Per-worker control queue (cancellation). The streaming gateway
    publishes ``{"cancel": job_id}`` here when a client disconnects
    mid-stream; the worker cancels the request in its engine, freeing its
    pages and settling the job."""
    return f"{queue}.ctl.{worker_id}"


def stream_queue_name(queue: str, job_id: str) -> str:
    """Per-request token-delta stream queue. Workers publish incremental
    text frames here while the request decodes; the gateway forwards them
    as SSE chunks. Short-TTL and best-effort: the final ``Result`` on
    ``<q>.results`` remains the settlement of record."""
    return f"{queue}.stream.{job_id}"


def decode_adopt_queue_name(queue: str, worker_id: str) -> str:
    """The per-decode-worker adoption queue: a decode worker parks an
    accepted handoff here BEFORE it replies "accepted", so the payload
    survives either side dying mid-handshake (the janitor returns an
    orphaned one to ``<q>.decode``)."""
    return f"{queue}.d.{worker_id}"


def job_affinity_text(job: Job) -> str:
    """The prompt text whose leading chunks name the job's prefix: the
    characters the engine will tokenize, so the digests computed here match
    the ones workers advertise. "" where the prompt cannot be formatted."""
    try:
        if job.prompt is not None:
            return job.get_formatted_prompt()
        if job.messages:
            return "".join(str(m.get("content", "")) for m in job.messages)
    except Exception:  # noqa: BLE001 — an unresolvable template routes nowhere
        return ""
    return ""


class BrokerManager:
    """One broker session + the llmq queue topology conventions."""

    def __init__(self, config: Optional[Config] = None, url: Optional[str] = None):
        self.config = config or get_config()
        self.url = url or self.config.broker_url
        self._broker: Optional[Broker] = None
        # Per-queue (monotonic stamp of the peek, {worker id: fresh
        # heartbeat}); replaced whole on refresh.
        self._beats: Dict[str, Tuple[float, Dict[str, WorkerHealth]]] = {}
        # Per-queue {worker id: last heartbeat, epoch s}, kept past the
        # caches and past the heartbeats' TTL: routing re-checks freshness
        # per job, and the janitor still knows which private queues ever
        # existed. The janitor pops each worker it retires.
        self._worker_seen: Dict[str, Dict[str, float]] = {}
        self._janitors: Dict[str, Any] = {}
        self._janitor_tasks: set = set()
        # One heartbeat peek at a time (see get_worker_health), per loop.
        self._peek_lock: Optional[asyncio.Lock] = None
        self._peek_loop: Optional[asyncio.AbstractEventLoop] = None
        self.affinity_routed = 0
        self.affinity_fallback = 0
        self.affinity_reclaimed = 0
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
        await reap_all(self._janitor_tasks, label="affinity janitor")
        self._janitors.clear()
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
        ``<q>.quarantine`` and ``<q>.decode``; start the orphan janitor when
        affinity is on or the role is not unified."""
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
        if self.config.prefix_affinity or self.config.worker_role != "unified":
            self.start_affinity_janitor(queue)

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
    def _peeking(self) -> asyncio.Lock:
        loop = asyncio.get_running_loop()
        if self._peek_lock is None or self._peek_loop is not loop:
            self._peek_lock, self._peek_loop = asyncio.Lock(), loop
        return self._peek_lock

    async def get_worker_health(self, queue: str) -> Dict[str, WorkerHealth]:
        """Non-destructive heartbeat peek: the freshest WorkerHealth per
        worker on ``<queue>.health``. Every message is requeued so the
        next reader still sees it.

        The peek holds the heartbeats unacked until it ends, so a second
        peek that overlaps it finds the queue empty. The reference lets
        one manager's peeks overlap: a prefill worker whose prefills end
        together asks for its decode peers once a handoff, and all but the
        first see no peer and cache that for ``AFFINITY_REFRESH_S``, so
        their handoffs fall back to ``<q>.decode`` (ROADMAP.md queue 3
        item 16). Here one manager peeks once at a time, and the cached
        views re-check their cache after the wait."""
        async with self._peeking():
            return await self._peek_health(queue)

    async def _peek_health(self, queue: str) -> Dict[str, WorkerHealth]:
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

    async def _fresh_beats(self, queue: str) -> Dict[str, WorkerHealth]:
        """The heartbeats on ``queue`` no older than ``STALE_AFTER_S``, peeked
        at most once an ``AFFINITY_REFRESH_S`` (a caller that waited on
        another's peek takes its result), so a submit loop does not peek the
        health queue for each job."""
        async with self._peeking():
            now = clock.monotonic()
            cached = self._beats.get(queue)
            if cached is not None and now - cached[0] < AFFINITY_REFRESH_S:
                return cached[1]
            try:
                beats = await self._peek_health(queue)
            except Exception:  # noqa: BLE001 — health queue missing or unreadable
                beats = {}
            self._record_worker_seen(queue, beats)
            wall = utcnow()
            fresh = {wid: health for wid, health in beats.items()
                     if (wall - health.last_seen).total_seconds() <= STALE_AFTER_S}
            self._beats[queue] = (now, fresh)
            return fresh

    async def affinity_targets(self, queue: str) -> Dict[str, List[str]]:
        """``{text-chain digest hex: [worker id, ...]}`` from the fresh
        heartbeats."""
        mapping: Dict[str, List[str]] = {}
        for wid, health in (await self._fresh_beats(queue)).items():
            for digest in health.prefix_chains or []:
                mapping.setdefault(digest, []).append(wid)
        return mapping

    async def decode_targets(self, queue: str) -> Dict[str, List[str]]:
        """``{worker id: prefix chains}`` of the fresh decode-role workers
        on ``queue``, the candidates for a KV adoption offer (a stale pick
        is harmless: the peer replies busy)."""
        return {wid: list(health.prefix_chains or [])
                for wid, health in (await self._fresh_beats(queue)).items()
                if health.role == "decode"}

    def _record_worker_seen(self, queue: str, beats: Dict[str, WorkerHealth]) -> None:
        """Keep each worker's last heartbeat time (epoch s) beyond the caches
        and the heartbeats' TTL: route-time freshness and the janitor read it."""
        seen = self._worker_seen.setdefault(queue, {})
        for wid, health in beats.items():
            try:
                at = health.last_seen.timestamp()
            except Exception:  # noqa: BLE001 — a malformed timestamp
                continue
            if at > seen.get(wid, 0.0):
                seen[wid] = at

    def _fresh_workers(self, queue: str, workers: List[str]) -> List[str]:
        """The candidates whose heartbeat is within ``STALE_AFTER_S`` now: a
        cached map is up to ``AFFINITY_REFRESH_S`` old, and a worker can die
        inside that window."""
        seen = self._worker_seen.get(queue, {})
        now = clock.wall()
        return [w for w in workers if now - seen.get(w, 0.0) <= STALE_AFTER_S]

    async def _route_for_affinity(self, queue: str, job: Job) -> str:
        """The private queue of the worker advertising the job's deepest
        prefix digest, or the shared queue when nothing fresh matches."""
        chain = text_prefix_chain(job_affinity_text(job))
        if not chain:
            return queue
        mapping = await self.affinity_targets(queue)
        if not mapping:
            return queue
        # The deepest matching digest wins: it pins the most shared context.
        for digest in reversed(chain):
            workers = self._fresh_workers(queue, mapping.get(digest) or [])
            if workers:
                return affinity_queue_name(queue, rendezvous_pick(digest, workers))
        return queue

    # --- the orphan janitor -------------------------------------------------
    def start_affinity_janitor(self, queue: str, *,
                               interval_s: float = RECLAIM_INTERVAL_S) -> None:
        """Start the queue's background janitor (once a queue), which
        reclaims orphaned per-worker queues every ``interval_s``."""
        if queue in self._janitors:
            return

        async def loop() -> None:
            while True:
                await asyncio.sleep(interval_s)
                try:
                    await self.reclaim_orphaned_affinity_queues(queue)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — the janitor outlives blips
                    logger.debug("Affinity reclaim pass failed", exc_info=True)

        self._janitors[queue] = spawn(loop(), registry=self._janitor_tasks,
                                      name=f"affinity-janitor:{queue}")

    async def reclaim_orphaned_affinity_queues(self, queue: str) -> int:
        """One reclaim pass: for every worker this manager has seen beat on
        ``queue`` whose last beat is older than ``STALE_AFTER_S`` (or whose
        engine is wedged, :meth:`_stale_dispatch_workers`), reclaim its
        queues (:meth:`reclaim_worker_queues`). Returns the number of
        messages moved. Nothing
        else consumes a dead worker's queues, and the heartbeats' TTL
        erases the evidence that it lived: hence ``_worker_seen``."""
        try:
            beats = await self.get_worker_health(queue)
        except Exception:  # noqa: BLE001
            beats = {}
        self._record_worker_seen(queue, beats)
        seen = self._worker_seen.get(queue, {})
        now = clock.wall()
        reclaimed = 0
        wedged = self._stale_dispatch_workers(beats)
        for wid, last in list(seen.items()):
            if now - last <= STALE_AFTER_S and wid not in wedged:
                continue
            moved = await self.reclaim_worker_queues(queue, wid, trace=True)
            reclaimed += moved
            seen.pop(wid, None)
            logger.info("Reclaimed %s's queues on %s (%d stranded messages%s)", wid, queue, moved,
                        "; worker heartbeating but dispatch-wedged" if wid in wedged else "")
        self.affinity_reclaimed += reclaimed
        return reclaimed

    async def reclaim_worker_queues(self, queue: str, wid: str, *, trace: bool = False) -> int:
        """Move what worker ``wid``'s ``<q>.w.<id>`` holds back onto the
        shared queue and what its ``<q>.d.<id>`` holds onto ``<q>.decode``
        (ids, headers and payloads untouched, so traces and resume
        snapshots ride along), each message acked after its copy is out,
        then delete those and its ``<q>.kv.<id>``. The janitor does it for a
        dead worker (``trace``: an ``affinity_reclaimed`` sink event per
        message), a worker for itself as it stops. Returns the count moved."""
        moved = 0
        for src, dst in ((affinity_queue_name(queue, wid), queue),
                         (decode_adopt_queue_name(queue, wid), decode_queue_name(queue))):
            while (msg := await self.broker.get(src)) is not None:
                await self.broker.publish(dst, msg.body, message_id=msg.message_id,
                                          headers=msg.headers)
                await msg.ack()
                moved += 1
                if trace:
                    emit_trace_event(str(msg.message_id), "affinity_reclaimed", worker=wid)
            await self.broker.delete_queue(src)
        await self.broker.delete_queue(kv_fetch_queue_name(queue, wid))
        return moved

    def _stale_dispatch_workers(self, beats: Dict[str, WorkerHealth]) -> set:
        """Workers whose heartbeat is live but whose engine has completed no
        device dispatch for ``LLMQ_WATCHDOG_RECLAIM`` seconds or more. Empty
        with the knob off (the default) or no heartbeat carrying the field;
        the port's heartbeats carry it with the fault planes (M12)."""
        limit = watchdog_reclaim_s()
        if limit <= 0:
            return set()
        out = set()
        for wid, health in beats.items():
            age = health.last_dispatch_ok_age_s
            if age is not None and age >= limit:
                out.add(wid)
        return out

    # --- deadline admission control ---------------------------------------
    async def _observed_fleet_rate(self, queue: str) -> Optional[float]:
        """Aggregate fleet service rate (jobs/s) from the fresh heartbeats'
        avg_duration_ms. None when no worker has reported a duration yet
        (then admission control stays out of the way)."""
        rate = sum(1000.0 / health.avg_duration_ms
                   for health in (await self._fresh_beats(queue)).values()
                   if health.avg_duration_ms and health.avg_duration_ms > 0)
        return rate if rate > 0 else None

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
        trace = trace_from_payload(payload)
        if trace is None:
            trace = payload[TRACE_FIELD] = new_trace(job.id)
        record_transition(trace, job.id, "shed", queue=queue, reason=reason)
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
            # The fast lane beats affinity: every worker drains it ahead of
            # the shared backlog, which bounds time to first token better
            # than one worker's private queue.
            target = interactive_queue_name(queue)
            self.interactive_routed += 1
        elif self.config.prefix_affinity:
            try:
                target = await self._route_for_affinity(queue, job)
            except Exception:  # noqa: BLE001 — routing is best-effort
                logger.debug("Affinity routing failed", exc_info=True)
                target = queue
            if target != queue:
                self.affinity_routed += 1
            else:
                self.affinity_fallback += 1
        # The lifecycle trace rides in the payload itself, so it survives
        # broker hops, redeliveries and pipeline stage handoffs (a stage
        # handoff lands here again: a second "submitted", the next stage's
        # queue).
        payload = job.model_dump(mode="json")
        trace = trace_from_payload(payload)
        if trace is None:
            trace = payload[TRACE_FIELD] = new_trace(job.id)
        trace_event(trace, "submitted", queue=target)
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
