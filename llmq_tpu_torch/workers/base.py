"""Worker base: lifecycle + message loop + failure policy (port of
``llmq_tpu/workers/base.py``).

A worker:

1. initialises its processor, connects to the broker through a
   ``BrokerManager`` (a resilient session) and declares its queues as
   ``setup_queue_infrastructure`` does (a pipeline stage's worker: every
   queue of its pipeline, ``setup_pipeline_infrastructure``), plus
   ``<queue>.health``;
2. consumes the queues of its role with prefetch = concurrency: ``<queue>``
   and the ``<queue>.interactive`` fast lane, with prefix affinity also
   its private ``<queue>.w.<id>`` (a job routed there while the worker
   drains bounces back to the shared queue); or, as a decode worker,
   ``<queue>.decode`` and its private adoption queue ``<queue>.d.<id>``.
   An ``auto`` worker starts as prefill and its controller
   (:meth:`_maybe_switch_role`, on the run loop) swaps the two sets when
   the shared:decode depth ratio leaves its band, after a dwell;
3. per message: parse -> claim-time guards (a lapsed deadline, the
   quarantine backstop, a prefill worker forwarding resume state) ->
   process (under ``job_timeout_s``) -> Result (with extra-field
   passthrough) -> publish once per ``(job id, resume offset)`` (a
   pipeline stage's result goes on to the next stage's queue, or to the
   pipeline's results after the last stage) -> ack;
4. on a timeout or any other error: remember the reason, count it against
   the circuit breaker (``breaker_failures`` consecutive failures
   self-drain the worker), quarantine the job to ``<queue>.quarantine`` at
   its ``quarantine_attempts``-th fleet-wide attempt, else reject-requeue
   (the broker dead-letters past ``max_redeliveries``); on ``ValueError``:
   ack and drop; an unparseable payload is dead-lettered to
   ``<queue>.failed`` with an ``x-error`` header;
5. at the prefill boundary (``PrefillDone``) offers the job with its
   prompt-KV snapshot to a decode peer (:meth:`_ship_to_decode_peer`, the
   processor's), and republishes it on ``<queue>.decode`` when no peer
   takes it;
6. publishes a ``WorkerHealth`` heartbeat every ``HEARTBEAT_INTERVAL_S``
   while the transport is up, with the processor's hot prefix chains and
   the metrics registry's summary (``LLMQ_METRICS_PORT`` also serves the
   registry on ``/metrics``, started in :meth:`initialize`);
7. on SIGINT / SIGTERM / :meth:`request_shutdown` (the breaker's too):
   drain-with-handoff (the processor hands unfinished requests back as
   resumable jobs), wait up to ``drain_timeout_s`` for in-flight jobs,
   return what its private queues still hold to the shared ones and
   delete them, clean up.

Lifecycle trace: each claim continues the record riding in the job
(``obs/trace.py``; a job that carries none starts one) and stamps
``claimed`` (``redeliveries``: the delivery's count, so a redelivered job
re-reads its original record and no event repeats), then ``finished``,
``deadline_exceeded``, ``quarantined``, ``retry_exhausted``, ``handoff``,
``prefill_done`` / ``kv_handoff``; the result carries the record, a
resumable or decode-pool republish carries it on. Every transition also
goes to the ``LLMQ_TRACE_LOG`` JSONL sink, with those that cannot stamp a
payload (``requeued``, ``dead_lettered``, ``dropped``, ``role_switch``,
``affinity_bounced``, ``breaker_tripped``, ``duplicate_suppressed``).

Device faults (``base.py:788-815``): a classified fault the engine could
not contain, or a job convicted as poison by the numerics guard, arrives
as ``DeviceFaultError``; its class (``hung_dispatch``, ``hbm_oom``,
``numerical_fault``, ...) goes to the breaker and into the quarantine /
dead-letter headers as ``x-failure-reason``. The heartbeat carries
``last_dispatch_ok_age_s`` (with the engine's watchdog on: what the
janitor's ``LLMQ_WATCHDOG_RECLAIM`` reads) and ``integrity`` (with an
integrity knob on), both omitted otherwise.

Two things are the port's own: ``broker_url`` (the ``TorchWorker``'s
argument) and the :meth:`_after_failure` hook, where the ``TorchWorker``
stops once its engine failed to contain a device fault (ROADMAP.md
queue 3).
"""

from __future__ import annotations

import abc
import asyncio
import json
import logging
import signal
from collections import deque
from typing import Any, List, Optional

from llmq_tpu_torch.broker.base import DeliveredMessage
from llmq_tpu_torch.broker.manager import (
    FAILED_SUFFIX,
    HEALTH_SUFFIX,
    HEARTBEAT_INTERVAL_S,
    QUARANTINE_SUFFIX,
    BrokerManager,
    affinity_queue_name,
    decode_adopt_queue_name,
    decode_queue_name,
    interactive_queue_name,
)
from llmq_tpu_torch.core.config import Config, get_config
from llmq_tpu_torch.core.faults import DeviceFaultError
from llmq_tpu_torch.core.models import Job, Result, WorkerHealth, utcnow
from llmq_tpu_torch.core.pipeline import PipelineConfig
from llmq_tpu_torch.obs.exporter import maybe_start_exporter
from llmq_tpu_torch.obs.metrics import get_registry
from llmq_tpu_torch.obs.trace import (
    TRACE_FIELD,
    emit_trace_event,
    new_trace,
    record_transition,
    trace_event,
    trace_from_payload,
)
from llmq_tpu_torch.utils import clock
from llmq_tpu_torch.utils.host_mem import get_governor
from llmq_tpu_torch.workers.resume import (
    RESUME_FIELD,
    JobHandoff,
    PrefillDone,
    ResultDeduper,
    resume_offset,
)

#: Valid LLMQ_WORKER_ROLE values. "unified" is the monolith default;
#: "auto" workers start as prefill and switch on fleet queue depths.
WORKER_ROLES = ("unified", "prefill", "decode", "auto")

HEALTH_TTL_MS = 120_000

__all__ = ["BaseWorker", "DeadlineExceeded", "HEALTH_TTL_MS", "HEARTBEAT_INTERVAL_S",
           "WORKER_ROLES", "worker_role"]

# Worker-local memory of why recent jobs failed (job_id -> reason), bounded:
# feeds the x-failure-reason header when a job quarantines on this worker.
_FAILURE_MEMORY_CAP = 1024


class DeadlineExceeded(Exception):
    """A job's deadline passed while it was in flight. The message loop
    dead-letters it as ``deadline_exceeded`` instead of publishing a
    result or requeueing."""


def worker_role(cfg: Config) -> str:
    """The configured role, checked as the reference's ``BaseWorker``
    checks it."""
    role = (cfg.worker_role or "unified").lower()
    if role not in WORKER_ROLES:
        raise ValueError(f"LLMQ_WORKER_ROLE must be one of {WORKER_ROLES}, got {role!r}")
    return role


class BaseWorker(abc.ABC):
    def __init__(
        self,
        queue: str,
        *,
        config: Optional[Config] = None,
        concurrency: Optional[int] = None,
        pipeline: Optional[PipelineConfig] = None,
        stage_name: Optional[str] = None,
        broker_url: Optional[str] = None,
    ) -> None:
        self.queue = queue
        self.config = config or get_config()
        # The configured role, and the one served now (they differ only for
        # "auto", whose controller flips role_active on fleet queue depths).
        self.role = worker_role(self.config)
        self.role_active = "prefill" if self.role == "auto" else self.role
        self.role_switches = 0
        self._role_since = clock.monotonic()
        self._role_checked_at = float("-inf")
        self.concurrency = concurrency or self.config.queue_prefetch
        self.pipeline = pipeline
        self.stage_name = stage_name
        self.worker_id = self._generate_worker_id()
        self.logger = logging.LoggerAdapter(
            logging.getLogger(f"worker.{self.worker_id}"), {"worker_id": self.worker_id})
        self.broker = BrokerManager(self.config, url=broker_url)
        self.running = False
        self._wake = asyncio.Event()  # set by request_shutdown: the run loop exits at once
        self.jobs_processed = 0
        self.jobs_failed = 0
        self.jobs_timed_out = 0
        self.total_duration_ms = 0.0
        self._consumer_tags: List[str] = []  # the role's consumers (swapped on a switch)
        self._extra_tags: List[str] = []  # the processor's, e.g. the KV-fetch server
        self._in_flight = 0
        self._drained = asyncio.Event()
        self._drained.set()
        # Live request traces by job id, so the processor can attach its
        # engine's lifecycle events to the record the result carries.
        self._job_traces: dict = {}
        # Exactly-one-result guard: (job_id, resume offset) pairs this
        # worker already published for.
        self._dedup = ResultDeduper()
        # Fleet self-healing state: per-job failure reasons (bounded FIFO
        # in insertion order), consecutive engine failures for the
        # circuit breaker, and robustness counters surfaced in heartbeats.
        self._failure_reasons: dict = {}
        self._consecutive_failures = 0
        self.jobs_deadline_exceeded = 0
        self.jobs_deadline_exceeded_interactive = 0
        self.jobs_quarantined = 0
        self.breaker_tripped = False
        self.jobs_handed_off = 0  # drain-time resume republishes (the port's counter)
        self.handoffs_shipped = 0  # KV adoptions a decode peer accepted
        self.handoffs_fallback = 0  # snapshot republishes to <q>.decode
        self.handoff_bytes = 0  # the bytes of both kinds of payload (the port's counter)
        self.jobs_adopted = 0  # handoffs this worker resumed as decoder
        # Handoff publish -> adoption latency samples (ms), bounded ring.
        self._handoff_ms: deque = deque(maxlen=512)

    # --- abstract surface -------------------------------------------------
    @abc.abstractmethod
    def _generate_worker_id(self) -> str: ...

    @abc.abstractmethod
    async def _initialize_processor(self) -> None: ...

    @abc.abstractmethod
    async def _process_job(self, job: Job) -> Any: ...

    @abc.abstractmethod
    async def _cleanup_processor(self) -> None: ...

    # --- lifecycle --------------------------------------------------------
    async def initialize(self) -> None:
        self.logger.info("Initializing worker %s", self.worker_id)
        # Opt-in Prometheus endpoint (LLMQ_METRICS_PORT) over the
        # process-wide registry the engine, scheduler and broker record into.
        maybe_start_exporter()
        await self._initialize_processor()
        await self.broker.connect()
        if self.pipeline is not None:
            await self.broker.setup_pipeline_infrastructure(self.pipeline)
        else:
            await self.broker.setup_queue_infrastructure(self.queue)
        # Heartbeats expire via TTL; the huge redelivery cap keeps repeated
        # non-destructive health peeks from ever dead-lettering them.
        await self.broker.broker.declare_queue(
            self.queue + HEALTH_SUFFIX, ttl_ms=HEALTH_TTL_MS, max_redeliveries=1_000_000_000)
        if self.config.prefix_affinity:
            # The private queue the submit path routes to: the shared
            # queue's TTL and cap, so a job stranded by this worker's death
            # expires or dead-letters instead of waiting forever.
            await self.broker.broker.declare_queue(
                affinity_queue_name(self.queue, self.worker_id),
                ttl_ms=self.config.job_ttl_ms, max_redeliveries=self.config.max_redeliveries)

    async def run(self) -> None:
        """Main entry: initialize, consume until stopped, then clean up."""
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self.request_shutdown)
            except (NotImplementedError, RuntimeError):
                pass  # non-main thread or platform without signal support
        # Fresh events on this run's loop.
        self._wake = asyncio.Event()
        self._drained = asyncio.Event()
        if self._in_flight <= 0:
            self._drained.set()
        try:
            await self.initialize()
            self.running = True
            await self._start_role_consumers()
            await self._start_extra_consumers()
            self.logger.info("Worker %s consuming %s (prefetch=%d, role=%s)", self.worker_id,
                             ", ".join(self._role_queues()), self.concurrency,
                             self.role_active)
            # Monotonic clock for the beat cadence: wall time steps must
            # not skip or double beats.
            last_beat = clock.monotonic() - HEARTBEAT_INTERVAL_S
            while self.running:
                now = clock.monotonic()
                if now - last_beat >= HEARTBEAT_INTERVAL_S:
                    # Heartbeats pause during a broker outage (publishing
                    # them would park stale liveness claims in the outbox)
                    # and resume right after reconnect.
                    if self.broker.transport_connected:
                        await self._publish_heartbeat()
                        last_beat = now
                await self._maybe_switch_role()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
        finally:
            await self.shutdown()

    def request_shutdown(self) -> None:
        if self.running:
            self.logger.info("Shutdown requested; draining in-flight jobs")
        self.running = False
        self._wake.set()

    async def shutdown(self) -> None:
        await self._stop_role_consumers()
        await self._cancel_tags(self._extra_tags)
        self._extra_tags = []
        # Drain-with-handoff: the processor hands unfinished requests back;
        # in-flight _process_message coroutines then settle their messages
        # as resumable republishes instead of waiting out generations.
        try:
            await self._handoff_in_flight()
        except Exception:  # noqa: BLE001 — fall back to the plain drain
            self.logger.warning("In-flight handoff failed", exc_info=True)
        try:
            await asyncio.wait_for(self._drained.wait(), timeout=self.config.drain_timeout_s)
        except asyncio.TimeoutError:
            self.logger.warning("Timed out draining %d in-flight jobs", self._in_flight)
        if (self.config.prefix_affinity or self.role != "unified") and self.broker.connected:
            # The graceful half of the orphan reclaim: what this worker's
            # private queues still hold goes back to the shared ones, and
            # the queues go (the janitor covers a crashed worker).
            try:
                moved = await self.broker.reclaim_worker_queues(self.queue, self.worker_id)
                if moved:
                    self.logger.info("Returned %d unclaimed jobs to the shared queues", moved)
            except Exception:  # noqa: BLE001 — the janitor reclaims what is left
                self.logger.warning("Private queue retirement incomplete", exc_info=True)
        await self._cleanup_processor()
        if self.broker.connected:
            await self.broker.disconnect()
        self.logger.info("Worker %s stopped (processed=%d failed=%d)", self.worker_id,
                         self.jobs_processed, self.jobs_failed)

    async def _handoff_in_flight(self) -> None:
        """Hook: hand in-flight requests back to the broker as resumable
        jobs during shutdown. Base workers have no partial state worth
        carrying."""
        return None

    # --- roles ------------------------------------------------------------
    def _role_queues(self) -> List[str]:
        """The shared queues the role serves: a decode worker the decode
        pool, the others the shared queue, after the fast lane when the
        priority classes are on (interactive deliveries race the shared
        queue's prefetch, and the engine's admission orders what lands)."""
        if self.role_active == "decode":
            return [decode_queue_name(self.queue)]
        lane = [interactive_queue_name(self.queue)] if self.config.priority_classes else []
        return lane + [self.queue]

    async def _start_role_consumers(self) -> None:
        """Attach the job consumers of the role served now: its shared
        queues, and its private one. A decode worker declares the decode
        pool and its adoption queue ``<q>.d.<id>`` (accepted KV handoffs
        are parked there before the offer is answered) with the job TTL and
        cap; a worker with prefix affinity consumes ``<q>.w.<id>``. An
        ``auto`` worker holds one of the two sets at a time."""
        consumers = [(name, self._process_message) for name in self._role_queues()]
        if self.role_active == "decode":
            adopt = decode_adopt_queue_name(self.queue, self.worker_id)
            for name in (decode_queue_name(self.queue), adopt):
                await self.broker.broker.declare_queue(
                    name, ttl_ms=self.config.job_ttl_ms,
                    max_redeliveries=self.config.max_redeliveries)
            consumers.append((adopt, self._process_message))
        elif self.config.prefix_affinity:
            consumers.append((affinity_queue_name(self.queue, self.worker_id),
                              self._process_affinity_message))
        for name, handler in consumers:
            self._consumer_tags.append(await self.broker.consume_jobs(
                name, handler, prefetch=self.concurrency))

    async def _stop_role_consumers(self) -> None:
        tags, self._consumer_tags = self._consumer_tags, []
        await self._cancel_tags(tags)

    async def _cancel_tags(self, tags: List[str]) -> None:
        for tag in tags:
            if not self.broker.connected:
                break
            try:
                # requeue=False: in-flight deliveries finish under the
                # normal settle paths (or republish as resume snapshots);
                # requeueing them here would double-deliver.
                await self.broker.cancel(tag, requeue=False)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    async def _maybe_switch_role(self) -> None:
        """The ``auto`` role's controller: compare the shared queue's depth
        (prefill demand) with the decode pool's and flip the role when
        (shared + 1) / (decode + 1) leaves the band ``[role_switch_lo,
        role_switch_hi]``. A check cadence (``role_check_interval_s``) and a
        least dwell in a role (``role_dwell_s``) keep it from flapping."""
        if self.role != "auto" or not self.running:
            return
        now = clock.monotonic()
        if now - self._role_checked_at < self.config.role_check_interval_s:
            return
        self._role_checked_at = now
        if now - self._role_since < self.config.role_dwell_s:
            return
        try:
            shared = await self.broker.get_queue_stats(self.queue)
            decode = await self.broker.get_queue_stats(decode_queue_name(self.queue))
        except Exception:  # noqa: BLE001 — no stats, no switch
            return
        dp, dd = shared.message_count_ready, decode.message_count_ready
        if dp is None or dd is None:
            return
        # +1 keeps the ratio finite and an all-empty fleet (1.0) in the band.
        ratio = (dp + 1.0) / (dd + 1.0)
        target = None
        if self.role_active == "prefill" and ratio < self.config.role_switch_lo:
            target = "decode"
        elif self.role_active == "decode" and ratio > self.config.role_switch_hi:
            target = "prefill"
        if target is not None:
            await self._switch_role(target, ratio=ratio)

    async def _switch_role(self, target: str, *, ratio: float = 0.0) -> None:
        prev = self.role_active
        await self._stop_role_consumers()
        self.role_active = target
        self.role_switches += 1
        self._role_since = clock.monotonic()
        emit_trace_event(self.worker_id, "role_switch", worker_id=self.worker_id,
                         role_from=prev, role_to=target, depth_ratio=round(ratio, 3))
        self.logger.info("Role switch %s -> %s (shared:decode depth ratio %.2f)", prev, target,
                         ratio)
        await self._start_role_consumers()

    async def _start_extra_consumers(self) -> None:
        """Hook: attach the processor's own consumers once the job
        consumers are live (the ``TorchWorker``'s KV-fetch server); their
        tags go on ``_extra_tags``. Base workers have none."""
        return None

    async def _process_affinity_message(self, message: DeliveredMessage) -> None:
        """A job from this worker's private ``<q>.w.<id>``. Claimed while the
        worker drains (a submitter's cached fleet view lags a shutdown by
        up to ``AFFINITY_REFRESH_S``), it bounces straight back to the
        shared queue instead of waiting for the janitor."""
        if not self.running:
            try:
                await self.broker.broker.publish(self.queue, message.body,
                                                 message_id=message.message_id,
                                                 headers=message.headers)
                emit_trace_event(message.message_id or "unknown", "affinity_bounced",
                                 worker_id=self.worker_id)
                await message.ack()
            except Exception:  # noqa: BLE001 — transport down: redeliver
                await message.reject(requeue=True)
            return
        await self._process_message(message)

    # --- failure memory, guards, quarantine, breaker -----------------------
    def _remember_failure(self, job_id: str, reason: str) -> None:
        self._failure_reasons[job_id] = reason
        while len(self._failure_reasons) > _FAILURE_MEMORY_CAP:
            self._failure_reasons.pop(next(iter(self._failure_reasons)))

    def _deadline_expired(self, job: Job) -> bool:
        return job.deadline_at is not None and clock.wall() > job.deadline_at

    async def _dead_letter_deadline(self, job: Job, message: DeliveredMessage,
                                    trace: dict) -> None:
        """File a job whose deadline passed on ``<q>.failed`` as
        ``deadline_exceeded`` — never silently dropped."""
        self.jobs_deadline_exceeded += 1
        if job.priority_class == "interactive":
            self.jobs_deadline_exceeded_interactive += 1
        record_transition(trace, job.id, "deadline_exceeded", worker_id=self.worker_id)
        headers = dict(message.headers or {})
        headers["x-error"] = "deadline_exceeded"
        headers["x-failure-reason"] = "deadline_exceeded"
        headers["x-worker-id"] = self.worker_id
        headers["x-delivery-count"] = message.delivery_count
        headers.setdefault("x-death-queue", self.queue)
        try:
            await self.broker.broker.publish(self.queue + FAILED_SUFFIX, message.body,
                                             message_id=message.message_id, headers=headers)
        except Exception:  # noqa: BLE001 — best-effort: never block the loop
            self.logger.warning("Deadline dead-letter failed", exc_info=True)
        finally:
            await message.ack()

    async def _quarantine(self, job: Job, message: DeliveredMessage, trace: dict, *,
                          reason: str) -> None:
        """File a poison job on ``<q>.quarantine``: it failed
        ``quarantine_attempts`` times fleet-wide (the broker's delivery
        count rides the message, so it counts every worker's attempts)."""
        self.jobs_quarantined += 1
        record_transition(trace, job.id, "quarantined", worker_id=self.worker_id, reason=reason,
                          on_trace=dict(attempts=message.delivery_count + 1))
        headers = dict(message.headers or {})
        headers["x-error"] = f"quarantined after repeated failures: {reason}"
        headers["x-failure-reason"] = reason
        headers["x-worker-id"] = self.worker_id
        headers["x-delivery-count"] = message.delivery_count + 1
        headers.setdefault("x-death-queue", self.queue)
        try:
            await self.broker.broker.publish(self.queue + QUARANTINE_SUFFIX, message.body,
                                             message_id=message.message_id, headers=headers)
            await message.ack()
        except Exception:  # noqa: BLE001 — transport down: keep at-least-once
            await message.reject(requeue=True)

    def _note_engine_failure(self, reason: str) -> None:
        """Circuit breaker: ``breaker_failures`` consecutive failures mean
        this worker is the problem. Self-drain via the handoff path so its
        jobs move to healthy peers."""
        self._consecutive_failures += 1
        m = self.config.breaker_failures
        if m > 0 and self._consecutive_failures >= m and not self.breaker_tripped:
            self.breaker_tripped = True
            self.logger.error("Circuit breaker: %d consecutive engine failures (last: %s); "
                              "self-draining", self._consecutive_failures, reason)
            emit_trace_event(self.worker_id, "breaker_tripped", worker_id=self.worker_id,
                             failures=self._consecutive_failures)
            self.request_shutdown()

    async def _after_failure(self, exc: BaseException) -> None:
        """Hook (the port's): called on a processing failure (a device fault
        or a generic one) before the job settles. The ``TorchWorker`` stops
        here once its engine could not contain a device fault."""
        return None

    # --- the hot loop -----------------------------------------------------
    async def _process_message(self, message: DeliveredMessage) -> None:
        self._in_flight += 1
        self._drained.clear()
        start = clock.monotonic()
        try:
            job = Job.model_validate_json(message.body)
        except Exception as exc:  # malformed payload: dead-letter, never requeue
            self.logger.error("Unparseable job dead-lettered: %s", exc)
            self.jobs_failed += 1
            await self._dead_letter_unparseable(message, exc)
            self._settle_in_flight()
            return
        # Lifecycle trace: continue the submit-time record riding in the
        # payload (or start one). A redelivery re-reads the ORIGINAL
        # payload, so a failed attempt's events never repeat; the attempt
        # count survives as the delivery count (0 on the first delivery).
        trace = trace_from_payload(job.extras()) or new_trace(job.id)
        trace["redeliveries"] = message.delivery_count
        record_transition(trace, job.id, "claimed", worker_id=self.worker_id,
                          on_trace=dict(delivery_count=message.delivery_count))
        self._job_traces[job.id] = trace
        # Claim-time self-healing guards (no-ops at default config):
        if self._deadline_expired(job):
            await self._dead_letter_deadline(job, message, trace)
            self._job_traces.pop(job.id, None)
            self._settle_in_flight()
            return
        n_quarantine = self.config.quarantine_attempts
        if n_quarantine > 0 and message.delivery_count >= n_quarantine:
            # Backstop for the reject-time check below: catches a copy
            # whose Nth failure landed on a worker that died mid-settle.
            await self._quarantine(
                job, message, trace,
                reason=self._failure_reasons.get(job.id, "repeated_failures"))
            self._job_traces.pop(job.id, None)
            self._settle_in_flight()
            return
        if self.role_active == "prefill" and isinstance(job.extras().get(RESUME_FIELD), dict):
            # Resume state means the prompt KV exists already: on to the
            # decode pool untouched, not prefilled again.
            await self._forward_to_decode(job, message)
            self._job_traces.pop(job.id, None)
            self._settle_in_flight()
            return
        try:
            output = await self._run_with_timeout(job)
            duration_ms = (clock.monotonic() - start) * 1000
            record_transition(trace, job.id, "finished", duration_ms=round(duration_ms, 3),
                              on_sink=dict(worker_id=self.worker_id))
            result = self._build_result(job, output, duration_ms, trace=trace)
            offset = resume_offset(job.extras())
            if self._dedup.seen(job.id, offset):
                # Redelivered after a successful publish: the result is
                # already out. Settle silently.
                self.logger.info("Suppressing duplicate result for job %s (offset %d)",
                                 job.id, offset)
                emit_trace_event(job.id, "duplicate_suppressed", worker_id=self.worker_id)
            else:
                await self._publish_result(result)
                self._dedup.record(job.id, offset)
            await message.ack()
            self.jobs_processed += 1
            self._consecutive_failures = 0
            self.total_duration_ms += duration_ms
            if self.jobs_processed % 100 == 0:
                self.logger.info("Processed %d jobs (avg %.0f ms)", self.jobs_processed,
                                 self.total_duration_ms / self.jobs_processed)
        except DeadlineExceeded:
            await self._dead_letter_deadline(job, message, trace)
        except PrefillDone as exc:
            # The prefill boundary: forward progress, not a failure.
            await self._handoff_to_decode(job, message, trace, exc)
        except JobHandoff as exc:
            # Drain-with-handoff: the request resolved with a snapshot.
            await self._republish_for_resume(job, message, trace, exc)
        except (asyncio.TimeoutError, TimeoutError):
            # Hung engine step / stuck backend: the slot must come back.
            self.logger.warning("Job %s exceeded job_timeout_s=%.1fs (delivery %d), requeueing",
                                job.id, self.config.job_timeout_s or 0.0,
                                message.delivery_count)
            self.jobs_failed += 1
            self.jobs_timed_out += 1
            self._remember_failure(job.id, "timeout")
            self._note_engine_failure("timeout")
            if await self._maybe_quarantine(job, message, trace, reason="timeout"):
                return
            emit_trace_event(job.id, "requeued", worker_id=self.worker_id, reason="timeout")
            self._note_retry_exhausted(job, message.delivery_count, trace, reason="timeout")
            await message.reject(requeue=True)
        except ValueError as exc:
            # Semantically invalid job: retrying can't fix it. Ack & drop.
            self.logger.error("Job %s invalid, dropping: %s", job.id, exc)
            self.jobs_failed += 1
            emit_trace_event(job.id, "dropped", worker_id=self.worker_id, reason=str(exc))
            await message.ack()
        except DeviceFaultError as exc:
            # A classified device fault the engine could not absorb, or a
            # poison job: the generic ladder, with the machine-readable
            # class in the breaker and the headers, so `errors` tells a
            # wedged chip from a bad job.
            self.logger.warning("Job %s hit device fault %s (delivery %d), requeueing: %s",
                                job.id, exc.failure_reason, message.delivery_count, exc)
            self.jobs_failed += 1
            reason = exc.failure_reason
            self._remember_failure(job.id, reason)
            self._note_engine_failure(reason)
            await self._after_failure(exc)
            if await self._maybe_quarantine(job, message, trace, reason=reason):
                return
            emit_trace_event(job.id, "requeued", worker_id=self.worker_id, reason=reason)
            self._note_retry_exhausted(job, message.delivery_count, trace, reason=reason)
            await message.reject(requeue=True)
        except Exception as exc:  # noqa: BLE001 — transient: requeue
            self.logger.warning("Job %s failed (delivery %d), requeueing: %s", job.id,
                                message.delivery_count, exc)
            self.jobs_failed += 1
            reason = f"engine_error:{type(exc).__name__}"
            self._remember_failure(job.id, reason)
            self._note_engine_failure(reason)
            await self._after_failure(exc)
            if await self._maybe_quarantine(job, message, trace, reason=reason):
                return
            emit_trace_event(job.id, "requeued", worker_id=self.worker_id, reason=str(exc))
            self._note_retry_exhausted(job, message.delivery_count, trace, reason=str(exc))
            await message.reject(requeue=True)
        finally:
            self._job_traces.pop(job.id, None)
            self._settle_in_flight()

    async def _maybe_quarantine(self, job: Job, message: DeliveredMessage, trace: dict, *,
                                reason: str) -> bool:
        """Reject-time quarantine check: this failure is attempt
        ``delivery_count + 1``; at the Nth fleet-wide attempt the job
        quarantines instead of requeueing. True when settled here."""
        n = self.config.quarantine_attempts
        if n > 0 and message.delivery_count + 1 >= n:
            await self._quarantine(job, message, trace, reason=reason)
            return True
        return False

    def _note_retry_exhausted(self, job: Job, delivery_count: int, trace: dict, *,
                              reason: str) -> None:
        """Flag a requeue that the broker will dead-letter (this attempt
        pushed the job past the redelivery cap). The record itself never
        ships on a requeue (a redelivery re-reads the original payload), so
        the ``trace`` command recovers this moment from the dead letter's
        headers; the event here feeds the live sink."""
        if delivery_count + 1 > self.config.max_redeliveries:
            record_transition(trace, job.id, "retry_exhausted", worker_id=self.worker_id,
                              redeliveries=delivery_count, on_trace=dict(reason=reason))

    # --- handoffs -----------------------------------------------------------
    async def _republish_for_resume(self, job: Job, message: DeliveredMessage, trace: dict,
                                    exc: JobHandoff) -> None:
        """Publish a draining request back to the job queue with its
        engine snapshot under ``RESUME_FIELD``, then ack the original
        delivery: until the ack lands the original survives, and the
        deduper suppresses a double publish. A snapshot-less handoff (the
        request never entered the engine) requeues the original. The
        republished copy carries the accumulated trace, so the resuming
        worker's record keeps the whole lifecycle (submitted, claimed,
        handoff, claimed, finished)."""
        if exc.snapshot_b64 is None:
            emit_trace_event(job.id, "requeued", worker_id=self.worker_id, reason="shutdown")
            await message.reject(requeue=True)
            return
        try:
            payload = json.loads(message.body)
        except Exception:  # noqa: BLE001 — parsed once already; paranoia
            await message.reject(requeue=True)
            return
        record_transition(trace, job.id, "handoff", worker_id=self.worker_id, emitted=exc.emitted)
        payload[RESUME_FIELD] = {"snapshot": exc.snapshot_b64, "offset": exc.emitted}
        payload[TRACE_FIELD] = trace
        try:
            body = json.dumps(payload).encode("utf-8")
            # Resume blobs share the host-memory budget: accounted, never
            # refused (a refusal would strand a request mid-drain).
            get_governor().note_resume_blob(len(body))
            await self.broker.broker.publish(self._resume_queue(), body, message_id=job.id)
        except Exception:  # noqa: BLE001 — transport down mid-shutdown
            self.logger.warning("Resume republish failed for job %s; requeueing plain", job.id,
                                exc_info=True)
            await message.reject(requeue=True)
            return
        self.jobs_handed_off += 1
        self.logger.info("Job %s handed off with %d tokens generated", job.id, exc.emitted)
        await message.ack()

    def _resume_queue(self) -> str:
        """Where resumable handoffs republish: a decode worker keeps
        KV-complete work inside the decode pool, the others use the shared
        queue."""
        if self.role_active == "decode":
            return decode_queue_name(self.queue)
        return self.queue

    async def _forward_to_decode(self, job: Job, message: DeliveredMessage) -> None:
        """Move a resume-carrying job off a prefill worker onto the decode
        pool, payload untouched (its trace and snapshot ride along)."""
        try:
            await self.broker.broker.publish(decode_queue_name(self.queue), message.body,
                                             message_id=message.message_id,
                                             headers=message.headers)
            emit_trace_event(job.id, "kv_handoff", worker_id=self.worker_id, path="forward")
            await message.ack()
        except Exception:  # noqa: BLE001 — transport down: redeliver
            await message.reject(requeue=True)

    async def _handoff_to_decode(self, job: Job, message: DeliveredMessage, trace: dict,
                                 exc: PrefillDone) -> None:
        """Settle a prefill-complete job into the decode pool. The prompt-KV
        snapshot rides under ``RESUME_FIELD`` (offset 0) with a wall-clock
        ``handoff_at`` stamp. First a decode peer is asked to adopt it
        (:meth:`_ship_to_decode_peer`); when none takes it, it is
        republished on ``<q>.decode``. Either way the publish lands before
        the ack, so a crash between the two leaves the original to
        redeliver and the deduper collapses the double. The boundary's
        ``kv_handoff`` event rides inside the payload (the adopter's result
        trace is built from it): stamped ``path="ship"``, rewritten to
        ``"snapshot"`` when the job takes ``<q>.decode``."""
        try:
            payload = json.loads(message.body)
        except Exception:  # noqa: BLE001 — parsed once already; paranoia
            await message.reject(requeue=True)
            return
        record_transition(trace, job.id, "prefill_done", worker_id=self.worker_id)
        payload[RESUME_FIELD] = {"snapshot": exc.snapshot_b64, "offset": 0,
                                 "handoff_at": clock.wall()}
        trace_event(trace, "kv_handoff", worker_id=self.worker_id, path="ship")
        payload[TRACE_FIELD] = trace
        body = json.dumps(payload).encode("utf-8")
        get_governor().note_resume_blob(len(body))
        shipped = False
        try:
            shipped = await self._ship_to_decode_peer(job, body)
        except Exception:  # noqa: BLE001 — the offer failed: take the fallback
            self.logger.debug("Decode adoption offer failed", exc_info=True)
        if shipped:
            self.handoffs_shipped += 1
            self.handoff_bytes += len(body)
            emit_trace_event(job.id, "kv_handoff", worker_id=self.worker_id, path="ship")
            await message.ack()
            return
        trace["events"][-1]["path"] = "snapshot"
        body = json.dumps(payload).encode("utf-8")
        try:
            await self.broker.broker.publish(decode_queue_name(self.queue), body,
                                             message_id=job.id)
        except Exception:  # noqa: BLE001 — transport down
            self.logger.warning("Decode-pool republish failed for job %s; requeueing plain",
                                job.id, exc_info=True)
            await message.reject(requeue=True)
            return
        self.handoffs_fallback += 1
        self.handoff_bytes += len(body)
        emit_trace_event(job.id, "kv_handoff", worker_id=self.worker_id, path="snapshot")
        await message.ack()

    async def _ship_to_decode_peer(self, job: Job, body: bytes) -> bool:
        """Hook: offer a prefill-complete payload to a decode peer for
        direct adoption; True only once a peer durably holds it. Base
        workers find no peer: the snapshot fallback covers them."""
        return False

    # --- processing helpers ------------------------------------------------
    async def _run_with_timeout(self, job: Job) -> Any:
        timeout = self.config.job_timeout_s
        if timeout is None or timeout <= 0:
            return await self._process_job(job)
        return await asyncio.wait_for(self._process_job(job), timeout=timeout)

    async def _dead_letter_unparseable(self, message: DeliveredMessage, exc: Exception) -> None:
        """Corrupt payloads never parse into a Job, but they must not
        vanish: file them in ``<queue>.failed``. Settles the message on
        every path (reject without requeue: the copy lives in the DLQ)."""
        headers = dict(message.headers or {})
        headers["x-error"] = f"unparseable job payload: {exc}"
        headers["x-worker-id"] = self.worker_id
        headers.setdefault("x-death-queue", self.queue)
        emit_trace_event(message.message_id or "unparseable", "dead_lettered",
                         worker_id=self.worker_id, reason=str(exc))
        try:
            await self.broker.broker.publish(self.queue + FAILED_SUFFIX, message.body,
                                             message_id=message.message_id, headers=headers)
        except Exception:  # noqa: BLE001 — best-effort: never block the loop
            self.logger.warning("Could not dead-letter unparseable payload", exc_info=True)
        finally:
            await message.reject(requeue=False)

    def _settle_in_flight(self) -> None:
        self._in_flight -= 1
        if self._in_flight <= 0:
            self._drained.set()

    def _build_result(self, job: Job, output: Any, duration_ms: float,
                      trace: Optional[dict] = None) -> Result:
        """Result with extra-field passthrough, built dict-first so a job
        extra named like a Result field is kept as ``job_<name>``. The
        accumulated trace (submit-time events and this worker's) replaces
        the job's copy."""
        prompt_repr = job.get_formatted_prompt() if job.prompt is not None else ""
        payload = dict(job.extras())
        # The spent resume blob stays out of the result; its offset stays.
        resume = payload.pop(RESUME_FIELD, None)
        if isinstance(resume, dict):
            payload["resume_offset"] = resume_offset({RESUME_FIELD: resume})
        reserved = {
            "id": job.id,
            "prompt": prompt_repr,
            "result": output,
            "worker_id": self.worker_id,
            "duration_ms": duration_ms,
        }
        for key in (*reserved, "timestamp", "usage"):
            if key in payload:
                payload[f"job_{key}"] = payload.pop(key)
        payload.update(reserved)
        if trace is not None:
            payload[TRACE_FIELD] = trace
        return Result.model_validate(payload)

    async def _publish_result(self, result: Result) -> None:
        if self.pipeline is not None and self.stage_name is not None:
            await self.broker.publish_pipeline_result(self.pipeline, self.stage_name, result)
        else:
            await self.broker.publish_result(self.queue, result)

    # --- heartbeats -------------------------------------------------------
    async def _publish_heartbeat(self) -> None:
        stats = self.broker.session_stats
        try:
            # Inside the guard, unlike the reference: the engine's stats are
            # read from this thread while the engine thread steps, and a
            # heartbeat that cannot be built must not end the run loop.
            health = WorkerHealth(
                worker_id=self.worker_id,
                status="running" if self.running else "stopping",
                last_seen=utcnow(),
                jobs_processed=self.jobs_processed,
                avg_duration_ms=(self.total_duration_ms / self.jobs_processed
                                 if self.jobs_processed else None),
                queue=self.queue,
                engine_stats=self._stats_with_robustness(),
                reconnects=stats.reconnects if stats is not None else None,
                metrics=get_registry().summary() or None,
                prefix_chains=self._prefix_chains(),
                last_dispatch_ok_age_s=self._dispatch_ok_age(),
                integrity=self._integrity_status(),
                role=None if self.role == "unified" else self.role_active,
            )
            # Fields whose machinery is off are excluded (not null).
            unset = {name for name in ("last_dispatch_ok_age_s", "integrity", "role")
                     if getattr(health, name) is None}
            await self.broker.broker.publish(
                self.queue + HEALTH_SUFFIX,
                health.model_dump_json(exclude=unset or None).encode("utf-8"))
        except Exception:  # noqa: BLE001 — heartbeats are best-effort
            self.logger.debug("Heartbeat publish failed", exc_info=True)

    def _engine_stats(self) -> Optional[dict]:
        """Subclasses may surface engine metrics (batch occupancy etc.)."""
        return None

    def _dispatch_ok_age(self) -> Optional[float]:
        """Seconds since the engine's last clean device call, or None (the
        field omitted) when no watchdog runs."""
        return None

    def _integrity_status(self) -> Optional[str]:
        """The engine's integrity verdict ('ok' / 'suspect'), or None (the
        field omitted) when every integrity knob is off."""
        return None

    def _stats_with_robustness(self) -> Optional[dict]:
        """Engine stats plus the self-healing and handoff counters, each
        only once it moved."""
        stats = dict(self._engine_stats() or {})
        for name in ("jobs_deadline_exceeded", "jobs_deadline_exceeded_interactive",
                     "jobs_quarantined"):
            value = getattr(self, name, 0)
            if value:
                stats[name] = value
        if self.breaker_tripped:
            stats["breaker_tripped"] = True
        if self.role == "auto":
            stats["role_mode"] = "auto"
        for name in ("role_switches", "handoffs_shipped", "handoffs_fallback", "jobs_adopted"):
            value = getattr(self, name, 0)
            if value:
                stats[name] = value
        stats.update(self._handoff_percentiles())
        return stats or None

    def _prefix_chains(self) -> Optional[list]:
        """Hook: the hot prefix-chain digests (hex) advertised for
        prefix-affinity routing; None omits the field."""
        return None

    def _handoff_percentiles(self) -> dict:
        """p50 / p95 of the handoff latency samples (ms), once there are some."""
        if not self._handoff_ms:
            return {}
        vals = sorted(self._handoff_ms)
        return {"handoff_ms_p50": round(vals[len(vals) // 2], 3),
                "handoff_ms_p95": round(vals[min(len(vals) - 1, int(len(vals) * 0.95))], 3)}
