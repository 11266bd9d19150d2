"""The inference worker of the port: queue in, engine, results out.

Port of the job path of ``llmq_tpu/workers/base.py`` (``_process_message``
:633, ``_build_result`` :1105, ``_publish_result`` :1145) and
``llmq_tpu/workers/tpu_worker.py`` (``_sampling_for`` :1137,
``_process_job`` :1186, ``_build_result`` :1389):

- consume ``<queue>`` with prefetch = ``concurrency``;
- parse the ``Job``; build its ``SamplingParams`` from the extras, the
  job's ``stop`` and its structured ``sampling`` object;
- generate through the ``AsyncEngine``;
- publish a ``Result`` (usage counts, the job's extra fields passed
  through, colliding names kept as ``job_<name>``; with
  ``LLMQ_RESULT_DIGEST`` on, the emitted token ids and their
  ``token_digest``, as ``tpu_worker.py:1399``) to ``<queue>.results``,
  then ack.

The broker URL, the prefetch, the default ``max_tokens`` and the drain
timeout come from ``core/config.py`` unless given, as ``BaseWorker`` /
``TPUWorker`` take them (``base.py:112-113``, ``tpu_worker.py:177-179``).

Shutdown is the reference's drain-with-handoff (``base.py:262-316``,
``tpu_worker.py:506-520``): SIGINT, SIGTERM or :meth:`request_shutdown`
cancels the consumer without requeue and calls ``engine.handoff()``,
which resolves every request still in the engine with its snapshot. Such
a job is republished to the queue carrying the snapshot (base64 wire
form) and its offset under ``RESUME_FIELD``, then acked (``base.py:
878-930``); a job that never reached the engine is rejected with requeue.
The worker then waits up to ``drain_timeout_s`` for its jobs to settle
and :meth:`run` returns. A job that carries a resume snapshot continues
through ``engine.resume`` from the token where it stopped
(``tpu_worker.py:1161-1262``); a snapshot that cannot be decoded or
inserted (another model signature or KV dtype) re-runs the job from its
prompt, as the reference does. Results are published once per ``(job id,
resume offset)`` (``workers/resume.py``). A job's ``deadline_at`` and
``priority`` reach the engine; a deadline that lapsed before the engine
saw the job, or that the engine's sweep enforced, dead-letters the job to
``<queue>.failed`` as ``deadline_exceeded``.

Roles (``LLMQ_WORKER_ROLE``, ``Config.worker_role``; ``base.py:75-77``,
:152-162, :378-417, :956-1057, ``tpu_worker.py:1228-1332``). A ``unified``
worker (the default) serves ``<queue>`` and, with ``priority_classes`` on
(the default), the ``<queue>.interactive`` fast lane. A ``prefill``
worker serves ``<queue>``, generates with ``prefill_only=True`` and hands
each job, at its prefill boundary, to the decode pool: the job is
republished to ``<queue>.decode`` with its prompt-KV snapshot under
``RESUME_FIELD`` (offset 0, a ``handoff_at`` stamp) before the delivery
is acked (``handoffs_fallback`` counts them); a job that already carries
resume state is forwarded there untouched. A ``decode`` worker serves
``<queue>.decode`` and resumes each job through ``engine.resume``; a
``handoff_at`` stamp counts it in ``jobs_adopted`` and samples the
handoff latency. A draining decode worker republishes to ``<queue>.decode``.
The reference's direct adoption offer to a chosen decode peer
(``_ship_to_decode_peer``) needs the heartbeats to find one, so here, as
in a reference fleet with no live decode peer, every handoff takes the
``<queue>.decode`` road; the offer (its hook included), prefix affinity
and the ``auto`` role come with the heartbeats (ROADMAP.md M6).

An unparseable payload is dead-lettered to ``<queue>.failed``; a job the
engine rejects as invalid (``ValueError``) is acked and dropped; any
other failure rejects with requeue, so the broker redelivers it. A
failed engine step (a kernel launch error, say, which leaves the CUDA
context unusable) stops the worker: it stops consuming, hands its
in-flight jobs back to the queue, and :meth:`run` raises with the
engine's exception as the cause.
Heartbeats, lifecycle traces and the fault planes come with later slices
(ROADMAP M6, M16, M12).
"""

from __future__ import annotations

import asyncio
import json
import logging
import signal
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from llmq_tpu_torch.broker.base import (
    Broker,
    DeliveredMessage,
    decode_queue_name,
    interactive_queue_name,
    make_broker,
    results_queue_name,
)
from llmq_tpu_torch.core.config import Config, get_config
from llmq_tpu_torch.core.models import Job, Result
from llmq_tpu_torch.engine.engine import AsyncEngine, HandoffOutput, RequestOutput
from llmq_tpu_torch.engine.sampling import SamplingParams
from llmq_tpu_torch.engine.snapshot import (
    RequestSnapshot,
    SnapshotError,
    snapshot_from_wire,
    snapshot_to_b64,
)
from llmq_tpu_torch.utils import clock
from llmq_tpu_torch.utils.hashing import token_fold
from llmq_tpu_torch.utils.host_mem import get_governor
from llmq_tpu_torch.workers.resume import (
    RESUME_FIELD,
    JobHandoff,
    PrefillDone,
    ResultDeduper,
    resume_offset,
)

logger = logging.getLogger(__name__)

FAILED_SUFFIX = ".failed"
#: Valid LLMQ_WORKER_ROLE values (``base.py:77``); "auto" is refused.
WORKER_ROLES = ("unified", "prefill", "decode", "auto")


class DeadlineExceeded(Exception):
    """The job's ``deadline_at`` passed: dead-lettered as
    ``deadline_exceeded``, neither published nor requeued."""


def worker_role(cfg: Config) -> str:
    """The configured role, checked as ``base.py:156-162`` checks it; the
    ``auto`` role is refused with its ROADMAP.md item."""
    role = (cfg.worker_role or "unified").lower()
    if role not in WORKER_ROLES:
        raise ValueError(f"LLMQ_WORKER_ROLE must be one of {WORKER_ROLES}, got {role!r}")
    if role == "auto":
        raise NotImplementedError(
            "worker role 'auto' is not ported yet: its controller reads fleet queue depths "
            "beside the heartbeats (ROADMAP.md queue 1, M6)")
    return role


class TorchWorker:
    """Serves one queue with one engine until :meth:`request_shutdown`
    (or, with ``max_jobs``, until that many jobs have been settled)."""

    def __init__(
        self,
        queue: str,
        engine: AsyncEngine,
        *,
        broker_url: Optional[str] = None,
        concurrency: Optional[int] = None,
        max_tokens: Optional[int] = None,
        max_jobs: Optional[int] = None,
        worker_id: Optional[str] = None,
        config: Optional[Config] = None,
    ) -> None:
        cfg = config or get_config()
        self.queue = queue
        self.engine = engine
        self.broker_url = broker_url or cfg.broker_url
        # Prefetch above the batch's slots, or the engine starves: without
        # an explicit concurrency, ~1.5x slots in flight (TPUWorker's rule).
        slots = engine.core.cfg.max_num_seqs
        self.concurrency = concurrency or max(cfg.queue_prefetch, slots + slots // 2)
        self.max_tokens = max_tokens or cfg.max_tokens
        self.drain_timeout_s = cfg.drain_timeout_s
        self.priority_classes = cfg.priority_classes
        self.result_digest = cfg.result_digest
        self.role = worker_role(cfg)
        self.max_jobs = max_jobs
        self.worker_id = worker_id or f"torch-{uuid.uuid4().hex[:8]}"
        self.broker: Optional[Broker] = None
        self.jobs_processed = 0
        self.jobs_failed = 0
        self.jobs_handed_off = 0
        self.jobs_resumed = 0
        self.jobs_deadline_exceeded = 0
        self.handoffs_fallback = 0  # prefill-complete jobs republished to <q>.decode
        self.handoff_bytes = 0  # the bytes of those republished payloads
        self.jobs_adopted = 0  # handed-off jobs this worker resumed as decoder
        # Handoff publish -> adoption latency samples (ms), bounded ring.
        self._handoff_ms: deque = deque(maxlen=512)
        self._settled = 0
        self._stop: Optional[asyncio.Event] = None
        self._tags: List[str] = []
        self._dedup = ResultDeduper()
        self._in_flight = 0
        self._idle: Optional[asyncio.Event] = None  # set while no job is in flight
        self.error: Optional[BaseException] = None  # the engine failure that stopped it

    def request_shutdown(self) -> None:
        if self._stop is not None:
            self._stop.set()

    def _on_signal(self) -> None:
        """SIGINT / SIGTERM: stop taking jobs, hand those in flight off."""
        logger.info("worker %s: shutdown requested; handing off in-flight jobs",
                    self.worker_id)
        self.request_shutdown()

    async def run(self) -> None:
        self._stop = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._on_signal)
            except (NotImplementedError, RuntimeError):
                pass  # non-main thread or platform without signal support
        self.broker = make_broker(self.broker_url)
        await self.broker.connect()
        try:
            for name in (self.queue, results_queue_name(self.queue), self.queue + FAILED_SUFFIX,
                         decode_queue_name(self.queue), interactive_queue_name(self.queue)):
                await self.broker.declare_queue(name)
            sources = self._role_queues()
            for name in sources:
                self._tags.append(await self.broker.consume(
                    name, self._process_message, prefetch=self.concurrency))
            logger.info("worker %s (role %s) consuming %s", self.worker_id, self.role,
                        ", ".join(sources))
            await self._stop.wait()
            if self.error is None:
                await self._drain_with_handoff()
            for tag in self._tags:
                await self.broker.cancel(tag)
        finally:
            await self.broker.close()
        if self.error is not None:
            raise RuntimeError(f"worker {self.worker_id} stopped: its engine failed") from self.error

    def _role_queues(self) -> List[str]:
        """The queues the role serves (``base.py:379-417``): a decode worker
        the decode pool, the others the shared queue, after the fast lane
        when the priority classes are on (interactive deliveries race the
        shared queue's prefetch, and admission orders what lands)."""
        if self.role == "decode":
            return [decode_queue_name(self.queue)]
        lane = [interactive_queue_name(self.queue)] if self.priority_classes else []
        return lane + [self.queue]

    def stats(self) -> Dict[str, Any]:
        """The worker's counters; the disaggregation ones (and the handoff
        latency percentiles) only once they moved, as ``base.py:1198``."""
        out: Dict[str, Any] = dict(role=self.role, jobs_processed=self.jobs_processed,
                                   jobs_failed=self.jobs_failed,
                                   jobs_handed_off=self.jobs_handed_off,
                                   jobs_resumed=self.jobs_resumed)
        for name in ("handoffs_fallback", "handoff_bytes", "jobs_adopted"):
            if getattr(self, name):
                out[name] = getattr(self, name)
        if self._handoff_ms:
            vals = sorted(self._handoff_ms)
            out["handoff_ms_p50"] = round(vals[len(vals) // 2], 3)
            out["handoff_ms_p95"] = round(vals[min(len(vals) - 1, int(len(vals) * 0.95))], 3)
        return out

    async def _drain_with_handoff(self) -> None:
        """Deliveries stop without requeue; the engine hands every request
        it holds back as a snapshot, which the jobs' handlers republish;
        then the jobs settle, for at most ``drain_timeout_s``."""
        for tag in self._tags:
            await self.broker.cancel(tag, requeue=False)
        loop = asyncio.get_running_loop()
        handoffs = await loop.run_in_executor(None, self.engine.handoff)
        if handoffs:
            logger.info("Drained %d in-flight request(s) as resumable snapshots",
                        len(handoffs))
        try:
            await asyncio.wait_for(self._idle.wait(), timeout=self.drain_timeout_s)
        except asyncio.TimeoutError:
            logger.warning("worker %s: timed out draining %d in-flight jobs",
                           self.worker_id, self._in_flight)
        logger.info("worker %s stopped (processed=%d handed off=%d failed=%d)",
                    self.worker_id, self.jobs_processed, self.jobs_handed_off,
                    self.jobs_failed)
        logger.info("worker stats %s", json.dumps(self.stats()))

    # --- the hot loop -----------------------------------------------------
    async def _process_message(self, message: DeliveredMessage) -> None:
        self._in_flight += 1
        self._idle.clear()
        try:
            await self._settle_message(message)
        finally:
            self._in_flight -= 1
            if self._in_flight == 0:
                self._idle.set()

    async def _settle_message(self, message: DeliveredMessage) -> None:
        start = clock.monotonic()
        try:
            job = Job.model_validate_json(message.body)
        except Exception as exc:  # malformed payload: dead-letter, never requeue
            logger.error("Unparseable job dead-lettered: %s", exc)
            self.jobs_failed += 1
            await self.broker.publish(
                self.queue + FAILED_SUFFIX, message.body,
                message_id=message.message_id,
                headers={"x-failure-reason": "unparseable", "x-error": str(exc)[:500]},
            )
            await message.ack()
            self._note_settled()
            return
        if self.role == "prefill" and isinstance(job.extras().get(RESUME_FIELD), dict):
            # Resume state means the prompt KV exists already: on to the
            # decode pool untouched, not prefilled again (base.py:682).
            await self._forward_to_decode(message)
            self._note_settled()
            return
        try:
            out = await self._process_job(job)
            duration_ms = (clock.monotonic() - start) * 1000
            result = self._build_result(job, out, duration_ms)
            offset = resume_offset(job.extras())
            if self._dedup.seen(job.id, offset):
                # Redelivered after its result went out: settle silently.
                logger.info("Suppressing duplicate result for job %s (offset %d)",
                            job.id, offset)
            else:
                await self.broker.publish(
                    results_queue_name(self.queue),
                    result.model_dump_json().encode("utf-8"),
                    message_id=result.id,
                )
                self._dedup.record(job.id, offset)
            await message.ack()
            self.jobs_processed += 1
        except DeadlineExceeded:
            await self._dead_letter_deadline(message)
        except PrefillDone as exc:
            # The prefill boundary: forward progress, not a failure.
            await self._handoff_to_decode(job, message, exc)
        except JobHandoff as exc:
            await self._republish_for_resume(job, message, exc)
        except ValueError as exc:
            # Semantically invalid job: retrying can't fix it.
            logger.error("Job %s invalid, dropping: %s", job.id, exc)
            self.jobs_failed += 1
            await message.ack()
        except Exception as exc:  # noqa: BLE001 — transient: requeue
            logger.warning("Job %s failed (delivery %d), requeueing: %s",
                           job.id, message.delivery_count, exc)
            self.jobs_failed += 1
            if self.engine.error is not None:
                await self._stop_on_engine_failure()
            await message.reject(requeue=True)
            return
        self._note_settled()

    async def _dead_letter_deadline(self, message: DeliveredMessage) -> None:
        """File a job whose deadline passed on ``<queue>.failed`` as
        ``deadline_exceeded`` (``base.py:541-571``)."""
        self.jobs_deadline_exceeded += 1
        headers = dict(message.headers or {})
        headers.update({"x-error": "deadline_exceeded", "x-failure-reason": "deadline_exceeded",
                        "x-worker-id": self.worker_id,
                        "x-delivery-count": message.delivery_count})
        headers.setdefault("x-death-queue", self.queue)
        try:
            await self.broker.publish(self.queue + FAILED_SUFFIX, message.body,
                                      message_id=message.message_id, headers=headers)
        finally:
            await message.ack()

    async def _republish_for_resume(self, job: Job, message: DeliveredMessage,
                                    exc: JobHandoff) -> None:
        """Publish a handed-off job back to the queue with its snapshot
        under ``RESUME_FIELD``, then ack the delivery (``base.py:878-930``):
        until the ack the original survives, and the deduper suppresses a
        double publish. A snapshot-less handoff requeues the original."""
        if exc.snapshot_b64 is None:
            await message.reject(requeue=True)
            return
        payload = json.loads(message.body)
        payload[RESUME_FIELD] = {"snapshot": exc.snapshot_b64, "offset": exc.emitted}
        try:
            body = json.dumps(payload).encode("utf-8")
            # Resume blobs share the host-memory budget: accounted, never
            # refused (a refusal would strand a request mid-drain).
            get_governor().note_resume_blob(len(body))
            # A decode worker's requests stay in the decode pool: the shared
            # queue would hand KV-complete work back to prefill workers.
            target = decode_queue_name(self.queue) if self.role == "decode" else self.queue
            await self.broker.publish(target, body, message_id=job.id)
        except Exception:  # noqa: BLE001 — transport down mid-shutdown
            logger.warning("Resume republish failed for job %s; requeueing plain", job.id,
                           exc_info=True)
            await message.reject(requeue=True)
            return
        self.jobs_handed_off += 1
        logger.info("Job %s handed off with %d tokens generated", job.id, exc.emitted)
        await message.ack()

    async def _forward_to_decode(self, message: DeliveredMessage) -> None:
        """Move a resume-carrying job off a prefill worker onto the decode
        pool, payload untouched."""
        try:
            await self.broker.publish(decode_queue_name(self.queue), message.body,
                                      message_id=message.message_id, headers=message.headers)
        except Exception:  # noqa: BLE001 — transport down: redeliver
            logger.warning("Forward to the decode pool failed; requeueing", exc_info=True)
            await message.reject(requeue=True)
            return
        await message.ack()

    async def _handoff_to_decode(self, job: Job, message: DeliveredMessage,
                                 exc: PrefillDone) -> None:
        """Settle a prefill-complete job into the decode pool (``base.py:
        979-1050``, the snapshot road): the prompt-KV snapshot rides under
        ``RESUME_FIELD`` (offset 0: no output token was kept) with a
        wall-clock ``handoff_at`` stamp, published to ``<queue>.decode``
        before the ack, so a crash between the two leaves the original to
        redeliver and the deduper collapses the double."""
        payload = json.loads(message.body)
        payload[RESUME_FIELD] = {"snapshot": exc.snapshot_b64, "offset": 0,
                                 "handoff_at": clock.wall()}
        body = json.dumps(payload).encode("utf-8")
        get_governor().note_resume_blob(len(body))
        try:
            await self.broker.publish(decode_queue_name(self.queue), body, message_id=job.id)
        except Exception:  # noqa: BLE001 — transport down
            logger.warning("Decode-pool republish failed for job %s; requeueing plain", job.id,
                           exc_info=True)
            await message.reject(requeue=True)
            return
        self.handoffs_fallback += 1
        self.handoff_bytes += len(body)
        await message.ack()

    async def _stop_on_engine_failure(self) -> None:
        """Stop taking jobs (no redelivery loop into a dead engine); the
        in-flight ones requeue as their handlers fail."""
        if self.error is not None:
            return
        self.error = self.engine.error
        logger.error("worker %s: engine failed, stopping: %r", self.worker_id, self.error)
        for tag in self._tags:
            await self.broker.cancel(tag, requeue=False)
        self.request_shutdown()

    def _note_settled(self) -> None:
        self._settled += 1
        if self.max_jobs is not None and self._settled >= self.max_jobs:
            self.request_shutdown()

    def _sampling_for(self, job: Job) -> SamplingParams:
        """Structured ``job.sampling`` wins, loose extra fields fall back,
        reference defaults otherwise (temperature 0.7)."""
        params = SamplingParams.from_job_extras(job.extras(), default_max_tokens=self.max_tokens)
        if job.stop:
            params.stop = tuple(job.stop)
        opts = job.sampling
        if opts is not None:
            params.temperature = opts.temperature
            params.top_p = opts.top_p
            params.top_k = opts.top_k
            params.seed = opts.seed
            params.min_tokens = opts.min_tokens
            if opts.max_tokens is not None:
                params.max_tokens = opts.max_tokens
            if opts.stop:
                params.stop = tuple(opts.stop)
        return params

    def _resume_snapshot(self, job: Job) -> Optional[RequestSnapshot]:
        """The resume snapshot a handed-off job carries, or None to run it
        from its prompt (also when the blob does not decode: the prompt is
        still in the payload, so token zero is always a correct start)."""
        resume = job.extras().get(RESUME_FIELD)
        if not isinstance(resume, dict) or not resume.get("snapshot"):
            return None
        try:
            return snapshot_from_wire(resume["snapshot"])
        except SnapshotError as exc:
            logger.warning("Job %s resume snapshot unusable (%s); re-running from scratch",
                           job.id, exc)
            return None

    async def _process_job(self, job: Job) -> RequestOutput:
        params = self._sampling_for(job)
        # The deadline and the SLO class ride into the engine
        # (``tpu_worker.py:1192-1206``); batch sends nothing.
        gen_kw = {} if job.deadline_at is None else {"deadline_at": job.deadline_at}
        if job.deadline_at is not None and time.time() > job.deadline_at:
            raise DeadlineExceeded(job.id)  # before any engine work
        out = None
        snapshot = self._resume_snapshot(job)
        if snapshot is not None:
            # A handoff_at stamp marks a prefill -> decode handoff (a drain
            # handoff has none): count the adoption, sample its latency.
            handoff_at = job.extras()[RESUME_FIELD].get("handoff_at")
            if handoff_at is not None:
                try:
                    latency_ms = max(0.0, (clock.wall() - float(handoff_at)) * 1000.0)
                except (TypeError, ValueError):
                    latency_ms = 0.0
                self.jobs_adopted += 1
                self._handoff_ms.append(latency_ms)
            try:
                out = await self.engine.resume(rid=job.id, snapshot=snapshot, **gen_kw)
                self.jobs_resumed += 1
            except SnapshotError as exc:
                # A valid blob for another engine (model signature, KV dtype).
                logger.warning("Job %s snapshot not insertable (%s); re-running from scratch",
                               job.id, exc)
        if out is None:
            if job.priority_class == "interactive":
                gen_kw["priority"] = "interactive"
            if self.role == "prefill":
                # The prompt phase only: the engine finishes the request at
                # the boundary with a prompt-KV snapshot ("prefill_done").
                gen_kw["prefill_only"] = True
            if job.messages is not None:
                out = await self.engine.generate(rid=job.id, messages=job.messages,
                                                 params=params, **gen_kw)
            elif job.chat_mode:
                messages = [{"role": "user", "content": job.get_formatted_prompt()}]
                out = await self.engine.generate(rid=job.id, messages=messages, params=params,
                                                 **gen_kw)
            else:
                out = await self.engine.generate(rid=job.id, prompt=job.get_formatted_prompt(),
                                                 params=params, **gen_kw)
        if isinstance(out, HandoffOutput):
            # This worker is draining: the partial progress goes back.
            raise JobHandoff(
                snapshot_to_b64(out.snapshot) if out.snapshot is not None else None,
                out.emitted,
            )
        if out.finish_reason == "deadline_exceeded":
            raise DeadlineExceeded(job.id)
        if out.finish_reason == "prefill_done":
            if out.snapshot is None:
                # Never expected (the engine snapshots before it finishes);
                # RuntimeError, not ValueError, so the job requeues.
                raise RuntimeError(f"prefill_done for job {job.id} carried no snapshot")
            raise PrefillDone(snapshot_to_b64(out.snapshot))
        return out

    def _build_result(self, job: Job, out: RequestOutput, duration_ms: float) -> Result:
        """Result with extra-field passthrough. Built dict-first so a job
        extra named like a Result field is kept as ``job_<name>``."""
        payload = dict(job.extras())
        # The spent resume blob stays out of the result; its offset stays.
        resume = payload.pop(RESUME_FIELD, None)
        if isinstance(resume, dict):
            payload["resume_offset"] = resume_offset({RESUME_FIELD: resume})
        reserved = {
            "id": job.id,
            "prompt": job.get_formatted_prompt() if job.prompt is not None else "",
            "result": out.text,
            "worker_id": self.worker_id,
            "duration_ms": duration_ms,
        }
        for key in (*reserved, "timestamp", "usage"):
            if key in payload:
                payload[f"job_{key}"] = payload.pop(key)
        payload.update(reserved)
        result = Result.model_validate(payload)
        result.usage = {
            "prompt_tokens": out.prompt_tokens,
            "completion_tokens": out.completion_tokens,
        }
        result.finish_reason = out.finish_reason
        if self.result_digest:  # tpu_worker.py:1399
            result.token_ids = list(out.token_ids)
            result.token_digest = token_fold(out.token_ids)
        return result
