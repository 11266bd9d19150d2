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
  through, colliding names kept as ``job_<name>``) to
  ``<queue>.results``, then ack.

The broker URL, the prefetch and the default ``max_tokens`` come from
``core/config.py`` unless given, as ``BaseWorker`` / ``TPUWorker`` take
them (``base.py:112-113``, ``tpu_worker.py:177-179``). SIGINT and SIGTERM
stop the worker gracefully (``base.py:222-226``): it stops consuming,
lets the jobs in flight settle, and :meth:`run` returns.

An unparseable payload is dead-lettered to ``<queue>.failed``; a job the
engine rejects as invalid (``ValueError``) is acked and dropped; any
other failure rejects with requeue, so the broker redelivers it. A
failed engine step (a kernel launch error, say, which leaves the CUDA
context unusable) stops the worker: it stops consuming, hands its
in-flight jobs back to the queue, and :meth:`run` raises with the
engine's exception as the cause.
Heartbeats, deadlines, handoff and the fault planes come with later
slices (ROADMAP M11, M12).
"""

from __future__ import annotations

import asyncio
import logging
import signal
import uuid
from typing import Optional

from llmq_tpu_torch.broker.base import (
    Broker,
    DeliveredMessage,
    make_broker,
    results_queue_name,
)
from llmq_tpu_torch.core.config import Config, get_config
from llmq_tpu_torch.core.models import Job, Result
from llmq_tpu_torch.engine.engine import AsyncEngine, RequestOutput
from llmq_tpu_torch.engine.sampling import SamplingParams
from llmq_tpu_torch.utils import clock

logger = logging.getLogger(__name__)

FAILED_SUFFIX = ".failed"


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
        self.max_jobs = max_jobs
        self.worker_id = worker_id or f"torch-{uuid.uuid4().hex[:8]}"
        self.broker: Optional[Broker] = None
        self.jobs_processed = 0
        self.jobs_failed = 0
        self._settled = 0
        self._stop: Optional[asyncio.Event] = None
        self._tag: Optional[str] = None
        self._draining = False  # a signal asked for a graceful stop
        self._in_flight = 0
        self._idle: Optional[asyncio.Event] = None  # set while no job is in flight
        self.error: Optional[BaseException] = None  # the engine failure that stopped it

    def request_shutdown(self) -> None:
        if self._stop is not None:
            self._stop.set()

    def _on_signal(self) -> None:
        """SIGINT / SIGTERM: stop taking jobs, let those in flight settle."""
        self._draining = True
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
            for name in (self.queue, results_queue_name(self.queue), self.queue + FAILED_SUFFIX):
                await self.broker.declare_queue(name)
            self._tag = await self.broker.consume(
                self.queue, self._process_message, prefetch=self.concurrency
            )
            logger.info("worker %s consuming %s", self.worker_id, self.queue)
            await self._stop.wait()
            if self._draining and self.error is None:
                # Deliveries stop; the jobs already delivered finish and
                # settle before the connection closes.
                await self.broker.cancel(self._tag, requeue=False)
                await self._idle.wait()
                logger.info("worker %s stopped by signal after settling its jobs",
                            self.worker_id)
            await self.broker.cancel(self._tag)
        finally:
            await self.broker.close()
        if self.error is not None:
            raise RuntimeError(f"worker {self.worker_id} stopped: its engine failed") from self.error

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
        try:
            out = await self._process_job(job)
            duration_ms = (clock.monotonic() - start) * 1000
            result = self._build_result(job, out, duration_ms)
            await self.broker.publish(
                results_queue_name(self.queue),
                result.model_dump_json().encode("utf-8"),
                message_id=result.id,
            )
            await message.ack()
            self.jobs_processed += 1
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

    async def _stop_on_engine_failure(self) -> None:
        """Stop taking jobs (no redelivery loop into a dead engine); the
        in-flight ones requeue as their handlers fail."""
        if self.error is not None:
            return
        self.error = self.engine.error
        logger.error("worker %s: engine failed, stopping: %r", self.worker_id, self.error)
        await self.broker.cancel(self._tag, requeue=False)
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

    async def _process_job(self, job: Job) -> RequestOutput:
        params = self._sampling_for(job)
        if job.messages is not None:
            return await self.engine.generate(rid=job.id, messages=job.messages, params=params)
        if job.chat_mode:
            messages = [{"role": "user", "content": job.get_formatted_prompt()}]
            return await self.engine.generate(rid=job.id, messages=messages, params=params)
        return await self.engine.generate(
            rid=job.id, prompt=job.get_formatted_prompt(), params=params
        )

    def _build_result(self, job: Job, out: RequestOutput, duration_ms: float) -> Result:
        """Result with extra-field passthrough. Built dict-first so a job
        extra named like a Result field is kept as ``job_<name>``."""
        payload = dict(job.extras())
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
        return result
