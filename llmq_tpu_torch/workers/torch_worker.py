"""The inference worker of the port: queue in, engine, results out.

``TorchWorker`` is a ``workers/base.py::BaseWorker``, as the reference's
``llmq_tpu/workers/tpu_worker.py::TPUWorker`` is one: the base worker
owns the broker session (a ``BrokerManager`` over a resilient session:
re-dial, replay, fenced settles, outbox), the queue topology with the
job TTL and redelivery caps, the heartbeats on ``<queue>.health``, the
per-job timeout, quarantine, the circuit breaker, the dead letters,
result dedup, drain-with-handoff and the roles. This class keeps what is
the engine's (``_sampling_for`` :1137, ``_process_job`` :1186,
``_build_result`` :1389 of ``tpu_worker.py``):

- build each job's ``SamplingParams`` from the extras, the job's
  ``stop`` and its structured ``sampling`` object;
- generate through the ``AsyncEngine``, or resume a job carrying a
  resume snapshot through ``engine.resume`` from the token where it
  stopped (a snapshot that cannot be decoded or inserted re-runs the job
  from its prompt, as the reference does); a job's ``deadline_at`` and
  ``priority`` reach the engine; a prefill-role worker generates with
  ``prefill_only=True``;
- build the ``Result`` on the base worker's (the job's extra fields
  passed through, colliding names kept as ``job_<name>``): usage counts,
  the finish reason; with
  ``LLMQ_RESULT_DIGEST`` on, the emitted token ids and their
  ``token_digest`` (``tpu_worker.py:1399``);
- surface the engine's ``stats()`` in the heartbeats, and hand the
  engine's unfinished requests back as snapshots when the worker drains.

The prefetch, when not given, is ``max(LLMQ_QUEUE_PREFETCH, 1.5 x the
engine's slots)``, as ``TPUWorker``'s. ``max_jobs`` (the port's) stops
the worker once that many deliveries settled without a requeue.

A failed engine step (a kernel launch error, say, which leaves the CUDA
context unusable) stops the worker: it stops consuming, hands its
in-flight jobs back to the queue, and :meth:`run` raises with the
engine's exception as the cause; the reference's in-process fault
containment comes with the fault planes (ROADMAP.md queue 1, M12). With
``breaker_failures`` set, the breaker's self-drain applies as in the
reference. A timed-out job's request keeps decoding in the engine until
its ``max_tokens``, as in the reference: neither engine aborts it.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any, Dict, Optional

from llmq_tpu_torch.broker.base import DeliveredMessage
from llmq_tpu_torch.core.config import Config, get_config
from llmq_tpu_torch.core.models import Job, Result
from llmq_tpu_torch.core.pipeline import PipelineConfig
from llmq_tpu_torch.engine.engine import AsyncEngine, HandoffOutput, RequestOutput
from llmq_tpu_torch.engine.sampling import SamplingParams
from llmq_tpu_torch.engine.snapshot import (
    RequestSnapshot,
    SnapshotError,
    snapshot_from_wire,
    snapshot_to_b64,
)
from llmq_tpu_torch.ops._build import kernel_launches
from llmq_tpu_torch.utils import clock
from llmq_tpu_torch.utils.hashing import token_fold
from llmq_tpu_torch.workers.base import (
    WORKER_ROLES,
    BaseWorker,
    DeadlineExceeded,
    worker_role,
)
from llmq_tpu_torch.workers.resume import (
    RESUME_FIELD,
    JobHandoff,
    PrefillDone,
)

__all__ = ["DeadlineExceeded", "TorchWorker", "WORKER_ROLES", "worker_role"]


class TorchWorker(BaseWorker):
    """Serves one queue with one engine until :meth:`request_shutdown`
    (or, with ``max_jobs``, until that many jobs have been settled). The
    engine's lifetime is the caller's."""

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
        pipeline: Optional[PipelineConfig] = None,
        stage_name: Optional[str] = None,
    ) -> None:
        cfg = config or get_config()
        self.engine = engine
        self._fixed_id = worker_id
        # Prefetch above the batch's slots, or the engine starves: without
        # an explicit concurrency, ~1.5x slots in flight (TPUWorker's rule).
        slots = engine.core.cfg.max_num_seqs
        super().__init__(queue, config=cfg, broker_url=broker_url,
                         concurrency=concurrency or max(cfg.queue_prefetch, slots + slots // 2),
                         pipeline=pipeline, stage_name=stage_name)
        self.max_tokens = max_tokens or cfg.max_tokens
        self.max_jobs = max_jobs
        self.jobs_resumed = 0
        self.completion_tokens = 0  # of the results it built
        self._busy_from: Optional[float] = None  # monotonic: its first job's start
        self._busy_to: Optional[float] = None  # and its last result
        self._settled = 0
        self.error: Optional[BaseException] = None  # the engine failure that stopped it

    def _generate_worker_id(self) -> str:
        return self._fixed_id or f"torch-{uuid.uuid4().hex[:8]}"

    @property
    def broker_url(self) -> str:
        return self.broker.url

    @property
    def drain_timeout_s(self) -> float:
        return self.config.drain_timeout_s

    @property
    def priority_classes(self) -> bool:
        return self.config.priority_classes

    async def run(self) -> None:
        await super().run()
        if self.error is not None:
            raise RuntimeError(f"worker {self.worker_id} stopped: its engine failed") from self.error

    async def _initialize_processor(self) -> None:
        return None  # the engine is built by the caller (cli/worker.py::build_engine)

    async def _cleanup_processor(self) -> None:
        self.logger.info("worker %s stopped (processed=%d handed off=%d failed=%d)",
                         self.worker_id, self.jobs_processed, self.jobs_handed_off,
                         self.jobs_failed)
        self.logger.info("worker stats %s", json.dumps(self.stats()))

    async def _handoff_in_flight(self) -> None:
        """SIGTERM drain-with-handoff: the engine resolves every request it
        holds with its snapshot, which the jobs' handlers republish. A
        failed engine hands nothing back: its jobs requeue."""
        if self.error is not None:
            return
        loop = asyncio.get_running_loop()
        handoffs = await loop.run_in_executor(None, self.engine.handoff)
        if handoffs:
            self.logger.info("Drained %d in-flight request(s) as resumable snapshots",
                             len(handoffs))

    async def _after_failure(self, exc: BaseException) -> None:
        """Stop taking jobs once the engine failed (no redelivery loop into
        a dead engine); the in-flight ones requeue as their handlers fail."""
        if self.engine.error is None or self.error is not None:
            return
        self.error = self.engine.error
        self.logger.error("worker %s: engine failed, stopping: %r", self.worker_id, self.error)
        await self._stop_role_consumers()
        self.request_shutdown()

    async def _process_message(self, message: DeliveredMessage) -> None:
        if self.max_jobs is None:
            await super()._process_message(message)
            return
        # Count the deliveries that settle without a requeue.
        requeued = []
        settle = message._settle

        async def recording(verb: str, requeue: bool) -> None:
            requeued.append(verb == "reject" and requeue)
            if settle is not None:
                await settle(verb, requeue)

        message._settle = recording
        await super()._process_message(message)
        if not any(requeued):
            self._settled += 1
            if self._settled >= self.max_jobs:
                self.request_shutdown()

    def stats(self) -> Dict[str, Any]:
        """The worker's counters; the disaggregation ones (and the handoff
        latency percentiles) only once they moved; once it built a result,
        ``completion_tokens`` and ``busy_s``, the span from its first job's
        start to its last result; ``kernel_launches``, this process's
        launches of each kernel (by its wrapper's name) and their routes,
        once a kernel launched (on the card)."""
        out: Dict[str, Any] = dict(role=self.role, jobs_processed=self.jobs_processed,
                                   jobs_failed=self.jobs_failed,
                                   jobs_handed_off=self.jobs_handed_off,
                                   jobs_resumed=self.jobs_resumed)
        for name in ("handoffs_fallback", "handoff_bytes", "jobs_adopted"):
            if getattr(self, name):
                out[name] = getattr(self, name)
        out.update(self._handoff_percentiles())
        if self._busy_to is not None:
            out.update(completion_tokens=self.completion_tokens,
                       busy_s=self._busy_to - self._busy_from)
        launches = kernel_launches()
        if launches:
            out["kernel_launches"] = launches
        return out

    def _engine_stats(self) -> Optional[dict]:
        return self.engine.stats()

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
            self.logger.warning("Job %s resume snapshot unusable (%s); re-running from scratch",
                           job.id, exc)
            return None

    async def _process_job(self, job: Job) -> RequestOutput:
        if self._busy_from is None:
            self._busy_from = clock.monotonic()
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
                self.logger.warning("Job %s snapshot not insertable (%s); re-running from scratch",
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
        """The base worker's result over the output's text, with the
        usage, the finish reason and, under ``result_digest``, the token
        ids and their digest."""
        result = super()._build_result(job, out.text, duration_ms)
        result.usage = {
            "prompt_tokens": out.prompt_tokens,
            "completion_tokens": out.completion_tokens,
        }
        result.finish_reason = out.finish_reason
        self.completion_tokens += out.completion_tokens
        self._busy_to = clock.monotonic()
        if self.config.result_digest:  # tpu_worker.py:1399
            result.token_ids = list(out.token_ids)
            result.token_digest = token_fold(out.token_ids)
        return result
