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
  engine's unfinished requests back as snapshots when the worker drains;
- the serving plane (``tpu_worker.py:564-616``, :983-1130). A job with a
  truthy ``stream`` extra gets token-delta frames on
  ``<q>.stream.<job id>`` (``{"text_offset", "text", "worker_id"}``, then a
  terminal ``done`` frame with the finish reason): the engine's token
  callback marshals each token onto the event loop, where a flush decodes
  the pending tokens and publishes the new text. While the decoded text
  ends in U+FFFD (a multi-byte character split across tokens) that
  trailing run is held back and sent with a later frame or the ``done``
  frame, whose text completes the result's. The reference sends it at
  once and never sends the character it stood for (ROADMAP.md queue 3
  item 20). The first frame goes out at the first token even when it has
  no text yet, so the gateway learns the serving worker (its cancels'
  address) and the client its first token (item 21). With the priority
  classes on, the worker consumes its control
  queue ``<q>.ctl.<id>``, where the gateway's ``{"cancel": job_id}`` asks
  the engine to cancel a request (``jobs_cancelled``);
- the lifecycle trace: the engine's stamps of each request (``tokenized``,
  ``admitted``, ``prefill_start``, ``first_token``, ``decode``, with
  ``preempted`` when it was) are appended to the job's record at their
  monotonic times, and ``resumed`` / ``adopted`` / ``kv_fetch_failed``
  where they happen;
- the peers' plane (``tpu_worker.py:529-980``). With prefix affinity on
  and a prefix cache, count the text chains its jobs walk and advertise
  the hottest ``CHAIN_ADVERTISE_N`` in the heartbeats; before a job whose
  prefix pages an advertising peer holds, ask that peer for the pages
  this engine lacks over ``<q>.kv.<peer>`` (at most
  ``PREFIX_FETCH_TIMEOUT_S``; a timeout negative-caches the peer, a busy
  reply or a chunk that fails its digest just prefills locally), and
  serve the same requests from peers (at most ``peer_serve_concurrency``
  a peer, and only while the host-memory governor admits it). A decode
  (or ``auto``) worker answers KV adoption offers on the same queue; a
  prefill worker makes those offers to a decode peer picked from the
  heartbeats, waiting ``handoff_timeout_s`` for the answer, and on an
  accept publishes the job once, to the peer's ``<q>.d.<peer>``. Replies
  come back on the worker's ``<q>.kv.<id>.r``, matched to their request by
  id, so offers run side by side (the reference's take one reply queue
  at a time and carry the payload in the offer: ROADMAP.md queue 3
  item 19). A decode worker still parks a payload-carrying offer (the
  reference's) on ``<q>.d.<id>`` before it accepts.

The prefetch, when not given, is ``max(LLMQ_QUEUE_PREFETCH, 1.5 x the
engine's slots)``, as ``TPUWorker``'s. ``max_jobs`` (the port's) stops
the worker once that many deliveries settled without a requeue.

Device faults (``tpu_worker.py:230-240``, :475-507, :1348-1424). The
worker wires ``engine.rebuild_core`` (a fresh core from the engine's
``core_factory``, with the first core's ``num_pages``), so the engine
contains a classified device fault in process: it rebuilds and restores
every in-flight row, and the jobs finish as if nothing happened, with
``device_fault`` -> ``engine_rebuilt`` on their traces
(:meth:`_trace_fault_events`). Each fault counts against the breaker
(``engine.on_device_fault``, marshalled onto the event loop). The
heartbeat carries ``last_dispatch_ok_age_s`` and ``integrity`` when the
engine's watchdog or an integrity knob is on. A fault the engine could
not contain (its rebuild failed: a CUDA error is sticky, and every later
call in the process fails) stops the worker: it stops consuming, its
in-flight jobs go back to the queue with the fault's class as their
failure reason, and :meth:`run` raises with the engine's exception as the
cause. The reference keeps consuming there (ROADMAP.md queue 3). With
``breaker_failures`` set, the breaker's self-drain applies as in the
reference. A timed-out job's request keeps decoding in the engine until
its ``max_tokens``, as in the reference: neither engine aborts it.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from llmq_tpu_torch.broker.base import DeliveredMessage
from llmq_tpu_torch.broker.manager import (
    ctl_queue_name,
    decode_adopt_queue_name,
    job_affinity_text,
    kv_fetch_queue_name,
    stream_queue_name,
)
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
from llmq_tpu_torch.obs.trace import (
    emit_trace_event,
    record_transition,
    trace_event,
    trace_event_at,
)
from llmq_tpu_torch.ops._build import kernel_launches
from llmq_tpu_torch.utils import clock
from llmq_tpu_torch.utils.aio import reap_all, spawn
from llmq_tpu_torch.utils.hashing import (
    rendezvous_pick,
    text_prefix_chain,
    token_fold,
    token_prefix_chain,
)
from llmq_tpu_torch.utils.host_mem import get_governor
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

# Prefix affinity: how many text-chain digests a worker tracks (an LRU of
# hit counts), how many it advertises a heartbeat, and how long a fetch of
# prefix pages from a peer may stall a job before it prefills locally.
CHAIN_TRACK_CAP = 512
CHAIN_ADVERTISE_N = 8
PREFIX_FETCH_TIMEOUT_S = 2.0

# A peer that timed out a fetch or an offer is skipped this long: its queue
# may be an orphan the janitor has not reclaimed yet.
PEER_NEGATIVE_CACHE_S = 30.0


def _chunk_digest(chunk: str) -> str:
    """The transport digest of one serialized prefix chunk: the requester
    rejects a damaged ship before it decodes it (the chunk codec checks its
    own payload on ingest as well)."""
    return hashlib.blake2b(chunk.encode("utf-8"), digest_size=16).hexdigest()


def _chunks_reply(req_id: Any, chunks: List[str]) -> bytes:
    """The JSON reply ``{"req", "chunks", "digests"}`` to a fetch. The
    chunks are base64, which JSON takes as it is, so they are joined in
    rather than scanned by the encoder (tens of MB a reply), and each is
    encoded once for the join and its digest."""
    raw = [c.encode("ascii") for c in chunks]
    digests = [hashlib.blake2b(r, digest_size=16).hexdigest() for r in raw]
    quoted = [b'"', b'", "'.join(raw), b'"'] if raw else []
    return b"".join([json.dumps({"req": req_id})[:-1].encode("utf-8"), b', "chunks": [',
                     *quoted, b'], "digests": ', json.dumps(digests).encode("utf-8"), b"}"])


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
        # In-process fault containment: the engine rebuilds its core here.
        # (A stand-in engine without the fault planes' surface has none.)
        if getattr(engine, "core_factory", None) is not None:
            engine.rebuild_core = self._rebuild_core
        self._load_checksums = getattr(engine, "load_checksums", None)  # the checkpoint's ledger
        # The peers' plane: text-chain digest -> jobs that walked it (a
        # capped LRU; the top is advertised), a lock keeping one fetch in
        # flight, the requests to peers awaiting their reply (request id ->
        # future, resolved by the reply queue's consumer, started at the
        # first request), per-requester serves in flight, peer -> monotonic
        # expiry of its negative-cache entry.
        self._chain_hits: "OrderedDict[str, int]" = OrderedDict()
        self._fetch_lock = asyncio.Lock()
        self._replies: Dict[str, asyncio.Future] = {}
        self._reply_lock = asyncio.Lock()
        self._reply_tag: Optional[str] = None
        self._peer_serving: Dict[str, int] = {}
        self._dead_peers: Dict[str, float] = {}
        self.prefix_chunks_served = 0
        self.prefix_chunks_fetched = 0
        self.prefix_fetch_timeouts = 0
        self.kv_fetch_failures = 0
        self.kv_serve_busy_rejects = 0
        # The serving plane: per-job token-delta stream state (jobs with a
        # truthy ``stream`` extra) and its flush tasks.
        self._streams: Dict[str, dict] = {}
        self._stream_tasks: set = set()
        self.stream_frames_published = 0
        self.jobs_cancelled = 0
        self.finish_reasons: Dict[str, int] = {}  # the results it built, by finish reason

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
        # The engine is built by the caller (cli/worker.py::build_engine).
        # Its fault callback fires on the engine thread mid-recovery; the
        # breaker's accounting belongs on the event loop.
        loop = asyncio.get_running_loop()
        self.engine.on_device_fault = (
            lambda reason: loop.call_soon_threadsafe(self._note_device_fault, reason))
        if self._load_checksums:
            self.logger.info("load checksums recorded for %d streamed tensor(s)",
                             len(self._load_checksums))

    def _rebuild_core(self):
        """On the engine thread, after the faulted core was freed: a fresh
        core through the engine's factory, its pool as large as the first's."""
        return self.engine.core_factory(self.engine.core.scheduler.config.num_pages)

    def _note_device_fault(self, reason: str) -> None:
        """Event-loop side of a device fault: count it against the breaker,
        so repeated rebuilds self-drain the worker even when each succeeds."""
        self.logger.error("Engine reported device fault: %s", reason)
        self._note_engine_failure(reason)

    async def _cleanup_processor(self) -> None:
        await reap_all(self._stream_tasks, label="stream flush")
        if self._reply_tag is not None:  # kept through the drain's offers
            await self._cancel_tags([self._reply_tag])
            self._reply_tag = None
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
        """Stop taking jobs once the engine failed to contain a device fault
        (no redelivery loop into a dead device); the in-flight ones requeue
        as their handlers fail."""
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
        """The worker's counters; the disaggregation and serving ones (and
        the handoff latency percentiles) only once they moved; once it built
        a result, ``completion_tokens``, ``finish_reasons`` (results by finish
        reason) and ``busy_s``, the span from its first job's start to its
        last result; ``kernel_launches``, this process's
        launches of each kernel (by its wrapper's name) and their routes,
        once a kernel launched (on the card)."""
        out: Dict[str, Any] = dict(role=self.role, jobs_processed=self.jobs_processed,
                                   jobs_failed=self.jobs_failed,
                                   jobs_handed_off=self.jobs_handed_off,
                                   jobs_resumed=self.jobs_resumed)
        for name in ("role_switches", "handoffs_shipped", "handoffs_fallback", "handoff_bytes",
                     "jobs_adopted", "stream_frames_published", "jobs_cancelled"):
            if getattr(self, name):
                out[name] = getattr(self, name)
        out.update(self._handoff_percentiles())
        if self.config.prefix_affinity:
            out.update(self._peer_counters())
        if self._busy_to is not None:
            out.update(completion_tokens=self.completion_tokens,
                       finish_reasons=dict(self.finish_reasons),
                       busy_s=self._busy_to - self._busy_from)
        launches = kernel_launches()
        if launches:
            out["kernel_launches"] = launches
        return out

    def _dispatch_ok_age(self) -> Optional[float]:
        watchdog = getattr(self.engine.core, "watchdog", None)
        return None if watchdog is None else round(watchdog.last_ok_age_s(), 3)

    def _integrity_status(self) -> Optional[str]:
        core = self.engine.core
        if (getattr(core, "logit_guard", "off") != "on"
                and getattr(core, "weight_audit_every", 0) <= 0
                and getattr(core, "canary_every", 0) <= 0):
            return None
        return core.integrity_status()

    def _trace_fault_events(self, job_id: str) -> None:
        """The engine's fault-recovery events of the request onto its trace,
        at their monotonic stamps."""
        events = self.engine.pop_fault_events(job_id)
        trace = self._job_traces.get(job_id)
        if trace is None or not events:
            return
        for name, t_mono, fields in events:
            trace_event_at(trace, name, t_mono, **fields)

    def _engine_stats(self) -> Optional[dict]:
        stats = self.engine.stats()
        # Rebuild accounting, once a fault happened.
        if getattr(self.engine, "engine_rebuilds", 0):
            stats["engine_rebuilds"] = self.engine.engine_rebuilds
            if self.engine.last_fault_reason:
                stats["last_fault_reason"] = self.engine.last_fault_reason
        # The serving counters, once they moved.
        for name in ("stream_frames_published", "jobs_cancelled"):
            if getattr(self, name):
                stats[name] = getattr(self, name)
        if self.config.prefix_affinity:
            stats.update(self._peer_counters())
        return stats

    def _peer_counters(self) -> Dict[str, int]:
        """The shipping counters, the two failure counters once they moved."""
        out = dict(prefix_chunks_served=self.prefix_chunks_served,
                   prefix_chunks_fetched=self.prefix_chunks_fetched,
                   prefix_fetch_timeouts=self.prefix_fetch_timeouts)
        for name in ("kv_fetch_failures", "kv_serve_busy_rejects"):
            if getattr(self, name):
                out[name] = getattr(self, name)
        return out

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
        if self._prefix_enabled():
            text = job_affinity_text(job)
            if text:
                self._note_prefix_chain(text)
                # A fetch may stall up to its whole timeout: a job whose
                # budget cannot cover that prefills locally at once.
                if snapshot is None and (job.deadline_at is None or
                                         time.time() + PREFIX_FETCH_TIMEOUT_S < job.deadline_at):
                    await self._maybe_fetch_prefix(job, text)
        streaming = await self._stream_begin(job)
        try:
            out = await self._generate(job, params, snapshot, gen_kw)
        finally:
            if streaming:
                await self._stream_finish(job, out)
        # The recovery's events (device_fault -> engine_rebuilt) onto the
        # trace, whether the job finished after a restore or hands off below.
        self._trace_fault_events(job.id)
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
        self._trace_engine_timing(job.id, out)
        return out

    async def _generate(self, job: Job, params: SamplingParams,
                        snapshot: Optional[RequestSnapshot], gen_kw: dict) -> Any:
        """Resume the job from its snapshot, or (no snapshot, or one this
        engine cannot insert) generate it from its prompt."""
        out = None
        trace = self._job_traces.get(job.id)
        if snapshot is not None:
            trace_event(trace, "resumed", offset=len(snapshot.output_ids))
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
                record_transition(trace, job.id, "adopted", latency_ms=round(latency_ms, 3),
                                  on_sink=dict(worker_id=self.worker_id))
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
            if self.role_active == "prefill":
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
        return out

    def _trace_engine_timing(self, job_id: str, out: RequestOutput) -> None:
        """Append the engine's monotonic lifecycle stamps of the request to
        its trace (``tpu_worker.py:1364-1388``); a phase that never
        happened (a zero stamp) is skipped."""
        trace = self._job_traces.get(job_id)
        timing = out.timing
        if trace is None or not timing:
            return
        trace_event_at(trace, "tokenized", timing.get("enqueued"))
        trace_event_at(trace, "admitted", timing.get("admitted"))
        trace_event_at(trace, "prefill_start", timing.get("prefill_start"))
        trace_event_at(trace, "first_token", timing.get("first_token"))
        preempts = int(timing.get("preempt_count", 0))
        trace_event_at(trace, "decode", timing.get("last_token"), tokens=out.completion_tokens,
                       preempt_count=preempts)
        if preempts:
            # No stamp of each preemption survives re-admission: the fact
            # and the count, at the time decoding ended.
            trace_event_at(trace, "preempted", timing.get("last_token"), count=preempts)

    def _build_result(self, job: Job, out: RequestOutput, duration_ms: float,
                      trace: Optional[dict] = None) -> Result:
        """The base worker's result over the output's text, with the
        usage, the finish reason and, under ``result_digest``, the token
        ids and their digest."""
        result = super()._build_result(job, out.text, duration_ms, trace=trace)
        result.usage = {
            "prompt_tokens": out.prompt_tokens,
            "completion_tokens": out.completion_tokens,
        }
        result.finish_reason = out.finish_reason
        self.finish_reasons[out.finish_reason] = self.finish_reasons.get(out.finish_reason, 0) + 1
        self.completion_tokens += out.completion_tokens
        self._busy_to = clock.monotonic()
        if self.config.result_digest:  # tpu_worker.py:1399
            result.token_ids = list(out.token_ids)
            result.token_digest = token_fold(out.token_ids)
        return result

    # --- the serving plane: token-delta streams and cancels ------------------
    async def _stream_begin(self, job: Job) -> bool:
        """Stream a job that asked for it (truthy ``stream`` extra): declare
        its stream queue and register an engine token callback that
        marshals each token onto the event loop. False (the job runs
        unstreamed) when the queue cannot be declared."""
        if not job.extras().get("stream"):
            return False
        sq = stream_queue_name(self.queue, job.id)
        try:
            # Short TTL: frames that outlive their reader by a minute are
            # garbage (the result on <q>.results settles the job).
            await self.broker.broker.declare_queue(sq, ttl_ms=60_000,
                                                   max_redeliveries=1_000_000_000)
        except Exception:  # noqa: BLE001 — no stream queue: run unstreamed
            self.logger.debug("Stream queue declare failed", exc_info=True)
            return False
        loop = asyncio.get_running_loop()
        # tokens by emit index (a replay overwrites); sent: characters
        # published; flushed_n: tokens decoded by the last flush; frames:
        # frames published.
        self._streams[job.id] = {"queue": sq, "tokens": [], "sent": 0, "flushed_n": 0,
                                 "frames": 0, "task": None}
        job_id = job.id

        def on_token(token: int, n_out: int) -> None:
            # Engine thread: marshal only; the event loop owns the state.
            loop.call_soon_threadsafe(self._note_stream_token, job_id, token, n_out)

        self.engine.set_token_callback(job.id, on_token)
        return True

    def _note_stream_token(self, job_id: str, token: int, n_out: int) -> None:
        st = self._streams.get(job_id)
        if st is None:
            return
        idx = n_out - 1
        if idx < len(st["tokens"]):
            st["tokens"][idx] = token
        else:
            st["tokens"].append(token)
        if st["task"] is None or st["task"].done():
            st["task"] = spawn(self._flush_stream(st, job_id), registry=self._stream_tasks,
                               name=f"stream-{job_id}")

    @staticmethod
    def _settled_text(text: str) -> str:
        """``text`` without its trailing run of U+FFFD: the decoder's mark
        for a multi-byte character whose bytes have not all arrived. The
        run is held back until a later token completes it (or the ``done``
        frame sends what it is)."""
        return text.rstrip("\ufffd")

    async def _flush_stream(self, st: dict, job_id: str) -> None:
        """Publish the settled, unsent tail of one stream's decoded text as a
        frame ``{"text_offset": characters sent, "text": delta}``. Offsets
        are absolute positions in the output's text, so a reader that sees
        overlapping frames (the job resumed elsewhere and streams again from
        token zero) skips what lies before its high-water mark."""
        tokenizer = self.engine.core.tokenizer
        try:
            while len(st["tokens"]) != st["flushed_n"]:
                n = len(st["tokens"])
                text = self._settled_text(tokenizer.decode(st["tokens"][:n]))
                st["flushed_n"] = n
                delta = text[st["sent"]:]
                if not delta and st["frames"]:
                    continue  # the first frame goes out even without text
                frame = {"id": job_id, "text_offset": st["sent"], "text": delta,
                         "worker_id": self.worker_id}
                st["sent"] += len(delta)
                st["frames"] += 1
                mid = f"{job_id}.{frame['text_offset']}" if delta else f"{job_id}.first"
                await self.broker.broker.publish(st["queue"], json.dumps(frame).encode("utf-8"),
                                                 message_id=mid)
                self.stream_frames_published += 1
        except Exception:  # noqa: BLE001 — streaming is best-effort
            self.logger.debug("Stream flush failed", exc_info=True)

    async def _stream_finish(self, job: Job, out: Any) -> None:
        """End a job's stream: unregister the callback, let a flush in
        flight land, and publish the ``done`` frame when the request
        finished here; its text is the rest of the result's text. A drain
        handoff, a prefill boundary or an error publishes none: the job
        goes on elsewhere, whose stream continues this one (offset dedup),
        and the result settles whatever raced."""
        self.engine.clear_token_callback(job.id)
        st = self._streams.pop(job.id, None)
        if st is None:
            return
        if st["task"] is not None:
            await asyncio.gather(st["task"], return_exceptions=True)
        finish = getattr(out, "finish_reason", None)
        if finish in (None, "prefill_done"):
            return
        frame = {"id": job.id, "text_offset": st["sent"], "text": out.text[st["sent"]:],
                 "done": True, "finish_reason": finish, "worker_id": self.worker_id}
        try:
            await self.broker.broker.publish(st["queue"], json.dumps(frame).encode("utf-8"),
                                             message_id=f"{job.id}.done")
            self.stream_frames_published += 1
        except Exception:  # noqa: BLE001 — the result still settles the job
            self.logger.debug("Stream done frame failed", exc_info=True)

    async def _serve_ctl(self, message: DeliveredMessage) -> None:
        """One control message: ``{"cancel": job_id}`` asks the engine to
        cancel that request. Best-effort and always acked: an unknown id
        (finished, or landed on a peer after a requeue) ages out of the
        engine's pending cancels on its own."""
        try:
            job_id = json.loads(message.body).get("cancel")
            if job_id:
                self.engine.cancel(str(job_id))
                self.jobs_cancelled += 1
                emit_trace_event(str(job_id), "cancel_requested", worker_id=self.worker_id)
        except Exception:  # noqa: BLE001 — the control plane is best-effort
            self.logger.debug("Control message failed", exc_info=True)
        finally:
            try:
                await message.ack()
            except Exception:  # noqa: BLE001 — settled already
                pass

    # --- the peers' plane: advertise, serve, fetch, adopt -------------------
    def _prefix_enabled(self) -> bool:
        """Pages move between workers only with routing on AND a prefix
        cache to hold them."""
        return self.config.prefix_affinity and self.engine.core.cfg.enable_prefix_caching

    def _note_prefix_chain(self, text: str) -> None:
        """Count the text-chain chunks this job walked; the hottest ride the
        next heartbeat as this worker's advertisement."""
        for digest in text_prefix_chain(text):
            self._chain_hits[digest] = self._chain_hits.get(digest, 0) + 1
            self._chain_hits.move_to_end(digest)
        while len(self._chain_hits) > CHAIN_TRACK_CAP:
            self._chain_hits.popitem(last=False)

    def _prefix_chains(self) -> Optional[List[str]]:
        if not self.config.prefix_affinity or not self._chain_hits:
            return None
        ranked = sorted(self._chain_hits.items(), key=lambda kv: kv[1], reverse=True)
        return [digest for digest, _ in ranked[:CHAIN_ADVERTISE_N]]

    async def _start_extra_consumers(self) -> None:
        """With the priority classes on, attach the control queue
        ``<q>.ctl.<id>`` (the gateway's cancels; 30 s TTL: a cancel that
        outlives it targets a finished job). Attach the KV server: peers
        send fetch requests (and, in a disaggregated fleet, adoption offers)
        to ``<q>.kv.<id>`` and take replies on their own ``<q>.kv.<id>.r``.
        Both are ephemeral (30 s TTL, one delivery): a requester that timed
        out has recomputed already. Decode-capable workers attach it without
        prefix shipping too."""
        if self.config.priority_classes:
            ctl_q = ctl_queue_name(self.queue, self.worker_id)
            await self.broker.broker.declare_queue(ctl_q, ttl_ms=30_000, max_redeliveries=1)
            self._extra_tags.append(
                await self.broker.broker.consume(ctl_q, self._serve_ctl, prefetch=4))
        if not (self._prefix_enabled() or self.role in ("decode", "auto")):
            return
        kv_q = kv_fetch_queue_name(self.queue, self.worker_id)
        for name in (kv_q, kv_q + ".r"):
            await self.broker.broker.declare_queue(name, ttl_ms=30_000, max_redeliveries=1)
        self._extra_tags.append(
            await self.broker.broker.consume(kv_q, self._serve_kv_fetch, prefetch=4))

    async def _serve_kv_fetch(self, message: DeliveredMessage) -> None:
        """One request: ``{"want": [hex], "reply_to": q, "req": id, "from":
        worker}`` -> export what of the want-list this engine holds (host
        tier or device cache) and publish the chunks back, each with the
        outer digest the requester checks before it ingests. More than
        ``peer_serve_concurrency`` exports in flight for one requester, or
        a governor past its serve rung, replies ``{"busy": true}`` at once.
        An ``adopt`` offer goes to :meth:`_serve_adopt_offer`. Always acks:
        a failed export only means the requester recomputes."""
        peer_key = None
        try:
            req = json.loads(message.body)
            if "adopt" in req:
                # One durable publish, not a page export: outside the
                # serve accounting (peer_key stays None).
                await self._serve_adopt_offer(req)
                return
            want = [str(d) for d in (req.get("want") or [])][:64]
            reply_to = req.get("reply_to")
            req_id = req.get("req")
            peer_key = str(req.get("from") or reply_to or "?")
            cap = self.config.peer_serve_concurrency
            busy = (cap > 0 and self._peer_serving.get(peer_key, 0) >= cap) or \
                not get_governor().admit_serve()
            if busy:
                self.kv_serve_busy_rejects += 1
                peer_key = None  # nothing in flight to count down
                if reply_to:
                    await self.broker.broker.publish(
                        reply_to, json.dumps({"req": req_id, "busy": True}).encode("utf-8"))
                return
            self._peer_serving[peer_key] = self._peer_serving.get(peer_key, 0) + 1
            chunks: List[str] = []
            if want:
                loop = asyncio.get_running_loop()
                chunks = await loop.run_in_executor(
                    None, lambda: self.engine.export_prefix_chunks(want))
            if reply_to:
                await self.broker.broker.publish(reply_to, _chunks_reply(req_id, chunks))
            self.prefix_chunks_served += len(chunks)
        except Exception:  # noqa: BLE001 — serving is best-effort
            self.logger.debug("KV fetch request failed", exc_info=True)
        finally:
            if peer_key is not None:
                left = self._peer_serving.get(peer_key, 1) - 1
                if left > 0:
                    self._peer_serving[peer_key] = left
                else:
                    self._peer_serving.pop(peer_key, None)
            try:
                await message.ack()
            except Exception:  # noqa: BLE001 — settled already, or the transport is gone
                pass

    async def _serve_adopt_offer(self, req: dict) -> None:
        """The decode side of the handshake: a prefill peer asks this worker
        to adopt a prefill-complete job. Accepted iff this worker serves the
        decode role now; the peer then publishes the job to ``<q>.d.<id>``.
        An offer that carries the job (``adopt`` non-empty: the reference's)
        is parked there BEFORE the reply goes out. Either way the job lands
        on a queue that this worker's consumer, its retirement or the
        janitor drains."""
        reply_to, req_id, payload = req.get("reply_to"), req.get("req"), req.get("adopt")
        accept = self.running and self.role_active == "decode" and isinstance(payload, str)
        if accept and payload:
            aq = decode_adopt_queue_name(self.queue, self.worker_id)
            try:
                await self.broker.broker.declare_queue(
                    aq, ttl_ms=self.config.job_ttl_ms,
                    max_redeliveries=self.config.max_redeliveries)
                await self.broker.broker.publish(aq, payload.encode("utf-8"), message_id=req_id)
            except Exception:  # noqa: BLE001 — cannot park it: decline
                self.logger.debug("Adoption park failed", exc_info=True)
                accept = False
        if reply_to:
            reply = {"req": req_id, "accepted": True} if accept else {"req": req_id, "busy": True}
            try:
                await self.broker.broker.publish(reply_to, json.dumps(reply).encode("utf-8"))
            except Exception:  # noqa: BLE001 — the offerer times out and falls back
                self.logger.debug("Adoption reply failed", exc_info=True)

    async def _ship_to_decode_peer(self, job: Job, body: bytes) -> bool:
        """Pick a decode peer for this prefill-complete job (the deepest
        prefix match among the fresh decode heartbeats, rendezvous-hashed;
        without one, the job id rendezvous-hashed over them all) and run
        the offer handshake. False on any miss: no fresh peer, all
        negative-cached, a decline, or no answer in time."""
        try:
            mapping = await self.broker.decode_targets(self.queue)
        except Exception:  # noqa: BLE001 — discovery failed: the fallback road
            return False
        now = time.monotonic()
        peers = [w for w in mapping if w != self.worker_id and not self._peer_dead(w, now)]
        if not peers:
            return False
        peer = None
        text = job_affinity_text(job)
        if text:
            for digest in reversed(text_prefix_chain(text)):
                candidates = [w for w in peers if digest in (mapping.get(w) or [])]
                if candidates:
                    peer = rendezvous_pick(digest, candidates)
                    break
        if peer is None:
            peer = rendezvous_pick(job.id, sorted(peers))
        return await self._offer_adoption(peer, job.id, body)

    async def _offer_adoption(self, peer: str, job_id: str, body: bytes) -> bool:
        """Ask ``peer`` to adopt the job and wait up to
        ``handoff_timeout_s`` for its answer; on an explicit accept publish
        the payload to its ``<q>.d.<peer>``. True once it is there. A
        timeout also negative-caches the peer."""
        try:
            reply = await self._ask_peer(peer, {"adopt": ""}, self.config.handoff_timeout_s)
        except Exception:  # noqa: BLE001 — the peer's queue is gone
            return False
        if reply is None:
            self._dead_peers[peer] = time.monotonic() + PEER_NEGATIVE_CACHE_S
            return False
        if not reply.get("accepted"):
            return False
        await self.broker.broker.publish(decode_adopt_queue_name(self.queue, peer), body,
                                         message_id=job_id)
        return True

    async def _ask_peer(self, peer: str, request: dict, timeout_s: float) -> Optional[dict]:
        """Publish ``request`` to the peer's ``<q>.kv.<peer>`` under a
        request id of its own and wait up to ``timeout_s`` for the reply
        that carries it back on this worker's ``.r`` queue; None when none
        came in time. Raises when the request cannot be published."""
        reply_q = kv_fetch_queue_name(self.queue, self.worker_id) + ".r"
        async with self._reply_lock:
            if self._reply_tag is None:
                # The reply needs its landing place before the request goes out.
                await self.broker.broker.declare_queue(reply_q, ttl_ms=30_000,
                                                       max_redeliveries=1)
                self._reply_tag = await self.broker.broker.consume(
                    reply_q, self._take_reply, prefetch=16)
        req_id = uuid.uuid4().hex
        reply = self._replies[req_id] = asyncio.get_running_loop().create_future()
        try:
            await self.broker.broker.publish(kv_fetch_queue_name(self.queue, peer), json.dumps(
                {**request, "reply_to": reply_q, "req": req_id,
                 "from": self.worker_id}).encode("utf-8"))
            return await asyncio.wait_for(reply, timeout_s)
        except asyncio.TimeoutError:
            return None
        finally:
            self._replies.pop(req_id, None)

    async def _take_reply(self, message: DeliveredMessage) -> None:
        """A peer's reply: resolve the request waiting for it. A reply to a
        request that timed out already is dropped."""
        try:
            payload = json.loads(message.body)
        except Exception:  # noqa: BLE001
            payload = None
        try:
            await message.ack()
        except Exception:  # noqa: BLE001 — settled already, or the transport is gone
            pass
        req_id = payload.get("req") if isinstance(payload, dict) else None
        waiting = self._replies.get(req_id) if isinstance(req_id, str) else None
        if waiting is not None and not waiting.done():
            waiting.set_result(payload)

    async def _maybe_fetch_prefix(self, job: Job, text: str) -> None:
        """A job whose prefix pages an advertising peer holds: ship the
        pages this engine lacks instead of recomputing them. Best-effort:
        no peer, no reply in time or a bad chunk all prefill locally."""
        core = self.engine.core
        if core.prefix_store is None:
            return  # nowhere to land shipped pages
        if self._fetch_lock.locked():
            return  # another job's fetch is in flight: prefill locally
        tchain = text_prefix_chain(text)
        if not tchain:
            return
        mapping = await self.broker.affinity_targets(self.queue)
        peer = None
        now = time.monotonic()
        for digest in reversed(tchain):
            candidates = [w for w in mapping.get(digest, [])
                          if w != self.worker_id and not self._peer_dead(w, now)]
            if candidates:
                peer = rendezvous_pick(digest, candidates)
                break
        if peer is None:
            return
        try:
            token_ids = core.tokenizer.encode(text)
        except Exception:  # noqa: BLE001 — a tokenizer hiccup: just prefill
            return
        digests = [h.hex() for h in token_prefix_chain(token_ids, core.cfg.page_size)]
        if not digests:
            return
        loop = asyncio.get_running_loop()
        want = await loop.run_in_executor(None,
                                          lambda: self.engine.missing_prefix_digests(digests))
        if not want:
            return
        async with self._fetch_lock:  # one fetch in flight at a time
            await self._fetch_from_peer(peer, want, job.id)

    def _peer_dead(self, peer: str, now: float) -> bool:
        """Is ``peer`` negative-cached at monotonic ``now``? (An expired
        entry drops.)"""
        expiry = self._dead_peers.get(peer)
        if expiry is None:
            return False
        if now >= expiry:
            self._dead_peers.pop(peer, None)
            return False
        return True

    def _note_kv_fetch_failed(self, req_id: str, peer: str, reason: str) -> None:
        """Count a failed fetch and stamp why on the job's trace (reason:
        timeout, busy or digest-mismatch: a dead peer, a loaded one, a
        damaged ship)."""
        self.kv_fetch_failures += 1
        record_transition(self._job_traces.get(req_id), req_id, "kv_fetch_failed", peer=peer,
                          reason=reason, on_sink=dict(worker_id=self.worker_id))
        self.logger.debug("KV fetch for %s from %s failed: %s", req_id, peer, reason)

    async def _fetch_from_peer(self, peer: str, want: List[str], req_id: str) -> None:
        try:
            payload = await self._ask_peer(peer, {"want": want[:64]}, PREFIX_FETCH_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — the peer's queue is gone: recompute
            return
        if payload is None:
            self.prefix_fetch_timeouts += 1
            self._dead_peers[peer] = time.monotonic() + PEER_NEGATIVE_CACHE_S
            self._note_kv_fetch_failed(req_id, peer, "timeout")
            return
        if payload.get("busy"):
            # Load, not death: recompute now, no negative cache.
            self._note_kv_fetch_failed(req_id, peer, "busy")
            return
        chunks = payload.get("chunks") or []
        digests = payload.get("digests")
        if chunks and isinstance(digests, list) and (
                len(digests) != len(chunks)
                or any(_chunk_digest(c) != d for c, d in zip(chunks, digests))):
            self.logger.warning("Peer %s shipped chunks failing digest check", peer)
            self._note_kv_fetch_failed(req_id, peer, "digest-mismatch")
            return
        if chunks:
            loop = asyncio.get_running_loop()
            try:
                n = await loop.run_in_executor(None,
                                               lambda: self.engine.ingest_prefix_chunks(chunks))
                self.prefix_chunks_fetched += n
                self.logger.info("Fetched %d prefix page(s) from %s", n, peer)
            except SnapshotError as exc:
                # The payload's own integrity or compatibility check.
                self.logger.warning("Peer %s shipped incompatible prefix chunks: %s", peer, exc)
                self._note_kv_fetch_failed(req_id, peer, "digest-mismatch")
