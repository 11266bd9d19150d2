"""Dummy echo worker: the deterministic fake inference backend of tests and
pipeline rehearsals (port of ``llmq_tpu/workers/dummy.py``).

Each job's result is ``echo <prompt>`` (its formatted prompt, or the
content of its last message) after ``delay`` seconds. A job with a truthy
``stream`` extra also gets per-word token-delta frames on
``<q>.stream.<job_id>`` (the engine worker's wire protocol: absolute
``text_offset`` character frames, then a terminal ``done`` frame), so the
gateway's SSE path runs without an engine.
"""

from __future__ import annotations

import asyncio
import json
import re
import uuid

from llmq_tpu_torch.broker.manager import stream_queue_name
from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.workers.base import BaseWorker


class DummyWorker(BaseWorker):
    def __init__(self, queue: str, *, delay: float = 1.0, **kwargs) -> None:
        self.delay = delay
        self.stream_frames_published = 0
        super().__init__(queue, **kwargs)

    def _generate_worker_id(self) -> str:
        return f"dummy-{uuid.uuid4().hex[:8]}"

    async def _initialize_processor(self) -> None:
        return None

    async def _process_job(self, job: Job) -> str:
        if self.delay > 0:
            await asyncio.sleep(self.delay)
        if job.messages is not None:
            last = job.messages[-1].get("content", "") if job.messages else ""
            output = f"echo {last}"
        else:
            output = f"echo {job.get_formatted_prompt()}"
        if job.extras().get("stream"):
            await self._stream_output(job, output)
        return output

    async def _stream_output(self, job: Job, output: str) -> None:
        """Publish the output as one frame a word, then the ``done`` frame:
        best-effort, as the engine worker's (the result settles the job if
        every frame is lost)."""
        sq = stream_queue_name(self.queue, job.id)
        try:
            await self.broker.broker.declare_queue(sq, ttl_ms=60_000,
                                                   max_redeliveries=1_000_000_000)
            sent = 0
            for chunk in re.findall(r"\S+\s*", output) or [output]:
                frame = {"id": job.id, "text_offset": sent, "text": chunk,
                         "worker_id": self.worker_id}
                sent += len(chunk)
                await self.broker.broker.publish(sq, json.dumps(frame).encode("utf-8"),
                                                 message_id=f"{job.id}.{frame['text_offset']}")
                self.stream_frames_published += 1
            done = {"id": job.id, "text_offset": sent, "text": "", "done": True,
                    "finish_reason": "stop", "worker_id": self.worker_id}
            await self.broker.broker.publish(sq, json.dumps(done).encode("utf-8"),
                                             message_id=f"{job.id}.done")
            self.stream_frames_published += 1
        except Exception:  # noqa: BLE001 — streaming is best-effort
            self.logger.debug("Dummy stream publish failed", exc_info=True)

    async def _cleanup_processor(self) -> None:
        return None
