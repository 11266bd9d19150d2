"""Dummy echo worker: the deterministic fake inference backend of tests and
pipeline rehearsals (port of ``llmq_tpu/workers/dummy.py``).

Each job's result is ``echo <prompt>`` (its formatted prompt, or the
content of its last message) after ``delay`` seconds. The reference also
publishes token-delta frames for jobs with a truthy ``stream`` extra,
which only its gateway reads; they come with the port's gateway
(ROADMAP.md queue 1, M16).
"""

from __future__ import annotations

import asyncio
import uuid

from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.workers.base import BaseWorker


class DummyWorker(BaseWorker):
    def __init__(self, queue: str, *, delay: float = 1.0, **kwargs) -> None:
        self.delay = delay
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
            return f"echo {last}"
        return f"echo {job.get_formatted_prompt()}"

    async def _cleanup_processor(self) -> None:
        return None
