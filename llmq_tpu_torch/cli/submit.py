"""Job submission (port of ``llmq_tpu/cli/submit.py``).

Sources (the reference's detection rules): ``-`` = stdin JSONL; an
existing path = JSONL file; anything else = a HuggingFace dataset name
(streamed; ``datasets`` is imported then, as the reference imports it).

``--map`` semantics live in ``core/template.py``. Submission is chunked
(``LLMQ_CHUNK_SIZE``) with concurrent publishes inside a chunk.
``--stream`` consumes results while submitting, with an idle-reset timeout,
and writes each as a JSON line on stdout. Progress goes to stderr as the
reference's plain carriage-return line (its non-terminal display; the port
carries no ``rich``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

from llmq_tpu_torch.broker.manager import BrokerManager
from llmq_tpu_torch.cli.receive import ResultPrinter
from llmq_tpu_torch.core.config import get_config
from llmq_tpu_torch.core.models import JOB_PRIORITIES, Job
from llmq_tpu_torch.core.pipeline import PipelineConfig, load_pipeline_config
from llmq_tpu_torch.core.template import create_job_from_row
from llmq_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger(__name__)


def _iter_jsonl(stream) -> Iterator[Dict[str, Any]]:
    for lineno, line in enumerate(stream, 1):
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError as exc:
            logger.warning("Skipping malformed JSONL line %d: %s", lineno, exc)


def _iter_hf_dataset(name: str, *, split: str, subset: Optional[str]) -> Iterator[Dict[str, Any]]:
    """Streaming HF dataset iterator with the reference's subset / split
    fallback."""
    from datasets import load_dataset

    try:
        ds = (load_dataset(name, subset, split=split, streaming=True) if subset
              else load_dataset(name, split=split, streaming=True))
    except ValueError:
        # Some datasets need an explicit default config or other split names.
        ds = load_dataset(name, split="train", streaming=True)
    for row in ds:
        yield dict(row)


def iter_source(source: str, *, split: str = "train",
                subset: Optional[str] = None) -> Iterator[Dict[str, Any]]:
    if source == "-":
        return _iter_jsonl(sys.stdin)
    if Path(source).exists():
        return _iter_jsonl(Path(source).open())
    return _iter_hf_dataset(source, split=split, subset=subset)


class _SubmitProgress:
    """Submit progress on stderr: a carriage-return ``submitted N jobs``
    line, finished by a newline unless results stream to stdout."""

    def __init__(self, *, stream: bool) -> None:
        self.stream = stream

    def __enter__(self) -> "_SubmitProgress":
        return self

    def __exit__(self, *exc) -> None:
        if not self.stream:
            print(file=sys.stderr)  # finish the \r line

    def submitted(self, count: int) -> None:
        print(f"\rsubmitted {count} jobs", end="", file=sys.stderr, flush=True)


#: Seconds ``--stream`` waits for the next result before it gives up on
#: the rest.
STREAM_IDLE_TIMEOUT_S = 30.0


class JobSubmitter:
    """Chunked concurrent submission + optional result streaming."""

    def __init__(
        self,
        queue: str,
        source: str,
        mapping: Optional[Dict[str, Any]] = None,
        *,
        stream: bool = False,
        split: str = "train",
        subset: Optional[str] = None,
        limit: Optional[int] = None,
        priority: Optional[str] = None,
    ) -> None:
        if priority is not None and priority not in JOB_PRIORITIES:
            raise ValueError(f"priority must be one of {JOB_PRIORITIES}, got {priority!r}")
        self.queue = queue
        self.source = source
        self.mapping = mapping or {}
        self.stream = stream
        self.split = split
        self.subset = subset
        self.limit = limit
        # SLO class stamped onto every job (row-level priority fields win);
        # None stamps nothing.
        self.priority = priority
        self.config = get_config()
        self.broker = BrokerManager(self.config)
        self.submitted = 0
        self._progress: Optional[_SubmitProgress] = None

    async def run(self) -> int:
        await self.broker.connect()
        try:
            await self._declare_queues()
            printer = ResultPrinter() if self.stream else None
            consumer_tag = await self._consume_results(printer.on_message) if printer else None
            with _SubmitProgress(stream=self.stream) as progress:
                self._progress = progress
                await self._submit_all()
                if printer is not None:
                    await printer.wait(STREAM_IDLE_TIMEOUT_S, expected=self.submitted)
                    await self.broker.cancel(consumer_tag)
            return self.submitted
        finally:
            self._progress = None
            await self.broker.disconnect()

    async def _declare_queues(self) -> None:
        await self.broker.setup_queue_infrastructure(self.queue)

    async def _consume_results(self, handler) -> str:
        return await self.broker.consume_results(self.queue, handler)

    # --- submission -------------------------------------------------------
    async def _submit_all(self) -> None:
        start = time.monotonic()
        run_id = uuid.uuid4().hex[:10]  # unique per submit run
        chunk: list[Job] = []
        seq = 0
        for row in iter_source(self.source, split=self.split, subset=self.subset):
            # --limit counts jobs accepted, not raw rows.
            if self.limit is not None and self.submitted + len(chunk) >= self.limit:
                break
            seq += 1
            try:
                job_dict = create_job_from_row(row, self.mapping or None,
                                               job_id=f"{run_id}-{seq}")
                if self.priority is not None:
                    job_dict.setdefault("priority", self.priority)
                chunk.append(Job(**job_dict))
            except Exception as exc:  # noqa: BLE001 — skip bad rows, keep going
                logger.warning("Skipping invalid row %d: %s", seq, exc)
                continue
            if len(chunk) >= self.config.chunk_size:
                await self._submit_chunk(chunk)
                chunk = []
        if chunk:
            await self._submit_chunk(chunk)
        elapsed = time.monotonic() - start
        rate = self.submitted / elapsed if elapsed > 0 else 0.0
        logger.info("Submitted %d jobs to '%s' in %.1fs (%.0f jobs/s)", self.submitted,
                    self.queue, elapsed, rate)

    async def _submit_chunk(self, jobs: list[Job]) -> None:
        await asyncio.gather(*(self.broker.publish_job(self.queue, job) for job in jobs))
        self.submitted += len(jobs)
        if self._progress is not None:
            self._progress.submitted(self.submitted)
        await asyncio.sleep(0.01)  # let the loop breathe between chunks


class PipelineSubmitter(JobSubmitter):
    """Submit to stage 1 of a pipeline: declares every stage queue, merges
    stage 1's template under the user's ``--map``, optionally streams the
    final results."""

    def __init__(
        self,
        pipeline: PipelineConfig,
        source: str,
        mapping: Optional[Dict[str, Any]] = None,
        *,
        stream: bool = False,
        split: str = "train",
        subset: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> None:
        self.pipeline = pipeline
        stage1 = pipeline.stages[0]
        # Stage 1's template from the pipeline file, overridden by --map.
        merged: Dict[str, Any] = {}
        if stage1.messages_template() is not None:
            merged["messages"] = stage1.messages_template()
        elif stage1.prompt_template() is not None:
            merged["prompt"] = stage1.prompt_template()
        merged.update(mapping or {})
        super().__init__(pipeline.get_stage_queue_name(stage1.name), source, merged,
                         stream=stream, split=split, subset=subset, limit=limit)

    async def _declare_queues(self) -> None:
        await self.broker.setup_pipeline_infrastructure(self.pipeline)

    async def _consume_results(self, handler) -> str:
        return await self.broker.broker.consume(
            self.pipeline.get_pipeline_results_queue_name(), handler, prefetch=100)


async def run_submit(
    queue: str,
    source: str,
    mapping: Dict[str, Any],
    *,
    stream: bool = False,
    split: str = "train",
    subset: Optional[str] = None,
    limit: Optional[int] = None,
    priority: Optional[str] = None,
) -> None:
    setup_logging(structured=False)
    submitter = JobSubmitter(queue, source, mapping, stream=stream, split=split, subset=subset,
                             limit=limit, priority=priority)
    await submitter.run()


async def run_pipeline_submit(
    pipeline_path: str,
    source: str,
    mapping: Dict[str, Any],
    *,
    stream: bool = False,
    split: str = "train",
    subset: Optional[str] = None,
    limit: Optional[int] = None,
) -> None:
    setup_logging(structured=False)
    pipeline = load_pipeline_config(pipeline_path)
    submitter = PipelineSubmitter(pipeline, source, mapping, stream=stream, split=split,
                                  subset=subset, limit=limit)
    await submitter.run()
