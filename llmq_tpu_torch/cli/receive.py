"""Result receivers -> JSON lines on stdout (port of ``llmq_tpu/cli/receive.py``).

Results queues are durable, so receiving is resumable: detach at any time,
re-attach later and drain. Exits on an idle timeout or at ``--limit``.
``ResultPrinter`` is the one result handler of the client: ``receive``
and ``submit --stream`` both print through it.
"""

from __future__ import annotations

import asyncio
import logging
import sys
import time
from typing import Optional

from llmq_tpu_torch.broker.manager import BrokerManager
from llmq_tpu_torch.core.config import get_config
from llmq_tpu_torch.core.models import Result
from llmq_tpu_torch.core.pipeline import load_pipeline_config
from llmq_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger(__name__)


class ResultPrinter:
    """Prints each result as a JSON line on stdout and acks it. A
    malformed result, or one whose token ids no longer hash to its digest
    (corrupted between the worker and here; a requeue would redeliver the
    same bytes), is dead-lettered instead. Past ``limit`` results it takes
    no more: they are requeued for the next receiver."""

    def __init__(self, limit: Optional[int] = None) -> None:
        self.limit = limit
        self.received = 0
        self.digest_mismatches = 0
        self.last_at = time.monotonic()

    def done(self, expected: Optional[int] = None) -> bool:
        target = self.limit if expected is None else expected
        return target is not None and self.received >= target

    async def on_message(self, message) -> None:
        if self.done():
            await message.reject(requeue=True)
            return
        try:
            result = Result.model_validate_json(message.body)
        except Exception as exc:  # noqa: BLE001 — malformed: drop, don't loop
            logger.error("Dropping malformed result: %s", exc)
            await message.reject(requeue=False)
            return
        if result.verify_token_digest() is False:
            self.digest_mismatches += 1
            logger.error("Result %s failed its token-digest check (%d so far); "
                         "dead-lettering corrupt payload", result.id, self.digest_mismatches)
            await message.reject(requeue=False)
            return
        sys.stdout.write(result.model_dump_json() + "\n")
        sys.stdout.flush()
        await message.ack()
        self.received += 1
        self.last_at = time.monotonic()

    async def wait(self, idle_timeout: Optional[float], expected: Optional[int] = None) -> None:
        """Return once ``expected`` (else ``limit``) results were printed,
        or none arrived for ``idle_timeout`` seconds (None: never)."""
        self.last_at = time.monotonic()
        while not self.done(expected):
            if idle_timeout is not None and time.monotonic() - self.last_at > idle_timeout:
                logger.info("Idle timeout after %d results", self.received)
                return
            await asyncio.sleep(0.1)


class ResultReceiver:
    def __init__(
        self,
        queue: str,
        *,
        timeout: Optional[float] = None,
        limit: Optional[int] = None,
        is_pipeline_results: bool = False,
    ) -> None:
        self.queue = queue
        self.timeout = timeout
        self.is_pipeline_results = is_pipeline_results
        self.broker = BrokerManager(get_config())
        self.printer = ResultPrinter(limit)

    async def run(self) -> int:
        await self.broker.connect()
        start = time.monotonic()
        try:
            if self.is_pipeline_results:
                await self.broker.broker.declare_queue(self.queue)
                tag = await self.broker.broker.consume(self.queue, self.printer.on_message,
                                                       prefetch=100)
            else:
                tag = await self.broker.consume_results(self.queue, self.printer.on_message)
            await self.printer.wait(self.timeout)
            await self.broker.cancel(tag)
            received = self.printer.received
            elapsed = time.monotonic() - start
            if elapsed > 0 and received:
                logger.info("Received %d results in %.1fs (%.1f/s)", received, elapsed,
                            received / elapsed)
            return received
        finally:
            await self.broker.disconnect()


async def run_receive(queue: str, *, timeout: Optional[float] = None,
                      limit: Optional[int] = None) -> None:
    setup_logging(structured=False)
    # Bare queue names and explicit .results names are both accepted.
    await ResultReceiver(queue, timeout=timeout, limit=limit).run()


async def run_pipeline_receive(pipeline_path: str, *, timeout: Optional[float] = None,
                               limit: Optional[int] = None) -> None:
    setup_logging(structured=False)
    pipeline = load_pipeline_config(pipeline_path)
    await ResultReceiver(pipeline.get_pipeline_results_queue_name(), timeout=timeout,
                         limit=limit, is_pipeline_results=True).run()
