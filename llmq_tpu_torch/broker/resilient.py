"""Resilient broker session layer: mid-run reconnect over any transport
(port of ``llmq_tpu/broker/resilient.py``).

A bare transport's dial covers only the start of a run; without this layer
a broker restart or network blip mid-run kills a consumer permanently — a
fleet of workers goes idle forever while the queue refills. The
``ResilientBroker`` wraps any ``Broker`` implementation and turns a broker
session into something that survives the most common production fault:

- **Loss detection**: both the transport's ``on_connection_lost`` signal and
  any operation raising a connection-class error mark the session down.
- **Re-dial**: capped exponential backoff with jitter, first attempt
  immediate (a broker bounce costs ~one backoff step, not a worker restart).
- **Session replay**: the recorded queue topology is re-declared and every
  active consumer is re-established with its prefetch on the new connection.
- **Settle fencing**: ack/reject for a message delivered over a previous
  connection generation is a no-op — the broker already requeued it when the
  old connection died, so redelivery (at-least-once) is the source of truth
  and a stale settle must not be sent down the new connection.
- **Publish outbox**: publishes during an outage park in a *bounded* buffer
  and flush in order on reconnect. The bound matters: when it fills, callers
  block until the flush, so back-pressure still propagates to submitters
  instead of the outage silently buffering unbounded work in RAM.

Observability rides along in ``SessionStats`` (reconnects, fenced settles,
outbox traffic); workers surface it through heartbeats. Two process-wide
latency histograms in the metrics registry time every publish (outbox
parking included) and every settle: ``llmq_broker_publish_seconds`` and
``llmq_broker_settle_seconds``.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Optional

from llmq_tpu_torch.broker.base import (
    Broker,
    DeliveredMessage,
    MessageHandler,
    make_broker,
)
from llmq_tpu_torch.core.models import QueueStats
from llmq_tpu_torch.obs.metrics import get_registry
from llmq_tpu_torch.utils.aio import reap

logger = logging.getLogger(__name__)

# Process-wide latency series (get-or-create: every session in this
# process shares one). Publish latency includes outbox parking — what a
# caller actually waited, not just the happy path.
_publish_hist = get_registry().histogram(
    "llmq_broker_publish_seconds", "Broker publish call latency"
)
_settle_hist = get_registry().histogram(
    "llmq_broker_settle_seconds", "Broker ack/reject settle latency"
)

#: Exception classes treated as "the connection died" (everything else is a
#: broker-side error and propagates to the caller unchanged).
RECONNECT_EXCEPTIONS = (ConnectionError, OSError)

#: The first dial's attempts and its backoff base, doubled per attempt
#: (the reference's ``connect_retries`` / ``connect_base_delay`` defaults).
CONNECT_RETRIES = 5
CONNECT_BASE_DELAY_S = 1.0


@dataclass
class SessionStats:
    """Counters for one broker session (across all its connections)."""

    reconnects: int = 0
    disconnects: int = 0
    fenced_settles: int = 0
    outbox_parked: int = 0
    outbox_flushed: int = 0
    generation: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {
            "reconnects": self.reconnects,
            "disconnects": self.disconnects,
            "fenced_settles": self.fenced_settles,
            "outbox_parked": self.outbox_parked,
            "outbox_flushed": self.outbox_flushed,
            "generation": self.generation,
        }


@dataclass
class _ConsumerRecord:
    tag: str
    queue: str
    handler: MessageHandler
    prefetch: int
    inner_tag: Optional[str] = None


@dataclass
class _ParkedPublish:
    queue: str
    body: bytes
    message_id: Optional[str]
    headers: Optional[Dict[str, Any]]


class ResilientBroker(Broker):
    """Reconnecting session wrapper around any ``Broker`` implementation."""

    def __init__(
        self,
        url: str,
        *,
        broker: Optional[Broker] = None,
        reconnect_base_delay: float = 0.5,
        reconnect_max_delay: float = 30.0,
        outbox_limit: int = 10_000,
    ) -> None:
        self.url = url
        self.inner = broker if broker is not None else make_broker(url)
        self.reconnect_base_delay = reconnect_base_delay
        self.reconnect_max_delay = reconnect_max_delay
        self.outbox_limit = max(1, outbox_limit)
        self.session = SessionStats()
        self._rng = random.Random()
        self._topology: Dict[str, Dict[str, Any]] = {}
        self._consumers: Dict[str, _ConsumerRecord] = {}
        self._outbox: Deque[_ParkedPublish] = deque()
        self._connected = asyncio.Event()
        self._wake: asyncio.Event = asyncio.Event()
        self._closed = False
        self._generation = 0
        self._reconnect_task: Optional[asyncio.Task] = None
        self._tag_seq = 0

    # --- lifecycle --------------------------------------------------------
    @property
    def is_connected(self) -> bool:
        return self._connected.is_set() and not self._closed

    async def connect(self) -> None:
        if self._connected.is_set():
            return
        last_exc: Optional[Exception] = None
        for attempt in range(CONNECT_RETRIES):
            try:
                await self.inner.connect()
                break
            except Exception as exc:  # noqa: BLE001 — retrying any dial failure
                last_exc = exc
                await self._close_inner()
                if attempt == CONNECT_RETRIES - 1:
                    raise ConnectionError(
                        f"Could not connect to broker at {self.url!r} "
                        f"after {CONNECT_RETRIES} attempts"
                    ) from last_exc
                await asyncio.sleep(CONNECT_BASE_DELAY_S * (2**attempt))
        self.inner.on_connection_lost = self._on_inner_lost
        self._connected.set()
        self._wake.set()

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        await reap(self._reconnect_task, label="reconnect loop")
        self._reconnect_task = None
        await self._close_inner()
        self._connected.clear()

    async def _close_inner(self) -> None:
        try:
            await self.inner.close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass

    # --- loss / reconnect machinery ---------------------------------------
    def _on_inner_lost(self) -> None:
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop to reconnect on (interpreter teardown)
        self._connection_lost(ConnectionError("transport signalled loss"))

    def _connection_lost(self, exc: Optional[BaseException]) -> None:
        """Mark the session down and start the re-dial loop (idempotent)."""
        if self._closed or not self._connected.is_set():
            return
        self._connected.clear()
        self.session.disconnects += 1
        logger.warning(
            "Broker connection to %s lost (%s); reconnecting", self.url, exc
        )
        self._reconnect_task = asyncio.ensure_future(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        attempt = 0
        while not self._closed:
            try:
                await self._reestablish()
                return
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — any failure: back off, retry
                attempt += 1
                delay = min(
                    self.reconnect_max_delay,
                    self.reconnect_base_delay * (2 ** min(attempt - 1, 16)),
                )
                delay *= 0.5 + self._rng.random() / 2  # jitter: 50–100%
                logger.info(
                    "Reconnect attempt %d to %s failed (%s); retrying in %.2fs",
                    attempt,
                    self.url,
                    exc,
                    delay,
                )
                await asyncio.sleep(delay)

    async def _reestablish(self) -> None:
        """One full session rebuild on a fresh connection."""
        # New generation FIRST: settles for anything delivered on the old
        # (or a half-built) connection must fence from here on.
        self._generation += 1
        self.session.generation = self._generation
        await self._close_inner()
        await self.inner.connect()
        self.inner.on_connection_lost = self._on_inner_lost
        for name, kwargs in self._topology.items():
            await self.inner.declare_queue(name, **kwargs)
        for rec in self._consumers.values():
            rec.inner_tag = await self.inner.consume(
                rec.queue, self._wrap_handler(rec), prefetch=rec.prefetch
            )
        flushed = await self._flush_outbox()
        self.session.reconnects += 1
        self._connected.set()
        self._wake.set()
        logger.info(
            "Broker session to %s re-established (generation %d, "
            "%d consumers, %d parked publishes flushed)",
            self.url,
            self._generation,
            len(self._consumers),
            flushed,
        )

    async def _flush_outbox(self) -> int:
        flushed = 0
        while self._outbox:
            item = self._outbox[0]
            await self.inner.publish(
                item.queue,
                item.body,
                message_id=item.message_id,
                headers=item.headers,
            )
            self._outbox.popleft()
            self.session.outbox_flushed += 1
            flushed += 1
            self._wake.set()  # space freed: unblock back-pressured publishers
        return flushed

    # --- waiting helpers --------------------------------------------------
    async def _wait_for_state(self, cond: Callable[[], bool]) -> None:
        while not cond():
            self._wake.clear()
            if cond():
                break
            await self._wake.wait()

    def _check_usable(self) -> None:
        if self._closed:
            raise ConnectionError("broker session is closed")

    async def _ensure_ready(self) -> None:
        await self._wait_for_state(
            lambda: self._closed or self._connected.is_set()
        )
        self._check_usable()

    async def _run(self, op: Callable[[], Any]) -> Any:
        """Run an idempotent op, retrying across reconnects until it lands."""
        while True:
            await self._ensure_ready()
            try:
                return await op()
            except RECONNECT_EXCEPTIONS as exc:
                self._connection_lost(exc)

    # --- settle fencing ---------------------------------------------------
    def _wrap_handler(self, rec: _ConsumerRecord) -> MessageHandler:
        async def handler(inner_msg: DeliveredMessage) -> None:
            await rec.handler(self._fenced_message(inner_msg))

        return handler

    def _fenced_message(self, inner_msg: DeliveredMessage) -> DeliveredMessage:
        gen = self._generation

        async def settle(verb: str, requeue: bool) -> None:
            if self._closed or gen != self._generation:
                # Delivered over a connection that no longer exists: the
                # broker requeued it on disconnect, redelivery owns it now.
                self.session.fenced_settles += 1
                return
            t0 = time.perf_counter()
            try:
                if verb == "ack":
                    await inner_msg.ack()
                else:
                    await inner_msg.reject(requeue=requeue)
                _settle_hist.observe(time.perf_counter() - t0)
            except RECONNECT_EXCEPTIONS as exc:
                self.session.fenced_settles += 1
                self._connection_lost(exc)

        return DeliveredMessage(
            inner_msg.body,
            inner_msg.message_id,
            delivery_count=inner_msg.delivery_count,
            headers=inner_msg.headers,
            _settle=settle,
        )

    # --- Broker interface -------------------------------------------------
    async def declare_queue(
        self,
        name: str,
        *,
        durable: bool = True,
        ttl_ms: Optional[int] = None,
        max_redeliveries: Optional[int] = None,
    ) -> None:
        self._topology[name] = {
            "durable": durable,
            "ttl_ms": ttl_ms,
            "max_redeliveries": max_redeliveries,
        }
        await self._run(
            lambda: self.inner.declare_queue(
                name,
                durable=durable,
                ttl_ms=ttl_ms,
                max_redeliveries=max_redeliveries,
            )
        )

    async def publish(
        self,
        queue: str,
        body: bytes,
        *,
        message_id: Optional[str] = None,
        headers: Optional[Dict[str, Any]] = None,
    ) -> None:
        t0 = time.perf_counter()
        while True:
            self._check_usable()
            if self._connected.is_set():
                try:
                    await self.inner.publish(
                        queue, body, message_id=message_id, headers=headers
                    )
                    _publish_hist.observe(time.perf_counter() - t0)
                    return
                except RECONNECT_EXCEPTIONS as exc:
                    self._connection_lost(exc)
            if len(self._outbox) < self.outbox_limit:
                self._outbox.append(
                    _ParkedPublish(queue, body, message_id, headers)
                )
                self.session.outbox_parked += 1
                _publish_hist.observe(time.perf_counter() - t0)
                return
            # Outbox full: block until the flush drains it (or the session
            # comes back / closes) — this is how back-pressure survives outages.
            await self._wait_for_state(
                lambda: self._closed
                or self._connected.is_set()
                or len(self._outbox) < self.outbox_limit
            )

    async def consume(
        self, queue: str, handler: MessageHandler, *, prefetch: int = 1
    ) -> str:
        self._check_usable()
        self._tag_seq += 1
        tag = f"resilient-{self._tag_seq}"
        rec = _ConsumerRecord(tag, queue, handler, max(1, prefetch))
        self._consumers[tag] = rec
        if self._connected.is_set():
            try:
                rec.inner_tag = await self.inner.consume(
                    queue, self._wrap_handler(rec), prefetch=rec.prefetch
                )
            except RECONNECT_EXCEPTIONS as exc:
                # Recorded: the reconnect loop establishes it on the new
                # connection.
                self._connection_lost(exc)
        return tag

    async def cancel(self, consumer_tag: str, *, requeue: bool = True) -> None:
        rec = self._consumers.pop(consumer_tag, None)
        if rec is None or rec.inner_tag is None or not self._connected.is_set():
            return
        try:
            await self.inner.cancel(rec.inner_tag, requeue=requeue)
        except RECONNECT_EXCEPTIONS as exc:
            self._connection_lost(exc)

    async def get(self, queue: str) -> Optional[DeliveredMessage]:
        msg = await self._run(lambda: self.inner.get(queue))
        if msg is None:
            return None
        return self._fenced_message(msg)

    async def stats(self, queue: str) -> QueueStats:
        return await self._run(lambda: self.inner.stats(queue))

    async def purge(self, queue: str) -> int:
        return await self._run(lambda: self.inner.purge(queue))

    async def delete_queue(self, name: str) -> None:
        # Out of the recorded topology first, so a reconnect's replay does
        # not declare again a queue that is being retired.
        self._topology.pop(name, None)
        await self._run(lambda: self.inner.delete_queue(name))
