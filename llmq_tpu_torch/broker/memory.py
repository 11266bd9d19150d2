"""In-process asyncio broker (port of ``llmq_tpu/broker/memory.py``).

``QueueCore``/``BrokerCore`` are the dispatch/ack/requeue/DLQ state
machine; ``MemoryBroker`` is its ``Broker`` facade.

Namespacing: ``memory://<ns>`` URLs sharing ``<ns>`` within one process share
queues — this is how integration tests run a submitter, worker, and receiver
against one broker in a single process (mirrors the reference's
test_integration.py pattern with a real RabbitMQ).
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Optional, Tuple

from llmq_tpu_torch.broker.base import (
    Broker,
    DeliveredMessage,
    MessageHandler,
    StoredMessage,
    new_message_id,
)
from llmq_tpu_torch.core.models import QueueStats
from llmq_tpu_torch.utils import clock
from llmq_tpu_torch.utils.aio import spawn

DEFAULT_MAX_REDELIVERIES = 3
FAILED_SUFFIX = ".failed"


@dataclass
class _Consumer:
    tag: str
    handler: MessageHandler
    prefetch: int
    in_flight: int = 0
    cancelled: bool = False


@dataclass
class QueueCore:
    """One queue's state machine: ready FIFO + unacked map + consumers."""

    name: str
    ttl_ms: Optional[int] = None
    max_redeliveries: int = DEFAULT_MAX_REDELIVERIES
    ready: Deque[StoredMessage] = field(default_factory=deque)
    unacked: Dict[str, Tuple[StoredMessage, _Consumer]] = field(default_factory=dict)
    consumers: Dict[str, _Consumer] = field(default_factory=dict)
    _rr: int = 0  # round-robin cursor over consumers

    def expired(self, msg: StoredMessage, now: float) -> bool:
        return self.ttl_ms is not None and (now - msg.enqueued_at) * 1000 > self.ttl_ms

    def pick_consumer(self) -> Optional[_Consumer]:
        live = [c for c in self.consumers.values() if not c.cancelled]
        if not live:
            return None
        for i in range(len(live)):
            c = live[(self._rr + i) % len(live)]
            if c.in_flight < c.prefetch:
                self._rr = (self._rr + i + 1) % len(live)
                return c
        return None

    def message_bytes(self) -> Tuple[int, int]:
        ready_b = sum(len(m.body) for m in self.ready)
        unacked_b = sum(len(m.body) for m, _ in self.unacked.values())
        return ready_b, unacked_b


class BrokerCore:
    """Shared queue registry + dispatch engine (used by memory and TCP).

    ``on_dead_letter``/``on_redeliver`` are sync hooks the TCP server uses to
    keep its journal consistent with in-memory state transitions that happen
    inside the core (dead-lettering, redelivery-count bumps).
    """

    def __init__(self) -> None:
        self.queues: Dict[str, QueueCore] = {}
        self.on_dead_letter: Optional[Callable[[str, StoredMessage], None]] = None
        self.on_redeliver: Optional[Callable[[str, StoredMessage], None]] = None
        # Exponential redelivery backoff (LLMQ_REDELIVERY_BACKOFF_S /
        # _MAX_S): a rejected message waits base * 2^(attempt-1) seconds
        # before going back to ready, so a crash-looping job stops
        # hammering workers at full rate. 0 = immediate (the default).
        # It lives here, in the core, so the tcp:// daemon honours it too.
        from llmq_tpu_torch.core.config import get_config

        cfg = get_config()
        self.redelivery_backoff_s = max(0.0, cfg.redelivery_backoff_s)
        self.redelivery_backoff_max_s = max(0.0, cfg.redelivery_backoff_max_s)
        self._dispatch_scheduled: set[str] = set()
        # Strong refs to in-flight handler tasks (the event loop holds only
        # weak ones); tasks remove themselves on completion via spawn().
        self.handler_tasks: set[asyncio.Task] = set()

    # --- queue management -------------------------------------------------
    def declare(
        self,
        name: str,
        *,
        ttl_ms: Optional[int] = None,
        max_redeliveries: Optional[int] = None,
    ) -> QueueCore:
        q = self.queues.get(name)
        if q is None:
            q = QueueCore(name=name)
            self.queues[name] = q
        if ttl_ms is not None:
            q.ttl_ms = ttl_ms
        if max_redeliveries is not None:
            q.max_redeliveries = max_redeliveries
        return q

    def _queue(self, name: str) -> QueueCore:
        # Auto-declare on use: publishing to an undeclared queue must not
        # lose the message (same forgiveness the default exchange gives).
        return self.declare(name)

    # --- publish/dispatch -------------------------------------------------
    def publish(
        self,
        queue: str,
        body: bytes,
        *,
        message_id: Optional[str] = None,
        headers: Optional[Dict[str, object]] = None,
        delivery_count: int = 0,
    ) -> None:
        q = self._queue(queue)
        q.ready.append(
            StoredMessage(
                body=body,
                message_id=message_id or new_message_id(),
                headers=dict(headers or {}),
                delivery_count=delivery_count,
            )
        )
        self._schedule_dispatch(queue)

    def _schedule_dispatch(self, queue: str) -> None:
        if queue in self._dispatch_scheduled:
            return
        self._dispatch_scheduled.add(queue)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._dispatch_scheduled.discard(queue)
            return
        loop.call_soon(self._dispatch, queue)

    def _dispatch(self, queue: str) -> None:
        self._dispatch_scheduled.discard(queue)
        q = self.queues.get(queue)
        if q is None:
            return
        now = clock.wall()
        while q.ready:
            if q.expired(q.ready[0], now):
                q.ready.popleft()
                continue
            consumer = q.pick_consumer()
            if consumer is None:
                return
            msg = q.ready.popleft()
            consumer.in_flight += 1
            q.unacked[msg.message_id] = (msg, consumer)
            delivered = DeliveredMessage(
                msg.body,
                msg.message_id,
                delivery_count=msg.delivery_count,
                headers=msg.headers,
                _settle=self._settler(queue, msg.message_id),
            )
            spawn(
                self._run_handler(consumer, delivered),
                registry=self.handler_tasks,
                name=f"dispatch:{queue}",
            )

    async def _run_handler(
        self, consumer: _Consumer, message: DeliveredMessage
    ) -> None:
        try:
            await consumer.handler(message)
        except Exception:  # noqa: BLE001 — handler bugs must not kill dispatch
            await message.reject(requeue=True)

    def _settler(self, queue: str, message_id: str):
        async def settle(verb: str, requeue: bool) -> None:
            self.settle(queue, message_id, verb, requeue)

        return settle

    def settle(self, queue: str, message_id: str, verb: str, requeue: bool) -> None:
        q = self.queues.get(queue)
        if q is None:
            return
        entry = q.unacked.pop(message_id, None)
        if entry is None:
            return
        msg, consumer = entry
        consumer.in_flight = max(0, consumer.in_flight - 1)
        if verb == "reject" and requeue:
            if queue.endswith(FAILED_SUFFIX):
                # DLQ peeks are non-destructive forever: requeue without a
                # redelivery-count penalty, never cascade-dead-letter.
                q.ready.appendleft(msg)
            else:
                msg.delivery_count += 1
                if msg.delivery_count > q.max_redeliveries:
                    self._dead_letter(queue, msg)
                else:
                    if self.on_redeliver is not None:
                        self.on_redeliver(queue, msg)
                    self._requeue(queue, msg)
        self._schedule_dispatch(queue)

    def _requeue(self, queue: str, msg: StoredMessage) -> None:
        """Return a rejected message to the ready FIFO — immediately, or
        after its exponential-backoff delay when redelivery backoff is
        configured (base * 2^(attempt-1), capped)."""
        q = self._queue(queue)
        delay = 0.0
        if self.redelivery_backoff_s > 0:
            delay = min(
                self.redelivery_backoff_s * 2 ** (msg.delivery_count - 1),
                self.redelivery_backoff_max_s,
            )
        if delay <= 0:
            q.ready.appendleft(msg)  # redelivery keeps rough ordering
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # no loop (teardown): don't lose the message
            q.ready.appendleft(msg)
            return

        def _release() -> None:
            held = self.queues.get(queue)
            if held is None:
                return
            held.ready.appendleft(msg)
            self._schedule_dispatch(queue)

        loop.call_later(delay, _release)

    def _dead_letter(self, queue: str, msg: StoredMessage) -> None:
        if self.on_dead_letter is not None:
            self.on_dead_letter(queue, msg)
        headers = dict(msg.headers)
        headers["x-death-queue"] = queue
        headers["x-delivery-count"] = msg.delivery_count
        self.publish(
            queue + FAILED_SUFFIX,
            msg.body,
            message_id=msg.message_id,
            headers=headers,
        )

    # --- consumers --------------------------------------------------------
    def add_consumer(
        self, queue: str, tag: str, handler: MessageHandler, prefetch: int
    ) -> None:
        q = self._queue(queue)
        q.consumers[tag] = _Consumer(tag=tag, handler=handler, prefetch=max(1, prefetch))
        self._schedule_dispatch(queue)

    def remove_consumer(self, tag: str, *, requeue_in_flight: bool = True) -> None:
        # list(): dead-lettering inside the loop may auto-declare a
        # '.failed' queue, and mutating self.queues mid-iteration raises.
        for q in list(self.queues.values()):
            consumer = q.consumers.pop(tag, None)
            if consumer is not None:
                consumer.cancelled = True
            if requeue_in_flight:
                # Simulate a consumer disconnect: its unacked messages go
                # back to ready (at-least-once), with a redelivery-count
                # bump so a job that crash-loops its workers eventually
                # dead-letters instead of looping forever. Also covers
                # transient `get` consumers not in q.consumers.
                stale = [
                    mid for mid, (_, c) in q.unacked.items() if c.tag == tag
                ]
                for mid in stale:
                    msg, _ = q.unacked.pop(mid)
                    msg.delivery_count += 1
                    if (
                        msg.delivery_count > q.max_redeliveries
                        and not q.name.endswith(FAILED_SUFFIX)
                    ):
                        self._dead_letter(q.name, msg)
                    else:
                        if self.on_redeliver is not None:
                            self.on_redeliver(q.name, msg)
                        self._requeue(q.name, msg)
                if stale:
                    self._schedule_dispatch(q.name)

    # --- single get (DLQ peek) -------------------------------------------
    def get_one(
        self, queue: str, *, tag: str = "__get__"
    ) -> Optional[DeliveredMessage]:
        q = self.queues.get(queue)
        if q is None or not q.ready:
            return None
        now = clock.wall()
        while q.ready:
            msg = q.ready.popleft()
            if q.expired(msg, now):
                continue
            tmp = _Consumer(tag=tag, handler=_noop_handler, prefetch=1)
            tmp.in_flight = 1
            q.unacked[msg.message_id] = (msg, tmp)
            return DeliveredMessage(
                msg.body,
                msg.message_id,
                delivery_count=msg.delivery_count,
                headers=msg.headers,
                _settle=self._settler(queue, msg.message_id),
            )
        return None

    # --- observability ----------------------------------------------------
    def stats(self, queue: str) -> QueueStats:
        q = self.queues.get(queue)
        if q is None:
            return QueueStats(queue_name=queue, stats_source="unavailable")
        ready_b, unacked_b = q.message_bytes()
        return QueueStats(
            queue_name=queue,
            message_count=len(q.ready) + len(q.unacked),
            message_count_ready=len(q.ready),
            message_count_unacknowledged=len(q.unacked),
            consumer_count=len([c for c in q.consumers.values() if not c.cancelled]),
            message_bytes=ready_b + unacked_b,
            message_bytes_ready=ready_b,
            message_bytes_unacknowledged=unacked_b,
            stats_source="broker_core",
        )

    def purge(self, queue: str) -> list:
        """Drop all ready messages; returns their ids (for journaling)."""
        q = self.queues.get(queue)
        if q is None:
            return []
        ids = [m.message_id for m in q.ready]
        q.ready.clear()
        return ids

    def delete(self, queue: str) -> list:
        """Unregister a queue outright, dropping whatever it still holds
        (ready AND unacked — callers drain/republish first). Returns the
        dropped message ids for journaling. Distinct from purge: the
        queue stops existing, so nothing can strand on it."""
        q = self.queues.pop(queue, None)
        if q is None:
            return []
        ids = [m.message_id for m in q.ready]
        ids.extend(q.unacked.keys())
        q.ready.clear()
        q.unacked.clear()
        q.consumers.clear()
        self._dispatch_scheduled.discard(queue)
        return ids


# Placeholder handler for get_one's transient consumer: the caller of get()
# owns settling the returned message, so this handler never runs it.
# llmq: ignore[settle-exhaustive]
async def _noop_handler(message: DeliveredMessage) -> None:
    return None


_NAMESPACES: Dict[str, BrokerCore] = {}


def get_namespace(ns: str) -> BrokerCore:
    core = _NAMESPACES.get(ns)
    if core is None:
        core = BrokerCore()
        _NAMESPACES[ns] = core
    return core


def reset_namespace(ns: str) -> None:
    """Drop a namespace entirely (test isolation)."""
    _NAMESPACES.pop(ns, None)


class MemoryBroker(Broker):
    """``memory://<ns>`` — Broker facade over a process-local BrokerCore."""

    def __init__(self, url: str = "memory://default") -> None:
        self.url = url
        ns = url.split("://", 1)[1] if "://" in url else url
        self.namespace = ns.strip("/") or "default"
        self._core: Optional[BrokerCore] = None
        self._tags: list[str] = []
        self._tag_seq = 0

    @property
    def core(self) -> BrokerCore:
        if self._core is None:
            raise RuntimeError("Broker is not connected")
        return self._core

    async def connect(self) -> None:
        self._core = get_namespace(self.namespace)

    async def close(self) -> None:
        if self._core is not None:
            for tag in self._tags:
                self._core.remove_consumer(tag)
            self._tags.clear()
        self._core = None

    async def declare_queue(
        self,
        name: str,
        *,
        durable: bool = True,
        ttl_ms: Optional[int] = None,
        max_redeliveries: Optional[int] = None,
    ) -> None:
        self.core.declare(name, ttl_ms=ttl_ms, max_redeliveries=max_redeliveries)

    async def publish(
        self,
        queue: str,
        body: bytes,
        *,
        message_id: Optional[str] = None,
        headers: Optional[Dict[str, object]] = None,
    ) -> None:
        self.core.publish(queue, body, message_id=message_id, headers=headers)

    async def consume(
        self, queue: str, handler: MessageHandler, *, prefetch: int = 1
    ) -> str:
        self._tag_seq += 1
        tag = f"{self.namespace}-ctag-{id(self)}-{self._tag_seq}"
        self.core.add_consumer(queue, tag, handler, prefetch)
        self._tags.append(tag)
        return tag

    async def cancel(self, consumer_tag: str, *, requeue: bool = True) -> None:
        # requeue=False is basic.cancel semantics: deliveries stop but
        # already-delivered unacked messages stay settleable — a draining
        # worker acks them after finishing (or after republishing a
        # resume snapshot), and requeueing them here would double-deliver
        # every in-flight job. The tag stays registered so close()
        # requeues whatever is STILL unacked when the connection goes
        # away.
        self.core.remove_consumer(consumer_tag, requeue_in_flight=requeue)

    async def get(self, queue: str) -> Optional[DeliveredMessage]:
        # Track gets under a per-connection tag so close() requeues any
        # message fetched but never settled — same at-least-once behavior
        # a dropped TCP/AMQP connection gives its unacked deliveries.
        tag = f"{self.namespace}-get-{id(self)}"
        if tag not in self._tags:
            self._tags.append(tag)
        return self.core.get_one(queue, tag=tag)

    async def stats(self, queue: str) -> QueueStats:
        return self.core.stats(queue)

    async def purge(self, queue: str) -> int:
        return len(self.core.purge(queue))

    async def delete_queue(self, name: str) -> None:
        self.core.delete(name)
