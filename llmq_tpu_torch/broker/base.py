"""Abstract broker interface + message envelope (port of
``llmq_tpu/broker/base.py``). The port ships ``memory://``
(``broker/memory.py``), ``file://`` (``broker/filebroker.py``), the
``tcp://`` daemon and client (``broker/tcp.py``) and the ``chaos+``
fault-injecting decorator over any of them (``broker/chaos.py``); the
AMQP client comes with a later slice (ROADMAP.md queue 1, M6).

Semantics contract (what every implementation must honor — mirrors what the
reference relies on from RabbitMQ, SURVEY.md §1 L0):

- **Durability**: published messages survive broker restart (for the
  implementations that have a persistence story) and consumer churn.
- **At-least-once**: a message is redelivered (to any consumer) if its
  consumer disconnects or rejects with ``requeue=True`` before ack.
- **Prefetch/QoS**: a consumer has at most ``prefetch`` unacked messages in
  flight; this is the back-pressure mechanism that feeds continuous batching.
- **Dead-lettering**: a message rejected-with-requeue more than
  ``max_redeliveries`` times is routed to ``<queue>.failed`` instead of being
  requeued forever (fixes the reference's retry-forever gap,
  workers/base.py:245).
- **TTL**: queues may declare a message TTL; expired messages are dropped at
  dispatch time.
"""

from __future__ import annotations

import abc
import asyncio
import base64
import json
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, Optional

from llmq_tpu_torch.core.models import QueueStats
from llmq_tpu_torch.utils import clock


def new_message_id() -> str:
    return uuid.uuid4().hex


def encode_body(body: bytes) -> Dict[str, Any]:
    """Encode a payload for a JSON envelope. Payloads are normally UTF-8
    JSON (Job/Result), but the Broker contract accepts arbitrary bytes —
    non-UTF-8 bodies ride as base64 with an ``enc`` marker."""
    try:
        return {"body": body.decode("utf-8")}
    except UnicodeDecodeError:
        return {"body": base64.b64encode(body).decode("ascii"), "enc": "b64"}


def decode_body(envelope: Dict[str, Any]) -> bytes:
    if envelope.get("enc") == "b64":
        return base64.b64decode(envelope["body"])
    return envelope["body"].encode("utf-8")


@dataclass
class StoredMessage:
    """Broker-side message record."""

    body: bytes
    message_id: str = field(default_factory=new_message_id)
    headers: Dict[str, Any] = field(default_factory=dict)
    delivery_count: int = 0
    # Wall stamp for TTL ages, read through the injectable clock.
    enqueued_at: float = field(default_factory=clock.wall)

    def to_json(self) -> str:
        return json.dumps(
            {
                **encode_body(self.body),
                "message_id": self.message_id,
                "headers": self.headers,
                "delivery_count": self.delivery_count,
                "enqueued_at": self.enqueued_at,
            }
        )

    @classmethod
    def from_json(cls, raw: str) -> "StoredMessage":
        d = json.loads(raw)
        return cls(
            body=decode_body(d),
            message_id=d["message_id"],
            headers=d.get("headers", {}),
            delivery_count=d.get("delivery_count", 0),
            enqueued_at=d.get("enqueued_at", clock.wall()),
        )


class DeliveredMessage:
    """A message as seen by a consumer; must be acked or rejected exactly once.

    ``redelivered``/``delivery_count`` let workers implement poison-message
    policies; the broker itself dead-letters past the redelivery cap.
    """

    def __init__(
        self,
        body: bytes,
        message_id: str,
        *,
        delivery_count: int = 0,
        headers: Optional[Dict[str, Any]] = None,
        _settle: Optional[Callable[[str, bool], Awaitable[None]]] = None,
    ) -> None:
        self.body = body
        self.message_id = message_id
        self.delivery_count = delivery_count
        self.headers = headers or {}
        self._settle = _settle
        self._settled = False

    @property
    def redelivered(self) -> bool:
        return self.delivery_count > 0

    async def ack(self) -> None:
        await self._do_settle("ack", False)

    async def reject(self, requeue: bool = False) -> None:
        await self._do_settle("reject", requeue)

    async def _do_settle(self, verb: str, requeue: bool) -> None:
        if self._settled:
            return
        self._settled = True
        if self._settle is not None:
            await self._settle(verb, requeue)


MessageHandler = Callable[[DeliveredMessage], Awaitable[None]]


class Broker(abc.ABC):
    """Transport-level broker API (one connection).

    Transports that can lose their connection (tcp, chaos) call
    ``_notify_connection_lost`` when it happens; a session layer installs
    the ``on_connection_lost`` callback to re-dial promptly instead of
    waiting for the next operation to fail. Implementations that cannot
    lose a connection (memory) never fire it.
    """

    #: Optional callback fired once per detected transport loss.
    on_connection_lost: Optional[Callable[[], None]] = None

    @property
    def is_connected(self) -> bool:
        """Best-effort transport liveness (True when unknowable)."""
        return True

    def _notify_connection_lost(self) -> None:
        cb = self.on_connection_lost
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — observer must not kill transport
                pass

    @abc.abstractmethod
    async def connect(self) -> None: ...

    @abc.abstractmethod
    async def close(self) -> None: ...

    @abc.abstractmethod
    async def declare_queue(
        self,
        name: str,
        *,
        durable: bool = True,
        ttl_ms: Optional[int] = None,
        max_redeliveries: Optional[int] = None,
    ) -> None: ...

    @abc.abstractmethod
    async def publish(
        self,
        queue: str,
        body: bytes,
        *,
        message_id: Optional[str] = None,
        headers: Optional[Dict[str, Any]] = None,
    ) -> None: ...

    @abc.abstractmethod
    async def consume(
        self, queue: str, handler: MessageHandler, *, prefetch: int = 1
    ) -> str:
        """Start consuming; returns a consumer tag for ``cancel``."""

    @abc.abstractmethod
    async def cancel(self, consumer_tag: str, *, requeue: bool = True) -> None:
        """Stop the consumer. ``requeue=True`` (default) returns its
        unacked deliveries to ready, like a consumer disconnect.
        ``requeue=False`` is basic.cancel semantics — deliveries stop but
        in-flight messages stay settleable, for drain-with-handoff where
        the worker acks each one after finishing or republishing it."""

    @abc.abstractmethod
    async def get(self, queue: str) -> Optional[DeliveredMessage]:
        """Fetch a single message without starting a consumer (DLQ peek)."""

    @abc.abstractmethod
    async def stats(self, queue: str) -> QueueStats: ...

    @abc.abstractmethod
    async def purge(self, queue: str) -> int: ...

    async def delete_queue(self, name: str) -> None:
        """Remove a queue outright (a retired worker's private queues, so
        nothing can strand on them). Callers drain / republish first; what
        is still there is dropped. This default purges, best-effort; the
        transports override it to unregister the queue itself."""
        try:
            await self.purge(name)
        except Exception:  # noqa: BLE001 — deletion is best-effort cleanup
            pass

    async def __aenter__(self) -> "Broker":
        await self.connect()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()


RESULTS_SUFFIX = ".results"
DECODE_SUFFIX = ".decode"
INTERACTIVE_SUFFIX = ".interactive"


def results_queue_name(queue: str) -> str:
    return queue if queue.endswith(RESULTS_SUFFIX) else queue + RESULTS_SUFFIX


def decode_queue_name(queue: str) -> str:
    """The shared decode-pool queue (``llmq_tpu/broker/manager.py:135``):
    prefill-role workers republish a prefill-complete job here, its
    snapshot under ``RESUME_FIELD``; decode-role workers consume it."""
    return queue + DECODE_SUFFIX


def interactive_queue_name(queue: str) -> str:
    """The queue's SLO fast lane (``manager.py:111``): jobs submitted as
    ``priority: interactive`` publish here; workers consume it beside the
    shared queue, so interactive work never waits behind a batch backlog
    at the broker."""
    return queue + INTERACTIVE_SUFFIX


async def connect_broker(url: str, *, retries: int = 5, base_delay: float = 1.0) -> Broker:
    """Open a broker connection for ``url``, retrying with exponential
    backoff (``llmq_tpu/broker/base.py:233``)."""
    broker = make_broker(url)
    last_exc: Optional[Exception] = None
    for attempt in range(retries):
        try:
            await broker.connect()
            return broker
        except Exception as exc:  # noqa: BLE001 — retrying any connect failure
            last_exc = exc
            if attempt < retries - 1:
                await asyncio.sleep(base_delay * (2**attempt))
    raise ConnectionError(
        f"Could not connect to broker at {url!r} after {retries} attempts") from last_exc


def make_broker(url: str) -> Broker:
    """Instantiate (without connecting) the implementation for a broker URL."""
    scheme = url.split("://", 1)[0].lower() if "://" in url else ""
    if scheme.startswith("chaos+"):
        from llmq_tpu_torch.broker.chaos import ChaosBroker

        return ChaosBroker(url)
    if scheme == "memory":
        from llmq_tpu_torch.broker.memory import MemoryBroker

        return MemoryBroker(url)
    if scheme == "file":
        from llmq_tpu_torch.broker.filebroker import FileBroker

        return FileBroker(url)
    if scheme == "tcp":
        from llmq_tpu_torch.broker.tcp import TcpBroker

        return TcpBroker(url)
    if scheme in ("amqp", "amqps"):
        raise NotImplementedError(
            f"{url!r}: the port has no AMQP client yet (ROADMAP.md queue 1, M6: it needs "
            "aio_pika, which the GPU machine does not have); use tcp:// against the "
            "llmq broker daemon"
        )
    raise ValueError(f"Unsupported broker URL scheme: {url!r} (the port ships memory://, "
                     "file://, tcp:// and a chaos+ prefix)")
