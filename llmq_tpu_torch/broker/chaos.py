"""Deterministic fault injection for broker sessions: ``chaos+<scheme>://``
(port of ``llmq_tpu/broker/chaos.py``'s ``resolve_chaos_seed`` and
``ChaosBroker``: the same URL and seed inject the same kills and
duplicates at the same operations).

Proving the resilient session layer needs faults on demand, on CPU, in
tier-1 — not a RabbitMQ you can kick over. ``ChaosBroker`` decorates any
in-tree transport (``chaos+memory://ns``, ``chaos+tcp://host:port``) and
injects, from a **seeded** RNG and an operation counter so runs replay
identically:

- **connection kills** — every ``kill_every``-th client operation
  (publish / settle / get) closes the inner connection, raises
  ``ConnectionError``, and fires ``on_connection_lost``, exactly like a
  broker bounce. The underlying broker requeues in-flight messages, so
  at-least-once semantics stay observable.
- **publish/settle delays** — up to ``delay_ms`` of seeded-random latency
  per operation, widening the race windows reconnect code must survive.
- **duplicate deliveries** — every ``dup_every``-th delivery invokes the
  consumer handler a second time with a settle-less copy, exercising
  consumer-side idempotency (receivers dedup by job id).

URL query parameters: ``kill_every`` (0 = never), ``dup_every`` (0 = never),
``delay_ms`` (0 = none), ``seed``. Example::

    chaos+memory://testns?kill_every=37&dup_every=50&seed=11

Queue declarations and stats are exempt from kills so a reconnect's own
topology replay cannot re-kill the session it is rebuilding (that would
livelock the re-dial loop, which is not a fault real brokers exhibit).

The reference module's engine-side injectors (``WorkerKillSwitch``,
``DeviceFaultInjector``, ``BitFlipInjector``) hook the engine's dispatch,
not the broker; they come with the fault planes (ROADMAP.md queue 1, M12).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
from typing import Any, Dict, Optional
from urllib.parse import parse_qsl

from llmq_tpu_torch.broker.base import Broker, DeliveredMessage, MessageHandler
from llmq_tpu_torch.core.models import QueueStats

logger = logging.getLogger(__name__)


def resolve_chaos_seed(seed: Optional[int] = None) -> int:
    """Effective seed for a chaos scheme: an explicit value wins, else
    ``LLMQ_CHAOS_SEED``, else 0.

    Every scheme logs the value this returns at activation, so a failing
    chaos run in CI can always be replayed: grab the seed from the log,
    export ``LLMQ_CHAOS_SEED``, rerun.
    """
    if seed is not None:
        return int(seed)
    raw = os.environ.get("LLMQ_CHAOS_SEED", "").strip()
    if raw:
        try:
            return int(raw)
        except ValueError:
            logger.warning("ignoring non-integer LLMQ_CHAOS_SEED=%r", raw)
    return 0


class ChaosBroker(Broker):
    """Fault-injecting decorator over the transport named after ``chaos+``."""

    def __init__(self, url: str) -> None:
        if "://" not in url:
            raise ValueError(f"Invalid chaos broker URL: {url!r}")
        scheme, rest = url.split("://", 1)
        if "+" not in scheme:
            raise ValueError(
                f"Chaos URLs look like chaos+memory://... (got {url!r})"
            )
        inner_scheme = scheme.split("+", 1)[1]
        rest, _, query = rest.partition("?")
        params = dict(parse_qsl(query))
        self.url = url
        self.kill_every = int(params.get("kill_every", 0))
        self.dup_every = int(params.get("dup_every", 0))
        self.delay_ms = float(params.get("delay_ms", 0))
        raw_seed = params.get("seed")
        self.seed = resolve_chaos_seed(
            int(raw_seed) if raw_seed is not None else None
        )
        self._seed_logged = False
        from llmq_tpu_torch.broker.base import make_broker

        self.inner = make_broker(f"{inner_scheme}://{rest}")
        self._rng = random.Random(self.seed)
        self._ops = 0
        self._deliveries = 0
        self._dead = True  # until connect()
        self.kills = 0
        self.duplicates = 0

    # --- lifecycle --------------------------------------------------------
    @property
    def is_connected(self) -> bool:
        return not self._dead and self.inner.is_connected

    async def connect(self) -> None:
        await self.inner.connect()
        self.inner.on_connection_lost = self._notify_connection_lost
        self._dead = False
        if not self._seed_logged:
            # Once per session, not per reconnect: the seed is the replay
            # handle, and a kill-heavy run reconnects constantly.
            self._seed_logged = True
            logger.info(
                "chaos: broker active (seed=%d kill_every=%d dup_every=%d "
                "delay_ms=%g)",
                self.seed,
                self.kill_every,
                self.dup_every,
                self.delay_ms,
            )

    async def close(self) -> None:
        self._dead = True
        await self.inner.close()

    # --- fault engine -----------------------------------------------------
    def _check_alive(self) -> None:
        if self._dead:
            raise ConnectionError("chaos: connection is down")

    async def _chaos_op(self, kind: str) -> None:
        self._check_alive()
        self._ops += 1
        if self.delay_ms:
            await asyncio.sleep(self.delay_ms / 1000.0 * self._rng.random())
            self._check_alive()  # a kill may have landed during the delay
        if self.kill_every and self._ops % self.kill_every == 0:
            await self._kill(kind)

    async def _kill(self, kind: str) -> None:
        self._dead = True
        self.kills += 1
        logger.info("chaos: killing connection on %s (op #%d)", kind, self._ops)
        try:
            # Closing the inner transport is the fault: the broker side
            # requeues this connection's unacked messages (at-least-once).
            await self.inner.close()
        except Exception:  # noqa: BLE001 — the connection is dying anyway
            pass
        self._notify_connection_lost()
        raise ConnectionError(f"chaos: connection killed on {kind} (op #{self._ops})")

    def _wrap_message(self, msg: DeliveredMessage) -> DeliveredMessage:
        async def settle(verb: str, requeue: bool) -> None:
            await self._chaos_op("settle")
            if verb == "ack":
                await msg.ack()
            else:
                await msg.reject(requeue=requeue)

        return DeliveredMessage(
            msg.body,
            msg.message_id,
            delivery_count=msg.delivery_count,
            headers=msg.headers,
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
        self._check_alive()
        await self.inner.declare_queue(
            name,
            durable=durable,
            ttl_ms=ttl_ms,
            max_redeliveries=max_redeliveries,
        )

    async def publish(
        self,
        queue: str,
        body: bytes,
        *,
        message_id: Optional[str] = None,
        headers: Optional[Dict[str, Any]] = None,
    ) -> None:
        await self._chaos_op("publish")
        await self.inner.publish(
            queue, body, message_id=message_id, headers=headers
        )

    async def consume(
        self, queue: str, handler: MessageHandler, *, prefetch: int = 1
    ) -> str:
        self._check_alive()

        async def chaotic(msg: DeliveredMessage) -> None:
            self._deliveries += 1
            duplicate = bool(
                self.dup_every and self._deliveries % self.dup_every == 0
            )
            await handler(self._wrap_message(msg))
            if duplicate and not self._dead:
                self.duplicates += 1
                copy = DeliveredMessage(
                    msg.body,
                    msg.message_id,
                    delivery_count=msg.delivery_count + 1,
                    headers=msg.headers,
                    _settle=None,  # settles on the dup are no-ops
                )
                await handler(copy)

        return await self.inner.consume(queue, chaotic, prefetch=prefetch)

    async def cancel(self, consumer_tag: str, *, requeue: bool = True) -> None:
        self._check_alive()
        await self.inner.cancel(consumer_tag, requeue=requeue)

    async def get(self, queue: str) -> Optional[DeliveredMessage]:
        await self._chaos_op("get")
        msg = await self.inner.get(queue)
        if msg is None:
            return None
        return self._wrap_message(msg)

    async def stats(self, queue: str) -> QueueStats:
        self._check_alive()
        return await self.inner.stats(queue)

    async def purge(self, queue: str) -> int:
        self._check_alive()
        return await self.inner.purge(queue)

    async def delete_queue(self, name: str) -> None:
        # Exempt from kills, as declare is: deletion is topology cleanup on
        # a retirement or a reclaim, not a data-plane op worth injecting.
        self._check_alive()
        await self.inner.delete_queue(name)
