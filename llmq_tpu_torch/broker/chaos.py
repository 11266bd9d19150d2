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

The engine-side injectors (``PHASE_KINDS``, ``WorkerKillSwitch``,
``FAULT_MODES``, ``DeviceFaultInjector``, ``BitFlipInjector``: the
reference's :67-376) hook ``EngineCore.on_dispatch``, not the broker, and
draw their ``after`` counts from the same seeds as the reference's. Two
differences come from the card: ``DeviceFaultInjector`` raises the card's
errors (torch's "CUDA error: ..." and "CUDA out of memory" texts, which
``core/faults.py`` classifies as the reference's XLA texts are), and
``BitFlipInjector`` corrupts the weight or pool page *in place*, since a
captured CUDA graph reads the addresses it was captured on.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
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


#: Engine dispatch kinds (as reported to ``EngineCore.on_dispatch``) that
#: count toward each phase. "prefill" includes mixed dispatches: a mixed
#: step IS the piggybacked prompt's prefill.
PHASE_KINDS = {
    "prefill": ("prefill", "mixed"),
    "decode": ("decode_block",),
    "verify": ("verify",),
}


class WorkerKillSwitch:
    """Seeded worker-kill trigger for the crash-resume chaos legs: install
    as ``engine.on_dispatch``; after a seeded-random number of dispatches
    of ``phase`` it calls ``on_kill`` once (typically
    ``worker.request_shutdown``). Deterministic for (phase, seed,
    after_range)."""

    def __init__(self, phase: str, on_kill, *, seed: Optional[int] = None,
                 after_range=(1, 5)) -> None:
        if phase not in PHASE_KINDS:
            raise ValueError(f"unknown kill phase {phase!r}; one of {sorted(PHASE_KINDS)}")
        self.phase = phase
        self.kinds = PHASE_KINDS[phase]
        self.on_kill = on_kill
        self.seed = resolve_chaos_seed(seed)
        self.after = random.Random(self.seed).randint(*after_range)
        self.matched = 0
        self.fired = False
        logger.info("chaos: kill switch armed (phase=%s seed=%d after=%d)", self.phase,
                    self.seed, self.after)

    def __call__(self, kind: str) -> None:
        if self.fired or kind not in self.kinds:
            return
        self.matched += 1
        if self.matched >= self.after:
            self.fired = True
            logger.info("chaos: worker kill on %s dispatch #%d (phase=%s)", kind, self.matched,
                        self.phase)
            self.on_kill()


#: What each injectable device-fault mode does when it fires.
FAULT_MODES = ("hang", "xla_error", "oom")


class DeviceFaultInjector:
    """Seeded device-fault trigger: install as ``engine.on_dispatch`` (it
    runs on the engine thread, inside the dispatch's watchdog bracket).
    After a seeded-random number of dispatches of ``phase`` it fires once:

    - ``hang``: sleeps ``hang_s`` on the engine thread; the watchdog (whose
      deadline must be below ``hang_s``) trips, and the bracket raises
      ``HungDispatchError`` when the sleep returns;
    - ``xla_error``: raises a CUDA error (``xla_runtime_error``);
    - ``oom``: raises a CUDA out-of-memory error (``hbm_oom``), which
      drives the degradation ladder.
    """

    def __init__(self, phase: str, mode: str, *, seed: Optional[int] = None,
                 after_range=(1, 5), hang_s: float = 2.0) -> None:
        if phase not in PHASE_KINDS:
            raise ValueError(f"unknown fault phase {phase!r}; one of {sorted(PHASE_KINDS)}")
        if mode not in FAULT_MODES:
            raise ValueError(f"unknown fault mode {mode!r}; one of {sorted(FAULT_MODES)}")
        self.phase = phase
        self.kinds = PHASE_KINDS[phase]
        self.mode = mode
        self.hang_s = hang_s
        self.seed = resolve_chaos_seed(seed)
        self.after = random.Random(self.seed).randint(*after_range)
        self.matched = 0
        self.fired = False
        logger.info("chaos: fault injector armed (phase=%s mode=%s seed=%d after=%d)",
                    self.phase, self.mode, self.seed, self.after)

    def __call__(self, kind: str) -> None:
        if self.fired or kind not in self.kinds:
            return
        self.matched += 1
        if self.matched < self.after:
            return
        self.fired = True
        logger.info("chaos: injecting %s on %s dispatch #%d (phase=%s)", self.mode, kind,
                    self.matched, self.phase)
        if self.mode == "hang":
            time.sleep(self.hang_s)
            return  # the watchdog bracket raises HungDispatchError
        if self.mode == "oom":
            raise RuntimeError("INJECTED CUDA out of memory. Tried to allocate 2.00 GiB (chaos)")
        raise RuntimeError("INJECTED CUDA error: unspecified launch failure (chaos)")


#: What a BitFlipInjector can corrupt.
BITFLIP_TARGETS = ("weight", "kv", "logit")


class BitFlipInjector:
    """Seeded silent-data-corruption trigger: nothing raises when it fires.

    Targets: ``weight`` corrupts one element of a seeded-random parameter
    leaf of two or more dimensions (``leaf`` substring-filters them, by
    their ``keystr`` names, ``engine/integrity.py::named_leaves``);
    ``logit`` the same pinned to the logit projection (``lm_head``, else
    ``embed`` for tied embeddings), so the next dispatch's logits show it;
    ``kv`` overwrites page ``page`` of the K pool. Modes: ``nan`` plants a
    NaN (float leaves), ``flip`` a *finite* wrong value (silent to the
    guard's non-finite lane: the weight audit or the canary must catch
    it); integer leaves always bit-flip. Each write is in place.

    Attach with :meth:`bind` (sets ``core.on_dispatch``); it fires once
    after a seeded-random number of dispatches. A ``sticky`` injector
    re-arms on every bind: bound to each rebuilt core, the corruption
    recurs (the poison verdict); non-sticky is the transient (the rebuilt
    core has pristine weights)."""

    def __init__(self, target: str, *, mode: str = "nan", seed: Optional[int] = None,
                 after_range=(1, 5), sticky: bool = False, leaf: Optional[str] = None,
                 page: int = 1) -> None:
        if target not in BITFLIP_TARGETS:
            raise ValueError(f"unknown bitflip target {target!r}; "
                             f"one of {sorted(BITFLIP_TARGETS)}")
        if mode not in ("nan", "flip"):
            raise ValueError(f"unknown bitflip mode {mode!r}")
        self.target = target
        self.mode = mode
        self.sticky = sticky
        self.leaf = leaf
        self.page = page
        self.seed = resolve_chaos_seed(seed)
        self._rng = random.Random(self.seed)
        self.after = self._rng.randint(*after_range)
        logger.info("chaos: bit-flip injector armed (target=%s mode=%s seed=%d after=%d "
                    "sticky=%s)", self.target, self.mode, self.seed, self.after, self.sticky)
        self.matched = 0
        self.fired = 0
        self.corrupted: list = []  # one entry a firing
        self._core = None
        self._armed = True

    def bind(self, core) -> "BitFlipInjector":
        """Install on an EngineCore; a sticky injector re-arms."""
        self._core = core
        core.on_dispatch = self
        if self.sticky:
            self._armed = True
            self.matched = 0
        return self

    def __call__(self, kind: str) -> None:
        if not self._armed or self._core is None:
            return
        self.matched += 1
        if self.matched < self.after:
            return
        self._armed = False
        self.fired += 1
        logger.info("chaos: bit-flip (%s/%s) on %s dispatch #%d", self.target, self.mode, kind,
                    self.matched)
        if self.target == "kv":
            self._corrupt_kv()
        else:
            self._corrupt_param()

    # --- corruption (engine thread, like a real flip) ----------------------
    def _corrupt_kv(self) -> None:
        import torch

        pool = self._core.k_pages
        with torch.no_grad():
            pool[:, self.page] = float("nan") if self.mode == "nan" else 7.0
        self.corrupted.append(f"k:page{self.page}")

    def _corrupt_param(self) -> None:
        import torch

        from llmq_tpu_torch.engine.integrity import named_leaves

        leaves = list(named_leaves(self._core.params))
        want = self.leaf
        if want is None and self.target == "logit":
            want = "lm_head" if any("lm_head" in n for n, _ in leaves) else "embed"
        cands = sorted(((name, t) for name, t in leaves
                        if t.dim() >= 2 and (want is None or want in name)),
                       key=lambda c: c[0])
        if not cands:
            raise ValueError(f"no corruptible leaf matches {want!r}")
        name, t = cands[self._rng.randrange(len(cands))]
        idx = (0,) * t.dim()
        with torch.no_grad():
            if t.is_floating_point():
                if self.mode == "nan":
                    t[idx] = float("nan")
                else:
                    # A finite wrong value the non-finite lane cannot see.
                    t[idx] = torch.tensor(-1.0, dtype=t.dtype, device=t.device) - t[idx] * 3
            else:
                t[idx] = t[idx] ^ 0x55
        self.corrupted.append(name)


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
