"""The port's broker sessions against the reference's: ``chaos+``,
``ResilientBroker`` and ``file://``.

- ``broker/chaos.py``: the same URL and seed inject the same connection
  kills (at the same operations) and the same duplicate deliveries as
  ``llmq_tpu/broker/chaos.py`` over a scripted run; the seed resolves
  the same way.
- ``broker/resilient.py``: one scripted outage (a transport loss, two
  failed re-dials, publishes parked in a bounded outbox, a settle of a
  message delivered before the loss) gives equal ``SessionStats`` and
  the same deliveries.
- ``broker/filebroker.py``: the same operations give the same stats and
  dead letters; the two packages read each other's directory; the
  janitor requeues the claims of an owner whose process is gone.
"""

import asyncio
import subprocess
import sys

import numpy as np
import pytest

from llmq_tpu.broker import chaos as jchaos
from llmq_tpu.broker import filebroker as jfile
from llmq_tpu.broker import memory as jmem
from llmq_tpu.broker import resilient as jres
from llmq_tpu_torch.broker import chaos as tchaos
from llmq_tpu_torch.broker import filebroker as tfile
from llmq_tpu_torch.broker import memory as tmem
from llmq_tpu_torch.broker import resilient as tres
from llmq_tpu_torch.broker.base import make_broker

pytestmark = pytest.mark.unit

PACKAGES = {
    "reference": (jchaos, jmem, jres, jfile),
    "port": (tchaos, tmem, tres, tfile),
}


def _both(fn, *args):
    """``fn(package modules, namespace, *args)`` for each package, each in
    a namespace of its own; returns (reference, port)."""
    out = []
    for name, mods in PACKAGES.items():
        ns = f"res-{name}-{fn.__name__}"
        try:
            out.append(asyncio.run(fn(mods, ns, *args)))
        finally:
            mods[1].reset_namespace(ns)
    return out


async def _kill_script(mods, ns, seed):
    """Publish / get / settle in a seeded mix, re-dialling after each kill:
    the op number and kind of every kill, and what the queue holds."""
    chaos = mods[0].ChaosBroker(f"chaos+memory://{ns}?kill_every=4&delay_ms=0.2&seed={seed}")
    await chaos.connect()
    await chaos.declare_queue("kq", max_redeliveries=2)
    kinds = np.random.default_rng(seed).integers(0, 3, 24)
    killed, held = [], []
    for i, kind in enumerate(kinds):
        try:
            if kind == 0 or not held and kind == 2:
                await chaos.publish("kq", f"m{i}".encode(), message_id=f"m{i}")
            elif kind == 1:
                msg = await chaos.get("kq")
                if msg is not None:
                    held.append(msg)
            else:
                await held.pop(0).reject(requeue=bool(i % 2))
        except ConnectionError as exc:
            killed.append((i, str(exc)))
            held.clear()  # the dead connection's deliveries went back
            await chaos.connect()
    stats = await chaos.stats("kq")
    failed = await chaos.stats("kq.failed")
    await chaos.close()
    return killed, chaos.kills, stats.message_count, failed.message_count


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_kills_land_on_the_same_operations(seed):
    want, got = _both(_kill_script, seed)
    assert got == want
    assert want[1] >= 3


async def _dup_script(mods, ns, seed):
    """A consumer behind ``dup_every=3``: every handler call (id, delivery
    count, whether its settle reaches the broker) in order."""
    feeder = mods[1].MemoryBroker(f"memory://{ns}")
    await feeder.connect()
    chaos = mods[0].ChaosBroker(f"chaos+memory://{ns}?dup_every=3&seed={seed}")
    await chaos.connect()
    calls = []

    async def handler(msg):
        calls.append((msg.message_id, msg.delivery_count, msg._settle is not None))
        await msg.ack()

    await chaos.consume("dq", handler, prefetch=1)
    for i in range(7):
        await feeder.publish("dq", b"x", message_id=f"d{i}")
    for _ in range(200):
        if len(calls) >= 9:
            break
        await asyncio.sleep(0.005)
    left = (await feeder.stats("dq")).message_count
    await chaos.close()
    await feeder.close()
    return calls, chaos.duplicates, left


def test_chaos_duplicates_the_same_deliveries():
    want, got = _both(_dup_script, 5)
    assert got == want
    assert want[1] == 2 and want[2] == 0 and len(want[0]) == 9


@pytest.mark.parametrize("url_seed,env_seed", [(42, "777"), (None, "9"), (None, None),
                                               (None, "nope")])
def test_chaos_seed_resolves_as_the_reference(monkeypatch, url_seed, env_seed):
    if env_seed is None:
        monkeypatch.delenv("LLMQ_CHAOS_SEED", raising=False)
    else:
        monkeypatch.setenv("LLMQ_CHAOS_SEED", env_seed)
    url = "chaos+memory://seeds?kill_every=2" + ("" if url_seed is None else f"&seed={url_seed}")
    assert tchaos.ChaosBroker(url).seed == jchaos.ChaosBroker(url).seed
    assert tchaos.resolve_chaos_seed(url_seed) == jchaos.resolve_chaos_seed(url_seed)
    assert isinstance(make_broker(url), tchaos.ChaosBroker)


def _flaky(mods, url):
    """The package's memory broker whose next ``fail`` dials fail."""

    class Flaky(mods[1].MemoryBroker):
        fail = 0
        dials = 0

        async def connect(self):
            self.dials += 1
            if self.fail:
                self.fail -= 1
                raise ConnectionError("broker down")
            await super().connect()

    return Flaky(url)


async def _outage_script(mods, ns):
    inner = _flaky(mods, f"memory://{ns}")
    session = mods[2].ResilientBroker(f"memory://{ns}", broker=inner, outbox_limit=3,
                                      reconnect_base_delay=0.005, reconnect_max_delay=0.01)
    await session.connect()
    await session.declare_queue("rq", ttl_ms=60_000, max_redeliveries=50)
    got, held = [], []

    async def handler(msg):
        got.append((msg.message_id, msg.delivery_count))
        if msg.message_id == "a0" and msg.delivery_count == 0:
            held.append(msg)  # settled after the outage: must fence
            return
        await msg.ack()

    await session.consume("rq", handler, prefetch=4)
    for i in range(2):
        await session.publish("rq", b"a", message_id=f"a{i}")
    await asyncio.sleep(0.02)
    inner.fail = 2
    await inner.close()
    inner._notify_connection_lost()
    assert not session.is_connected
    for i in range(3):  # parked: the outbox holds 3
        await session.publish("rq", b"b", message_id=f"b{i}")
    blocked = asyncio.ensure_future(session.publish("rq", b"c", message_id="c0"))
    await asyncio.wait_for(blocked, timeout=10)  # waits out the outage
    for _ in range(200):
        if session.is_connected and len(got) >= 6:
            break
        await asyncio.sleep(0.005)
    await held[0].ack()  # delivered on generation 0
    await asyncio.sleep(0.02)
    depth = (await session.stats("rq")).message_count
    stats = session.session.as_dict()
    await session.close()
    return stats, sorted(got), depth, inner.dials


def test_resilient_session_gives_the_reference_stats():
    """Re-dial with backoff, topology and consumer replay, the outbox's
    parks and in-order flush, back-pressure at its bound, and the fenced
    settle of a delivery from the dead connection."""
    want, got = _both(_outage_script)
    assert got == want
    stats = want[0]
    assert (stats["reconnects"], stats["disconnects"], stats["fenced_settles"]) == (1, 1, 1)
    assert stats["outbox_parked"] == 3 and stats["outbox_flushed"] == 3 and want[2] == 0


async def _file_script(mods, ns, root):
    """The same operations on a ``file://`` directory: rejections past a
    cap of 0 into ``.failed``, an expired message, an ack, a consume; the stats of
    each queue and the dead letters."""
    broker = mods[3].FileBroker(f"file://{root}")
    await broker.connect()
    await broker.declare_queue("fq", ttl_ms=60_000, max_redeliveries=0)
    await broker.declare_queue("tq", ttl_ms=1)
    await broker.publish("tq", b"old", message_id="t0")
    for i in range(4):
        await broker.publish("fq", f"p{i}".encode(), message_id=f"p{i}", headers={"n": i})
    for _ in range(2):
        msg = await broker.get("fq")
        await msg.reject(requeue=True)
    msg = await broker.get("fq")
    await msg.ack()
    await asyncio.sleep(0.01)
    expired = await broker.get("tq")
    seen = []

    async def handler(m):
        seen.append((m.message_id, m.delivery_count))
        await m.ack()

    tag = await broker.consume("fq", handler, prefetch=2)
    for _ in range(100):
        if seen:
            break
        await asyncio.sleep(0.01)
    await broker.cancel(tag)
    # Counts, not bytes: each file holds its own enqueue stamp.
    stats = {q: (await broker.stats(q)).model_dump(
        exclude={"queue_name", "message_bytes", "message_bytes_ready",
                 "message_bytes_unacknowledged"}) for q in ("fq", "fq.failed", "tq")}
    dead = []
    while (m := await broker.get("fq.failed")) is not None:
        dead.append((m.message_id, m.body, m.headers, m.delivery_count))
        await m.ack()
    await broker.close()
    return stats, dead, seen, expired


def test_file_broker_as_the_reference(tmp_path):
    want = asyncio.run(_file_script(PACKAGES["reference"], "f", tmp_path / "ref"))
    got = asyncio.run(_file_script(PACKAGES["port"], "f", tmp_path / "port"))
    assert got == want
    assert [(d[0], d[2]["x-delivery-count"]) for d in want[1]] == [("p0", 1), ("p1", 1)]
    assert want[3] is None and len(want[2]) == 1


def test_file_broker_reads_the_references_directory_and_reclaims_dead_claims(tmp_path):
    """A port process and a reference process share one directory; a
    claim whose owner process is gone goes back to ready with its
    delivery count bumped."""
    url = f"file://{tmp_path}"

    async def main():
        ref, port = jfile.FileBroker(url), tfile.FileBroker(url)
        for b in (ref, port):
            await b.connect()
        await ref.declare_queue("xq", max_redeliveries=5)
        await ref.publish("xq", b"from-ref", message_id="r0", headers={"h": 1})
        await port.publish("xq", b"from-port", message_id="p0")
        first = await port.get("xq")
        second = await ref.get("xq")
        got = sorted([(first.message_id, first.body, first.headers),
                      (second.message_id, second.body, second.headers)])
        await first.ack()
        await second.ack()
        # A claim left by a process that is gone.
        await ref.publish("xq", b"orphan", message_id="o0")
        dead = subprocess.Popen([sys.executable, "-c", "pass"])
        dead.wait()
        owner = tmp_path / "queues" / "xq" / "claimed" / f"{dead.pid}-deadbeef"
        owner.mkdir(parents=True)
        (name,) = [n for n in (tmp_path / "queues" / "xq" / "ready").iterdir()]
        name.rename(owner / name.name)
        assert await port.get("xq") is None  # claimed by the dead owner
        port._janitor("xq")
        back = await port.get("xq")
        reclaimed = (back.message_id, back.body, back.delivery_count)
        await back.ack()
        for b in (ref, port):
            await b.close()
        return got, reclaimed, list(owner.iterdir())

    got, reclaimed, left = asyncio.run(main())
    assert got == [("p0", b"from-port", {}), ("r0", b"from-ref", {"h": 1})]
    assert reclaimed == ("o0", b"orphan", 1) and left == []


def test_tcp_client_closed_from_its_own_handler_reconnects():
    """A delivery handler that closes its own connection (a chaos kill on
    its settle does) leaves the client closed, not half-closed: the next
    ``connect()`` dials a new connection with a receive loop, and requests
    get their replies (queue 3 item 13: the reference's close cancels
    the calling handler, keeps the old socket, and the next connect()
    returns early with no receive loop, so every later request waits
    forever)."""
    from llmq_tpu_torch.broker.tcp import BrokerServer, TcpBroker

    async def main():
        server = BrokerServer("127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        client = TcpBroker(f"tcp://127.0.0.1:{port}")
        await client.connect()
        closed = asyncio.Event()
        survived = []

        async def handler(msg):
            await client.close()
            survived.append(msg.message_id)  # the handler was not cancelled
            closed.set()

        await client.consume("hq", handler, prefetch=1)
        await client.publish("hq", b"x", message_id="h0")
        await asyncio.wait_for(closed.wait(), 5)
        await client.connect()
        await asyncio.wait_for(client.publish("hq", b"y", message_id="h1"), 5)
        stats = await asyncio.wait_for(client.stats("hq"), 5)
        await client.close()
        await server.stop()
        return survived, stats.message_count

    survived, depth = asyncio.run(main())
    # h0 went back when the connection dropped unacked; h1 is new.
    assert survived == ["h0"] and depth == 2
