"""The port's ``tcp://`` broker against the JAX package's, both ways.

``llmq_tpu_torch.broker.tcp`` is a copy of ``llmq_tpu.broker.tcp`` on the
port's own broker core: the same frames on the wire, so the port's
client works against the reference daemon and the reference's client
against the port's daemon. Between the port's own client and daemon,
message bodies ride as raw bytes after the frame's JSON, which the
client asks for at its first ping. Each test runs its own event loop with the
server on a free local port (bound to port 0 and read back) and closes
every connection it opens.
"""

import asyncio
import json

import pytest

from llmq_tpu.broker import tcp as ref_tcp
from llmq_tpu_torch.broker import tcp as port_tcp
from llmq_tpu_torch.broker.base import make_broker

pytestmark = pytest.mark.unit

# (client module, server module)
DIRECTIONS = {
    "port-client-reference-server": (port_tcp, ref_tcp),
    "reference-client-port-server": (ref_tcp, port_tcp),
    "port-client-port-server": (port_tcp, port_tcp),
}


async def _server(module):
    srv = module.BrokerServer("127.0.0.1", 0)
    await srv.start()
    return srv, srv._server.sockets[0].getsockname()[1]


async def _client(module, port):
    client = module.TcpBroker(f"tcp://127.0.0.1:{port}")
    await client.connect()
    return client


async def _wait_for(cond, timeout=5.0):
    for _ in range(int(timeout / 0.01)):
        if cond():
            return
        await asyncio.sleep(0.01)
    raise AssertionError("timed out")


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_publish_consume_ack_stats_purge(direction):
    client_mod, server_mod = DIRECTIONS[direction]

    async def main():
        srv, port = await _server(server_mod)
        producer, consumer = await _client(client_mod, port), await _client(client_mod, port)
        try:
            await producer.declare_queue("q")
            for i in range(3):
                await producer.publish("q", f"job {i}".encode(), message_id=f"m{i}",
                                       headers={"n": i})
            await producer.publish("q", b"\xff\xfe raw bytes", message_id="bin")
            got = []

            async def handler(msg):
                got.append((msg.message_id, msg.body, msg.headers, msg.delivery_count))
                await msg.ack()

            tag = await consumer.consume("q", handler, prefetch=2)
            await _wait_for(lambda: len(got) == 4)
            await consumer.cancel(tag)
            assert sorted(got) == sorted(
                [(f"m{i}", f"job {i}".encode(), {"n": i}, 0) for i in range(3)]
                + [("bin", b"\xff\xfe raw bytes", {}, 0)])
            stats = await producer.stats("q")
            assert (stats.queue_name, stats.message_count, stats.message_count_unacknowledged) == (
                "q", 0, 0)
            for i in range(2):
                await producer.publish("q", b"left over")
            assert (await producer.stats("q")).message_count_ready == 2
            assert await producer.purge("q") == 2
            assert await producer.get("q") is None
        finally:
            await producer.close()
            await consumer.close()
            await srv.stop()

    asyncio.run(main())


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_redelivery_after_a_consumer_connection_dies(direction):
    """A consumer whose connection drops mid-job never acks: the server
    requeues the message, and the next consumer gets it as a redelivery."""
    client_mod, server_mod = DIRECTIONS[direction]

    async def main():
        srv, port = await _server(server_mod)
        producer = await _client(client_mod, port)
        first, second = await _client(client_mod, port), await _client(client_mod, port)
        try:
            await producer.publish("q", b"the job", message_id="j1")
            held, redelivered = [], []

            async def hold(msg):
                held.append(msg)  # never settled: the job is mid-flight

            async def take(msg):
                redelivered.append((msg.message_id, msg.body, msg.delivery_count))
                await msg.ack()

            await first.consume("q", hold)
            await _wait_for(lambda: held)
            assert (await producer.stats("q")).message_count_unacknowledged == 1
            first._writer.transport.abort()  # the consumer dies
            await second.consume("q", take)
            await _wait_for(lambda: redelivered)
            assert redelivered == [("j1", b"the job", 1)]
            assert (await producer.stats("q")).message_count == 0
        finally:
            for c in (producer, first, second):
                await c.close()
            await srv.stop()

    asyncio.run(main())


class _Sink:
    def __init__(self):
        self.data = b""

    def write(self, data):
        self.data += data


def test_write_frame_bytes_are_the_references():
    frame = {"op": "publish", "req_id": "r7", "queue": "jobs", "body": "héllo ✓",
             "headers": {"x": [1, 2.5, None, True]}, "message_id": None}
    ours, ref = _Sink(), _Sink()
    port_tcp.write_frame(ours, frame)
    ref_tcp.write_frame(ref, frame)
    assert ours.data == ref.data and ours.data[:4] == len(ours.data[4:]).to_bytes(4, "big")


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_bodies_ride_raw_only_between_two_port_ends(direction):
    """Only the port's daemon answers the port client's ``raw_body`` ping,
    and only then do bodies leave the JSON; either way every body (JSON
    text with quotes and escapes over a few MB, bytes that are not UTF-8,
    nothing) arrives as it left, by ``consume`` and by ``get``."""
    client_mod, server_mod = DIRECTIONS[direction]
    bodies = {"json": json.dumps({"say": 'a "quote" \\ and\n', "blob": "QUJD" * 800_000}).encode(),
              "binary": b"\xff\x00\x80 not UTF-8", "empty": b"", "text": "héllo ✓".encode()}

    async def main():
        srv, port = await _server(server_mod)
        producer, consumer = await _client(client_mod, port), await _client(client_mod, port)
        try:
            for mid, body in bodies.items():
                await producer.publish("q", body, message_id=mid)
            got = {}

            async def handler(msg):
                got[msg.message_id] = msg.body
                await msg.ack()

            tag = await consumer.consume("q", handler, prefetch=2)
            await _wait_for(lambda: len(got) == len(bodies))
            await consumer.cancel(tag)
            for mid, body in bodies.items():
                await producer.publish("g", body, message_id=mid)
            for _ in bodies:
                msg = await consumer.get("g")
                got["get-" + msg.message_id] = msg.body
                await msg.ack()
            raw = [getattr(c, "_raw", False) for c in (producer, consumer)]
            return got, raw
        finally:
            await producer.close()
            await consumer.close()
            await srv.stop()

    got, raw = asyncio.run(main())
    assert got == {**bodies, **{"get-" + k: v for k, v in bodies.items()}}
    assert raw == [direction == "port-client-port-server"] * 2


def test_a_raw_frame_reads_back_and_a_bad_one_is_refused():
    """A raw frame: the size word's top bit, the JSON's size, the JSON, the
    body; it reads back as the JSON with the body as bytes. A JSON size
    past the frame's end is a protocol error, as a frame too large is."""
    sink = _Sink()
    sink.writelines = lambda parts: [sink.write(bytes(p)) for p in parts]
    port_tcp.write_frame(sink, {"type": "deliver", "tag": "t1"}, b"\x00body", raw=True)
    frame = sink.data
    assert frame[0] & 0x80 and int.from_bytes(frame[:4], "big") & 0x7FFFFFFF == len(frame) - 4

    async def read(data):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await port_tcp.read_frame(reader)

    got = asyncio.run(read(frame))
    assert got == {"type": "deliver", "tag": "t1", "body": b"\x00body", "enc": "raw"}
    assert port_tcp.frame_body(got) == b"\x00body"
    bad = frame[:4] + (len(frame)).to_bytes(4, "big") + frame[8:]
    with pytest.raises(ValueError, match="overruns"):
        asyncio.run(read(bad))


def test_make_broker_takes_tcp_and_names_the_amqp_item():
    assert isinstance(make_broker("tcp://127.0.0.1:5999/"), port_tcp.TcpBroker)
    with pytest.raises(NotImplementedError, match="M6"):
        make_broker("amqp://guest@localhost/")
