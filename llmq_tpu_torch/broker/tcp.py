"""TCP broker: a self-hosted broker daemon + asyncio client (port of
``llmq_tpu/broker/tcp.py``, the same wire protocol, so either side talks
to the other's daemon or client).

Plays the role RabbitMQ plays for the reference (external broker process all
workers/CLIs connect to — SURVEY.md §1 L0), with no external dependency:
``llmq-tpu broker serve`` (or this module's ``BrokerServer``) starts the
daemon, every other process points ``LLMQ_BROKER_URL=tcp://host:port`` at
it, port workers included.

Wire protocol — length-prefixed JSON frames (4-byte big-endian size + UTF-8
JSON). A message body rides in the JSON as text (base64 when it is not
UTF-8), or, between two ends that both read them, as raw bytes after the
JSON: the size word's top bit set, then the JSON's 4-byte size, the JSON
and the body. A client asks for raw bodies with ``raw_body`` on its
first ping; a server that reads them says ``raw_body`` back, and both
then send them (the reference's daemon and client ignore the key and
keep to JSON text, so either side still talks to the other's):

  client → server: {op, req_id, ...}   ops: declare publish consume cancel
                                            get settle stats purge ping
  server → client: {type:"reply", req_id, ok, ...}
                   {type:"deliver", queue, tag, message_id, body,
                    delivery_count, headers}

Delivery/settlement: the server tracks per-connection consumers; a dropped
connection requeues its unacked messages (at-least-once, like an AMQP channel
close). Durability: an append-only journal (publish/settle records) replayed
on startup, compacted when mostly settled.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
import uuid
from pathlib import Path
from typing import Any, Dict, Optional, Set

from llmq_tpu_torch.broker.base import (
    Broker,
    DeliveredMessage,
    MessageHandler,
    decode_body,
    encode_body,
    new_message_id,
)
from llmq_tpu_torch.broker.memory import BrokerCore
from llmq_tpu_torch.core.models import QueueStats
from llmq_tpu_torch.utils.aio import reap, reap_all, spawn

logger = logging.getLogger(__name__)

MAX_FRAME = 64 * 1024 * 1024
_HDR = struct.Struct(">I")
# The size word's top bit: the frame's body follows its JSON as raw bytes.
RAW_FLAG = 1 << 31
_RAW_ENC = "raw"  # a read frame's ``enc`` when its body came raw


async def read_frame(reader: asyncio.StreamReader) -> Optional[Dict[str, Any]]:
    try:
        hdr = await reader.readexactly(_HDR.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (size,) = _HDR.unpack(hdr)
    raw = bool(size & RAW_FLAG)
    size &= RAW_FLAG - 1
    if size > MAX_FRAME:
        raise ValueError(f"Frame too large: {size}")
    try:
        payload = await reader.readexactly(size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    if not raw:
        return json.loads(payload)
    (hlen,) = _HDR.unpack_from(payload)
    if _HDR.size + hlen > size:
        raise ValueError(f"Raw frame header overruns the frame: {hlen} of {size}")
    frame = json.loads(payload[_HDR.size:_HDR.size + hlen])
    frame.update(body=payload[_HDR.size + hlen:], enc=_RAW_ENC)
    return frame


def write_frame(writer: asyncio.StreamWriter, obj: Dict[str, Any],
                body: Optional[bytes] = None, raw: bool = False) -> None:
    """Write ``obj`` as one frame, with ``body`` (a message body) as raw
    bytes after the JSON when ``raw``, else inside it as text."""
    if body is not None and not raw:
        obj = {**obj, **encode_body(body)}
    header = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if body is None or not raw:
        writer.write(_HDR.pack(len(header)) + header)
        return
    writer.writelines([_HDR.pack(RAW_FLAG | (_HDR.size + len(header) + len(body))),
                       _HDR.pack(len(header)), header, body])


def frame_body(frame: Dict[str, Any]) -> bytes:
    """The message body a read frame carries, raw or as text."""
    return frame["body"] if frame.get("enc") == _RAW_ENC else decode_body(frame)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class BrokerServer:
    """The broker daemon: BrokerCore + TCP transport + journal durability."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 5672,
        *,
        persist_dir: Optional[str | os.PathLike] = None,
    ) -> None:
        self.host = host
        self.port = port
        self.core = BrokerCore()
        self.persist_dir = Path(persist_dir) if persist_dir else None
        self._journal_file = None
        self._journal_ops = 0
        self._server: Optional[asyncio.AbstractServer] = None
        # Live client connections; stop() closes them so a daemon restart
        # actually severs sessions (clients then requeue/reconnect).
        self._conn_writers: set = set()
        # (tag, message_id) -> unsettled DeliveredMessage awaiting client verdict
        self._pending_settles: Dict[tuple, DeliveredMessage] = {}
        # Journal consistency for state transitions that happen inside the core:
        self.core.on_dead_letter = self._journal_dead_letter
        self.core.on_redeliver = self._journal_redeliver

    # --- durability -------------------------------------------------------
    def _journal_path(self) -> Path:
        assert self.persist_dir is not None
        return self.persist_dir / "journal.jsonl"

    def _load_journal(self) -> None:
        """Replay the journal into the core. Live set is keyed by
        ``(queue, message_id)`` so a message's dead-letter copy (same id,
        ``.failed`` queue) is tracked independently of the original."""
        if self.persist_dir is None:
            return
        self.persist_dir.mkdir(parents=True, exist_ok=True)
        path = self._journal_path()
        if not path.exists():
            return
        live: Dict[tuple, Dict[str, Any]] = {}
        with path.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                op = rec.get("op")
                key = (rec.get("queue"), rec.get("message_id"))
                if op == "publish":
                    live[key] = rec
                elif op == "ack":
                    live.pop(key, None)
                elif op == "redeliver":
                    if key in live:
                        live[key]["delivery_count"] = (
                            live[key].get("delivery_count", 0) + 1
                        )
        for rec in live.values():
            self.core.publish(
                rec["queue"],
                decode_body(rec),
                message_id=rec["message_id"],
                headers=rec.get("headers", {}),
                delivery_count=rec.get("delivery_count", 0),
            )
        logger.info("Journal replay: %d live messages restored", len(live))
        self._compact_journal(live)

    def _compact_journal(self, live: Dict[tuple, Dict[str, Any]]) -> None:
        path = self._journal_path()
        tmp = path.with_suffix(".tmp")
        with tmp.open("w") as f:
            for rec in live.values():
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        tmp.replace(path)
        self._journal_ops = 0

    # Compact once this many ops accumulate past the last compaction.
    JOURNAL_COMPACT_EVERY = 100_000

    def _journal(self, rec: Dict[str, Any]) -> None:
        if self.persist_dir is None:
            return
        if self._journal_file is None:
            self._journal_file = self._journal_path().open("a")
        self._journal_file.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._journal_file.flush()
        self._journal_ops += 1
        if self._journal_ops >= self.JOURNAL_COMPACT_EVERY:
            self._compact_from_core()

    def _compact_from_core(self) -> None:
        """Rewrite the journal from live broker state (bounds journal growth
        on long-running daemons; cheap relative to 100k journal writes)."""
        if self.persist_dir is None:
            return
        live: Dict[tuple, Dict[str, Any]] = {}
        for qname, q in self.core.queues.items():
            for msg in list(q.ready) + [m for m, _ in q.unacked.values()]:
                live[(qname, msg.message_id)] = {
                    "op": "publish",
                    "queue": qname,
                    "message_id": msg.message_id,
                    **encode_body(msg.body),
                    "headers": msg.headers,
                    "delivery_count": msg.delivery_count,
                }
        if self._journal_file is not None:
            self._journal_file.close()
            self._journal_file = None
        self._compact_journal(live)
        logger.info("Journal compacted: %d live messages", len(live))

    def _journal_dead_letter(self, queue: str, msg) -> None:
        """Core moved ``msg`` from ``queue`` to ``queue.failed``: ack the
        original and journal the DLQ copy so restart state matches."""
        headers = dict(msg.headers)
        headers["x-death-queue"] = queue
        headers["x-delivery-count"] = msg.delivery_count
        self._journal({"op": "ack", "queue": queue, "message_id": msg.message_id})
        self._journal(
            {
                "op": "publish",
                "queue": queue + ".failed",
                "message_id": msg.message_id,
                **encode_body(msg.body),
                "headers": headers,
            }
        )

    def _journal_redeliver(self, queue: str, msg) -> None:
        self._journal(
            {"op": "redeliver", "queue": queue, "message_id": msg.message_id}
        )

    # --- lifecycle --------------------------------------------------------
    async def start(self) -> None:
        self._load_journal()
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port
        )
        addrs = ", ".join(str(s.getsockname()) for s in self._server.sockets)
        logger.info("llmq-tpu broker listening on %s", addrs)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for writer in list(self._conn_writers):
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass
        self._conn_writers.clear()
        if self._journal_file is not None:
            self._journal_file.close()
            self._journal_file = None

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # --- connection handling ----------------------------------------------
    async def _handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn_tags: list[str] = []
        self._conn_writers.add(writer)
        write_lock = asyncio.Lock()
        raw = False  # does the client read raw bodies (its ping said so)?

        async def send(obj: Dict[str, Any], body: Optional[bytes] = None) -> None:
            async with write_lock:
                write_frame(writer, obj, body, raw)
                await writer.drain()

        try:
            while True:
                try:
                    req = await read_frame(reader)
                except (ValueError, json.JSONDecodeError) as exc:
                    # Not our protocol (or corrupt frame): drop the connection.
                    logger.warning("Dropping connection on bad frame: %s", exc)
                    break
                if req is None:
                    break
                if req.get("op") == "ping" and req.get("raw_body"):
                    raw = True
                try:
                    await self._handle_request(req, send, conn_tags)
                except Exception as exc:  # noqa: BLE001 — reply, don't die
                    await send(
                        {
                            "type": "reply",
                            "req_id": req.get("req_id"),
                            "ok": False,
                            "error": f"{type(exc).__name__}: {exc}",
                        }
                    )
        finally:
            self._conn_writers.discard(writer)
            dead = set(conn_tags)
            for key in [k for k in self._pending_settles if k[0] in dead]:
                self._pending_settles.pop(key, None)
            for tag in conn_tags:
                self.core.remove_consumer(tag)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _handle_request(self, req, send, conn_tags) -> None:
        op = req.get("op")
        req_id = req.get("req_id")

        def reply(**kw) -> Dict[str, Any]:
            return {"type": "reply", "req_id": req_id, "ok": True, **kw}

        if op == "ping":
            await send(reply(**({"raw_body": True} if req.get("raw_body") else {})))
        elif op == "declare":
            self.core.declare(
                req["queue"],
                ttl_ms=req.get("ttl_ms"),
                max_redeliveries=req.get("max_redeliveries"),
            )
            await send(reply())
        elif op == "publish":
            message_id = req.get("message_id") or new_message_id()
            body = frame_body(req)
            if self.persist_dir is not None:
                self._journal(
                    {
                        "op": "publish",
                        "queue": req["queue"],
                        "message_id": message_id,
                        **encode_body(body),
                        "headers": req.get("headers", {}),
                    }
                )
            self.core.publish(
                req["queue"],
                body,
                message_id=message_id,
                headers=req.get("headers"),
            )
            await send(reply(message_id=message_id))
        elif op == "consume":
            tag = f"tcp-{uuid.uuid4().hex[:12]}"
            queue = req["queue"]

            async def deliver(message: DeliveredMessage) -> None:
                # Forward to the client; settlement comes back as a frame.
                self._pending_settles[(tag, message.message_id)] = (queue, message)
                try:
                    await send(
                        {
                            "type": "deliver",
                            "queue": queue,
                            "tag": tag,
                            "message_id": message.message_id,
                            "delivery_count": message.delivery_count,
                            "headers": message.headers,
                        },
                        message.body,
                    )
                except (ConnectionResetError, BrokenPipeError):
                    self._pending_settles.pop((tag, message.message_id), None)
                    await message.reject(requeue=True)

            self.core.add_consumer(queue, tag, deliver, req.get("prefetch", 1))
            conn_tags.append(tag)
            await send(reply(tag=tag))
        elif op == "cancel":
            tag = req["tag"]
            # requeue=False is basic.cancel: deliveries stop, but this
            # connection's unacked messages stay settleable (drain-with-
            # handoff acks them after republishing). The tag stays in
            # conn_tags so the disconnect cleanup requeues whatever is
            # still unacked at close.
            self.core.remove_consumer(
                tag, requeue_in_flight=bool(req.get("requeue", True))
            )
            await send(reply())
        elif op == "settle":
            key = (req["tag"], req["message_id"])
            entry = self._pending_settles.pop(key, None)
            if req["tag"].startswith("get-") and req["tag"] in conn_tags:
                conn_tags.remove(req["tag"])  # one-shot get consumer settled
            if entry is not None:
                queue, message = entry
                if req["verb"] == "ack":
                    self._journal(
                        {
                            "op": "ack",
                            "queue": queue,
                            "message_id": req["message_id"],
                        }
                    )
                    await message.ack()
                else:
                    requeue = req.get("requeue", False)
                    if not requeue:
                        self._journal(
                            {
                                "op": "ack",
                                "queue": queue,
                                "message_id": req["message_id"],
                            }
                        )
                    await message.reject(requeue=requeue)
            await send(reply())
        elif op == "get":
            tag = f"get-{uuid.uuid4().hex[:12]}"
            message = self.core.get_one(req["queue"], tag=tag)
            if message is None:
                await send(reply(empty=True))
            else:
                # Track like a consumer so a client disconnect requeues it.
                conn_tags.append(tag)
                self._pending_settles[(tag, message.message_id)] = (
                    req["queue"],
                    message,
                )
                await send(
                    reply(
                        empty=False,
                        tag=tag,
                        message_id=message.message_id,
                        delivery_count=message.delivery_count,
                        headers=message.headers,
                    ),
                    message.body,
                )
        elif op == "stats":
            await send(reply(stats=self.core.stats(req["queue"]).model_dump()))
        elif op == "purge":
            purged_ids = self.core.purge(req["queue"])
            for mid in purged_ids:
                self._journal(
                    {"op": "ack", "queue": req["queue"], "message_id": mid}
                )
            await send(reply(purged=len(purged_ids)))
        elif op == "delete":
            # Queue deletion drops ready AND unacked messages — journal an
            # ack per dropped id so a restart doesn't resurrect them onto
            # a queue that no longer exists.
            dropped_ids = self.core.delete(req["queue"])
            for mid in dropped_ids:
                self._journal(
                    {"op": "ack", "queue": req["queue"], "message_id": mid}
                )
            for key in [
                k
                for k, (q, _) in self._pending_settles.items()
                if q == req["queue"]
            ]:
                self._pending_settles.pop(key, None)
            await send(reply(deleted=len(dropped_ids)))
        else:
            await send(
                {"type": "reply", "req_id": req_id, "ok": False, "error": f"bad op {op!r}"}
            )


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class TcpBroker(Broker):
    """Client side: implements the Broker interface over one TCP connection."""

    def __init__(self, url: str) -> None:
        self.url = url
        rest = url.split("://", 1)[1]
        hostport = rest.split("/", 1)[0]
        host, _, port = hostport.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 5672)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._recv_task: Optional[asyncio.Task] = None
        self._replies: Dict[str, asyncio.Future] = {}
        self._handlers: Dict[str, MessageHandler] = {}
        # Deliveries can land before consume() has registered the handler
        # (the server starts dispatching the moment the consumer exists);
        # buffer them per-tag until the handler is in place.
        self._undispatched: Dict[str, list] = {}
        self._write_lock: Optional[asyncio.Lock] = None
        self._req_seq = 0
        self._lost = False
        self._raw = False  # the daemon reads and sends raw bodies
        # Strong refs to in-flight handler tasks: the loop only keeps weak
        # ones, so a naked ensure_future could be GC'd mid-delivery.
        self._handler_tasks: Set[asyncio.Task] = set()

    @property
    def is_connected(self) -> bool:
        return self._writer is not None and not self._lost

    async def connect(self) -> None:
        if self._writer is not None:
            return
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=MAX_FRAME
        )
        self._lost = False
        self._write_lock = asyncio.Lock()
        self._recv_task = asyncio.ensure_future(self._recv_loop())
        self._raw = False
        reply = await self._request({"op": "ping", "raw_body": True})
        self._raw = bool(reply.get("raw_body"))

    async def close(self) -> None:
        await reap(self._recv_task, label="tcp recv loop")
        self._recv_task = None
        try:
            # Unfinished deliveries are cancelled; the server requeues
            # anything unacked once the connection drops, so this is
            # loss-free. A handler that closes the connection itself (a
            # chaos kill on its own settle) is not reaped from inside: the
            # reference's close cancels it there, which aborts the close
            # with the socket open, and the next connect() then returns
            # early with no receive loop (ROADMAP.md queue 3 item 13).
            current = asyncio.current_task()
            await reap_all([t for t in self._handler_tasks if t is not current],
                           label="tcp handler task")
        finally:
            if self._writer is not None:
                self._writer.close()
                try:
                    await self._writer.wait_closed()
                except (ConnectionResetError, BrokenPipeError):
                    pass
            self._reader = self._writer = None
            self._handlers.clear()

    async def _recv_loop(self) -> None:
        reader = self._reader
        assert reader is not None
        while True:
            try:
                frame = await read_frame(reader)
            except (ValueError, json.JSONDecodeError) as exc:
                logger.error("Protocol error from broker: %s", exc)
                frame = None
            if frame is None:
                self._lost = True
                for fut in self._replies.values():
                    if not fut.done():
                        fut.set_exception(ConnectionError("broker connection lost"))
                self._replies.clear()
                self._notify_connection_lost()
                return
            ftype = frame.get("type")
            if ftype == "reply":
                fut = self._replies.pop(frame.get("req_id"), None)
                if fut is not None and not fut.done():
                    if frame.get("ok"):
                        fut.set_result(frame)
                    else:
                        fut.set_exception(
                            RuntimeError(frame.get("error", "broker error"))
                        )
            elif ftype == "deliver":
                tag = frame["tag"]
                handler = self._handlers.get(tag)
                if handler is not None:
                    message = self._delivered_from(frame)
                    spawn(
                        self._run_handler(handler, message),
                        registry=self._handler_tasks,
                        name=f"tcp-handler:{tag}",
                    )
                else:
                    self._undispatched.setdefault(tag, []).append(frame)

    async def _run_handler(
        self, handler: MessageHandler, message: DeliveredMessage
    ) -> None:
        try:
            await handler(message)
        except Exception:  # noqa: BLE001
            await message.reject(requeue=True)

    def _delivered_from(self, frame: Dict[str, Any]) -> DeliveredMessage:
        tag = frame["tag"]
        message_id = frame["message_id"]

        async def settle(verb: str, requeue: bool) -> None:
            try:
                await self._request(
                    {
                        "op": "settle",
                        "tag": tag,
                        "message_id": message_id,
                        "verb": verb,
                        "requeue": requeue,
                    }
                )
            except ConnectionError:
                pass  # server requeues in-flight messages on disconnect

        return DeliveredMessage(
            frame_body(frame),
            message_id,
            delivery_count=frame.get("delivery_count", 0),
            headers=frame.get("headers", {}),
            _settle=settle,
        )

    async def _request(self, obj: Dict[str, Any],
                       body: Optional[bytes] = None) -> Dict[str, Any]:
        if self._writer is None or self._write_lock is None or self._lost:
            raise ConnectionError("Broker is not connected")
        self._req_seq += 1
        req_id = f"r{self._req_seq}"
        obj = {**obj, "req_id": req_id}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._replies[req_id] = fut
        try:
            async with self._write_lock:
                write_frame(self._writer, obj, body, self._raw)
                await self._writer.drain()
        except OSError as exc:
            # Write-side detection: the recv loop may not have noticed yet.
            self._replies.pop(req_id, None)
            if not self._lost:
                self._lost = True
                self._notify_connection_lost()
            raise ConnectionError(f"broker connection lost: {exc}") from exc
        return await fut

    # --- Broker interface -------------------------------------------------
    async def declare_queue(
        self,
        name: str,
        *,
        durable: bool = True,
        ttl_ms: Optional[int] = None,
        max_redeliveries: Optional[int] = None,
    ) -> None:
        await self._request(
            {
                "op": "declare",
                "queue": name,
                "ttl_ms": ttl_ms,
                "max_redeliveries": max_redeliveries,
            }
        )

    async def publish(
        self,
        queue: str,
        body: bytes,
        *,
        message_id: Optional[str] = None,
        headers: Optional[Dict[str, Any]] = None,
    ) -> None:
        await self._request(
            {
                "op": "publish",
                "queue": queue,
                "message_id": message_id,
                "headers": headers or {},
            },
            body,
        )

    async def consume(
        self, queue: str, handler: MessageHandler, *, prefetch: int = 1
    ) -> str:
        reply = await self._request(
            {"op": "consume", "queue": queue, "prefetch": prefetch}
        )
        tag = reply["tag"]
        self._handlers[tag] = handler
        for frame in self._undispatched.pop(tag, []):
            message = self._delivered_from(frame)
            spawn(
                self._run_handler(handler, message),
                registry=self._handler_tasks,
                name=f"tcp-handler:{tag}",
            )
        return tag

    async def cancel(self, consumer_tag: str, *, requeue: bool = True) -> None:
        self._handlers.pop(consumer_tag, None)
        await self._request(
            {"op": "cancel", "tag": consumer_tag, "requeue": requeue}
        )

    async def get(self, queue: str) -> Optional[DeliveredMessage]:
        reply = await self._request({"op": "get", "queue": queue})
        if reply.get("empty"):
            return None
        return self._delivered_from(reply)

    async def stats(self, queue: str) -> QueueStats:
        reply = await self._request({"op": "stats", "queue": queue})
        return QueueStats(**reply["stats"])

    async def purge(self, queue: str) -> int:
        reply = await self._request({"op": "purge", "queue": queue})
        return int(reply.get("purged", 0))

    async def delete_queue(self, name: str) -> None:
        await self._request({"op": "delete", "queue": name})
