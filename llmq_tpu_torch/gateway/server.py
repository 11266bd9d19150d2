"""OpenAI-compatible HTTP/SSE serving gateway over the queue broker (the
port's copy of ``llmq_tpu/gateway/server.py``).

The gateway is the online-serving front door: it accepts
``/v1/completions`` and ``/v1/chat/completions`` requests, publishes them
into the broker as ordinary :class:`~llmq_tpu_torch.core.models.Job`\\ s (class
``interactive`` by default, so they ride the fast lane), and answers from
two sources:

- **token-delta stream frames** on ``<q>.stream.<job_id>`` (published by
  the worker while decoding) drive the SSE path — each frame carries an
  absolute ``text_offset`` so redelivered / resumed-on-peer frames dedup
  against the character high-water mark already sent to the client;
- the **final Result** on ``<q>.results`` settles every request (and
  reconciles the SSE tail when the terminal ``done`` frame was lost).

Client disconnect mid-stream publishes ``{"cancel": job_id}`` to the
serving worker's ctl queue (``<q>.ctl.<worker_id>``, worker id learned
from the first stream frame) so the engine frees the request's KV pages
instead of decoding for a dead socket. Two departures from the reference
(ROADMAP.md queue 3 item 21), so that a stream whose tokens have no text
yet (special tokens, a character split across tokens) can be cancelled
and shows its first token: the first frame is forwarded as an SSE chunk
even when its text is empty (the port's worker publishes it at the first
token), and while no frame comes the handler checks every
``_FRAME_IDLE_TIMEOUT_S`` whether the client closed its end, instead of
learning it only from a failed write. And the server listens with a
backlog of 128, not ``socketserver``'s 5 (item 22).

Transport follows ``obs/exporter.py``: stdlib ``ThreadingHTTPServer`` on
a daemon thread, no third-party HTTP dependency (and no torch: the
gateway runs on any host that reaches the broker). The broker connection
lives on a private asyncio loop thread; HTTP handler threads talk to it
via ``asyncio.run_coroutine_threadsafe``.

The gateway assumes it owns its queue's results stream (one logical
receiver — the normal serving topology). Results that match no pending
request are acked and counted (``orphan_results``), not requeued.
"""

from __future__ import annotations

import asyncio
import json
import logging
import queue as thread_queue
import select
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from llmq_tpu_torch.broker.manager import (
    BrokerManager,
    ctl_queue_name,
    stream_queue_name,
)
from llmq_tpu_torch.core.config import Config, get_config
from llmq_tpu_torch.core.models import JOB_PRIORITIES, Job, Result
from llmq_tpu_torch.utils.aio import reap_all, spawn

logger = logging.getLogger(__name__)

# Sampling / shaping fields forwarded verbatim from the request body into
# the job payload (everything else client-supplied is dropped, so a
# request can't smuggle broker-internal fields like deadline_at).
_FORWARDED_FIELDS = (
    "max_tokens",
    "temperature",
    "top_p",
    "top_k",
    "min_p",
    "stop",
    "seed",
    "deadline_ms",
)

_STREAM_POLL_S = 0.02  # frame poll cadence on the loop thread
# Handler-side wait per frames.get() round; between frames, the check for a
# client that left runs this often.
_FRAME_IDLE_TIMEOUT_S = 0.25


class _GatewayHTTPServer(ThreadingHTTPServer):
    """The HTTP server with a listen backlog for a burst of clients:
    ``socketserver``'s default of 5 drops the SYNs of a burst past it, and
    those clients wait out a retransmit (1 s, then 3 s) before their
    request is even read (ROADMAP.md queue 3 item 22)."""

    request_queue_size = 128


class _Pending:
    """Gateway-side state of one in-flight request (thread-shared)."""

    def __init__(self, job_id: str, streaming: bool) -> None:
        self.job_id = job_id
        self.streaming = streaming
        # Settled by the results consumer (gateway loop thread), awaited
        # by the HTTP handler thread.
        self.result_future: "thread_queue.Queue[Result]" = thread_queue.Queue(
            maxsize=1
        )
        self.result: Optional[Result] = None
        # Stream frames, pumped loop-thread -> handler thread. ``None``
        # is the pump's "no more frames are coming" sentinel.
        self.frames: "thread_queue.Queue[Optional[Dict[str, Any]]]" = (
            thread_queue.Queue()
        )
        self.worker_id: Optional[str] = None
        self.done = threading.Event()  # result arrived (either path)

    def settle(self, result: Result) -> None:
        self.result = result
        self.done.set()
        try:
            self.result_future.put_nowait(result)
        except thread_queue.Full:  # duplicate result delivery
            pass


class ServingGateway:
    """HTTP/SSE front-end bound to one broker queue.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    readable from :attr:`port` after :meth:`start`.
    """

    def __init__(
        self,
        queue: str,
        *,
        config: Optional[Config] = None,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        model_name: str = "llmq-tpu",
        request_timeout_s: float = 600.0,
        default_priority: str = "interactive",
    ) -> None:
        self.queue = queue
        self.config = config or get_config()
        self.host = host
        self._port = self.config.serve_port if port is None else port
        self.model_name = model_name
        self.request_timeout_s = request_timeout_s
        if default_priority not in JOB_PRIORITIES:
            raise ValueError(f"default_priority must be one of {JOB_PRIORITIES}")
        self.default_priority = default_priority

        self.mgr: Optional[BrokerManager] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._loop_ready = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._results_tag: Optional[str] = None
        self._pump_tasks: set = set()
        self._pending: Dict[str, _Pending] = {}
        self._lock = threading.Lock()
        self._stopped = False
        self._owns_loop = False

        # Counters (superset-only observability; read by tests/probes).
        self.requests_total = 0
        self.requests_streamed = 0
        self.cancels_sent = 0
        self.orphan_results = 0

    # --- lifecycle --------------------------------------------------------
    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.server_address[1]
        return self._port

    def start(self) -> None:
        """Connect the broker, start the results consumer and HTTP server.

        Spawns a private asyncio loop thread for the broker side — the
        standalone ``python -m llmq_tpu_torch serve`` entry point.
        """
        self._owns_loop = True
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="gateway-loop", daemon=True
        )
        self._loop_thread.start()
        self._loop_ready.wait(timeout=10.0)
        if self.loop is None:
            raise RuntimeError("gateway loop failed to start")
        fut = asyncio.run_coroutine_threadsafe(self._async_start(), self.loop)
        fut.result(timeout=30.0)
        self._start_http()

    async def astart(self) -> None:
        """Start against the CALLER's running loop (in-process tests).

        The memory broker's core is loop-affine — every coroutine that
        touches it must run on the same loop as the workers under test —
        so here only the HTTP server gets threads; the broker side shares
        the caller's loop via ``run_coroutine_threadsafe``.
        """
        self._owns_loop = False
        self.loop = asyncio.get_running_loop()
        await self._async_start()
        self._start_http()

    def _start_http(self) -> None:
        handler = type(
            "_BoundGatewayHandler", (_GatewayHandler,), {"gateway": self}
        )
        self._server = _GatewayHTTPServer((self.host, self._port), handler)
        self._server.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._server.serve_forever,
            name="gateway-http",
            daemon=True,
        )
        self._http_thread.start()
        logger.info(
            "Serving gateway for queue %r on http://%s:%d",
            self.queue,
            self.host,
            self.port,
        )

    def stop(self) -> None:
        self._stopped = True
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self.loop is not None:
            fut = asyncio.run_coroutine_threadsafe(self._async_stop(), self.loop)
            try:
                fut.result(timeout=10.0)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                logger.debug("gateway async stop failed", exc_info=True)
            if self._owns_loop:
                self.loop.call_soon_threadsafe(self.loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5.0)
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)

    async def astop(self) -> None:
        """Counterpart of :meth:`astart` — callable from the shared loop."""
        self._stopped = True
        if self._server is not None:
            await asyncio.to_thread(self._server.shutdown)
            self._server.server_close()
        await self._async_stop()
        if self._http_thread is not None:
            await asyncio.to_thread(self._http_thread.join, 5.0)

    def __enter__(self) -> "ServingGateway":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self.loop = loop
        self._loop_ready.set()
        try:
            loop.run_forever()
        finally:
            loop.close()

    async def _async_start(self) -> None:
        self.mgr = BrokerManager(self.config)
        await self.mgr.connect()
        await self.mgr.setup_queue_infrastructure(self.queue)
        self._results_tag = await self.mgr.consume_results(
            self.queue, self._on_result
        )

    async def _async_stop(self) -> None:
        await reap_all(self._pump_tasks, label="gateway stream pump")
        if self.mgr is not None:
            if self._results_tag is not None:
                try:
                    await self.mgr.cancel(self._results_tag)
                except Exception:  # noqa: BLE001
                    logger.debug("results consumer cancel failed", exc_info=True)
            await self.mgr.disconnect()

    # --- results ----------------------------------------------------------
    async def _on_result(self, message: Any) -> None:
        try:
            result = Result.model_validate_json(message.body.decode("utf-8"))
        except Exception:  # noqa: BLE001 — malformed result: drop, not requeue
            logger.warning("gateway: undecodable result dropped", exc_info=True)
            await message.ack()
            return
        with self._lock:
            pending = self._pending.get(result.id)
        if pending is None:
            # Not ours (gateway restart, stray submitter): the gateway owns
            # its queue's results stream, so drop-and-count beats requeue
            # (which would spin the consumer forever).
            self.orphan_results += 1
        else:
            pending.settle(result)
        await message.ack()

    # --- submit / stream / cancel (gateway loop thread) -------------------
    async def _submit(self, payload: Dict[str, Any], pending: _Pending) -> None:
        job = Job(**payload)
        if pending.streaming:
            sq = stream_queue_name(self.queue, job.id)
            # Declare before publish so the pump's get() never races the
            # worker's own declare. Same params as the worker side.
            await self.mgr.broker.declare_queue(
                sq, ttl_ms=60_000, max_redeliveries=1_000_000_000
            )
            spawn(
                self._pump_stream(sq, pending),
                registry=self._pump_tasks,
                name=f"stream-pump-{job.id}",
            )
        await self.mgr.publish_job(self.queue, job)

    async def _pump_stream(self, sq: str, pending: _Pending) -> None:
        """Move stream frames broker -> handler thread until the terminal
        ``done`` frame, the final Result, or gateway shutdown."""
        deadline = time.monotonic() + self.request_timeout_s
        try:
            while not self._stopped and time.monotonic() < deadline:
                msg = await self.mgr.broker.get(sq)
                if msg is None:
                    if pending.done.is_set():
                        break  # result landed; no more frames coming
                    await asyncio.sleep(_STREAM_POLL_S)
                    continue
                await msg.ack()
                try:
                    frame = json.loads(msg.body.decode("utf-8"))
                except json.JSONDecodeError:
                    continue
                if frame.get("worker_id"):
                    pending.worker_id = str(frame["worker_id"])
                pending.frames.put(frame)
                if frame.get("done"):
                    return
        except Exception:  # noqa: BLE001 — pump death must not hang the client
            logger.debug("stream pump for %s died", pending.job_id, exc_info=True)
        finally:
            pending.frames.put(None)  # wake the handler: no more frames

    async def _cancel(self, job_id: str, worker_id: Optional[str]) -> None:
        """Client went away: tell the serving worker to drop the request."""
        if worker_id is None:
            return  # no frame seen yet — nothing addressable to cancel
        ctl = ctl_queue_name(self.queue, worker_id)
        try:
            await self.mgr.broker.declare_queue(
                ctl, ttl_ms=30_000, max_redeliveries=1
            )
            await self.mgr.broker.publish(
                ctl,
                json.dumps({"cancel": job_id}).encode("utf-8"),
                message_id=f"{job_id}.cancel",
            )
            self.cancels_sent += 1
        except Exception:  # noqa: BLE001 — cancel is best-effort
            logger.debug("cancel publish for %s failed", job_id, exc_info=True)

    # --- request registry -------------------------------------------------
    def register(self, pending: _Pending) -> None:
        with self._lock:
            self._pending[pending.job_id] = pending

    def unregister(self, job_id: str) -> None:
        with self._lock:
            self._pending.pop(job_id, None)

    def run_async(self, coro: Any, timeout: float = 10.0) -> Any:
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout=timeout
        )


class _GatewayHandler(BaseHTTPRequestHandler):
    """One HTTP request. ``gateway`` is bound per-server via a subclass."""

    gateway: ServingGateway
    protocol_version = "HTTP/1.1"

    # --- plumbing ---------------------------------------------------------
    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("gateway http: " + fmt, *args)

    def _send_json(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._send_json(
            code, {"error": {"message": message, "type": "invalid_request_error"}}
        )

    # --- routes -----------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/healthz":
            self._send_json(
                200, {"ok": True, "queue": self.gateway.queue}
            )
        elif self.path == "/v1/models":
            self._send_json(
                200,
                {
                    "object": "list",
                    "data": [
                        {
                            "id": self.gateway.model_name,
                            "object": "model",
                            "owned_by": "llmq-tpu",
                        }
                    ],
                },
            )
        else:
            self._error(404, f"no route for {self.path}")

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/v1/completions":
            self._handle_generate(chat=False)
        elif self.path == "/v1/chat/completions":
            self._handle_generate(chat=True)
        else:
            self._error(404, f"no route for {self.path}")

    # --- generation -------------------------------------------------------
    def _read_body(self) -> Optional[Dict[str, Any]]:
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length > 0 else b""
            body = json.loads(raw.decode("utf-8")) if raw else {}
        except (ValueError, json.JSONDecodeError):
            self._error(400, "request body must be JSON")
            return None
        if not isinstance(body, dict):
            self._error(400, "request body must be a JSON object")
            return None
        return body

    def _build_payload(
        self, body: Dict[str, Any], chat: bool
    ) -> Optional[Dict[str, Any]]:
        payload: Dict[str, Any] = {"id": f"gw-{uuid.uuid4().hex}"}
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                self._error(400, "'messages' must be a non-empty list")
                return None
            payload["messages"] = messages
        else:
            prompt = body.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                self._error(400, "'prompt' must be a non-empty string")
                return None
            payload["prompt"] = prompt
        priority = body.get("priority", self.gateway.default_priority)
        if priority not in JOB_PRIORITIES:
            self._error(400, f"'priority' must be one of {JOB_PRIORITIES}")
            return None
        payload["priority"] = priority
        for key in _FORWARDED_FIELDS:
            if key in body and body[key] is not None:
                payload[key] = body[key]
        return payload

    def _handle_generate(self, chat: bool) -> None:
        gw = self.gateway
        body = self._read_body()
        if body is None:
            return
        stream = bool(body.get("stream"))
        payload = self._build_payload(body, chat)
        if payload is None:
            return
        if stream:
            payload["stream"] = True
        pending = _Pending(payload["id"], streaming=stream)
        gw.register(pending)
        gw.requests_total += 1
        try:
            try:
                gw.run_async(gw._submit(payload, pending))
            except Exception as exc:  # noqa: BLE001 — submit failed: 502
                logger.warning("gateway submit failed", exc_info=True)
                self._error(502, f"submit failed: {exc}")
                return
            if stream:
                gw.requests_streamed += 1
                self._stream_response(pending, chat)
            else:
                self._blocking_response(pending, chat)
        finally:
            gw.unregister(pending.job_id)

    def _blocking_response(self, pending: _Pending, chat: bool) -> None:
        try:
            result = pending.result_future.get(
                timeout=self.gateway.request_timeout_s
            )
        except thread_queue.Empty:
            self._error(504, "generation timed out")
            return
        finish = (
            getattr(result, "__pydantic_extra__", None) or {}
        ).get("finish_reason") or "stop"
        self._send_json(
            200, self._completion_json(pending.job_id, result.result, finish, chat)
        )

    def _completion_json(
        self, job_id: str, text: str, finish: str, chat: bool
    ) -> Dict[str, Any]:
        choice: Dict[str, Any] = {"index": 0, "finish_reason": finish}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        return {
            "id": job_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": self.gateway.model_name,
            "choices": [choice],
        }

    # --- SSE --------------------------------------------------------------
    def _sse_chunk(
        self, job_id: str, delta: str, finish: Optional[str], chat: bool
    ) -> bytes:
        choice: Dict[str, Any] = {"index": 0, "finish_reason": finish}
        if chat:
            choice["delta"] = {"content": delta} if delta else {}
        else:
            choice["text"] = delta
        chunk = {
            "id": job_id,
            "object": "chat.completion.chunk" if chat else "text_completion",
            "created": int(time.time()),
            "model": self.gateway.model_name,
            "choices": [choice],
        }
        return b"data: " + json.dumps(chunk).encode("utf-8") + b"\n\n"

    def _client_gone(self) -> bool:
        """Has the client closed its end? An SSE client sends nothing after
        its request, so a readable socket that yields no byte is its EOF."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            return bool(readable) and self.connection.recv(1, socket.MSG_PEEK) == b""
        except OSError:
            return True

    def _stream_response(self, pending: _Pending, chat: bool) -> None:
        gw = self.gateway
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()

        sent = 0  # character high-water mark already written to the client
        wrote = False  # a chunk went out (the first frame's, text or not)
        deadline = time.monotonic() + gw.request_timeout_s
        finish: Optional[str] = None
        try:
            while time.monotonic() < deadline:
                try:
                    frame = pending.frames.get(timeout=_FRAME_IDLE_TIMEOUT_S)
                except thread_queue.Empty:
                    if self._client_gone():
                        raise ConnectionResetError("the client closed the stream")
                    continue
                if frame is None:
                    # Pump exhausted without a done frame (worker died and
                    # nobody resumed, or result landed first): reconcile
                    # the tail from the final Result if we have one.
                    if pending.result is not None:
                        tail = pending.result.result[sent:]
                        if tail:
                            self.wfile.write(
                                self._sse_chunk(pending.job_id, tail, None, chat)
                            )
                            sent += len(tail)
                        finish = (
                            getattr(
                                pending.result, "__pydantic_extra__", None
                            )
                            or {}
                        ).get("finish_reason") or "stop"
                    else:
                        finish = "error"
                    break
                off = int(frame.get("text_offset", 0))
                text = str(frame.get("text", ""))
                # Absolute-offset dedup: a resumed-on-peer worker
                # re-streams from token 0; emit only past the high-water
                # mark. (A gap — off > sent — means frames expired; emit
                # what we have, the Result reconciles nothing mid-SSE.)
                if off + len(text) > sent or not (wrote or frame.get("done")):
                    delta = text[max(0, sent - off):]
                    self.wfile.write(
                        self._sse_chunk(pending.job_id, delta, None, chat)
                    )
                    sent = max(sent, off + len(text))
                    wrote = True
                if frame.get("done"):
                    finish = str(frame.get("finish_reason") or "stop")
                    break
            else:
                finish = "timeout"
            self.wfile.write(
                self._sse_chunk(pending.job_id, "", finish or "stop", chat)
            )
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # Client hung up mid-stream: free the worker-side request so
            # its KV pages go back to the pool instead of decoding for a
            # dead socket. The eventual Result is dropped as an orphan.
            try:
                gw.run_async(gw._cancel(pending.job_id, pending.worker_id))
            except Exception:  # noqa: BLE001
                logger.debug("disconnect cancel failed", exc_info=True)
