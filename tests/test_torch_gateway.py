"""The port's OpenAI gateway and the engine's latency plane, held against the
JAX package's.

- Gateway against gateway: each package's ``ServingGateway`` in front of its
  own dummy worker over ``memory://`` answers the same requests (blocking,
  streamed and chat completions, ``/v1/models``, ``/healthz``, a 404, three
  400s) with the same status codes, bodies and SSE frames (``id`` and
  ``created`` normalized), and routes through the interactive fast lane.
- Engine stats: after the same requests, the port's ``EngineCore.stats()``
  carries the reference's latency keys, and its histogram counts (TTFT,
  ITL, each dispatch kind, queue wait) equal the JAX engine's.
- The engine through the gateway: the port's ``TorchWorker`` (CPU, tiny
  model, f32, weights bridged from the JAX tree) behind the port's
  gateway, and the reference's ``TPUWorker`` behind its own, give equal
  greedy texts; each streamed text equals its blocking text; the results'
  traces carry the reference's events; a client that hangs up mid-stream
  cancels its request (``finish_reason="cancelled"``), and every page goes
  back to the pool.
"""

import asyncio
import http.client
import json
import time
import uuid
from types import SimpleNamespace

import pytest

from llmq_tpu.core import config as jconfig
from llmq_tpu.engine import engine as jengine
from llmq_tpu.engine.sampling import SamplingParams as JParams
from llmq_tpu.gateway import server as jgateway
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.workers import dummy as jdummy
from llmq_tpu_torch.core import config as tconfig
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine.sampling import SamplingParams as TParams
from llmq_tpu_torch.gateway import server as tgateway
from llmq_tpu_torch.workers import dummy as tdummy

from test_torch_engine import _cores, _run
from test_torch_obs import comparable_trace

pytestmark = pytest.mark.unit

PKGS = {"jax": SimpleNamespace(config=jconfig, gateway=jgateway, dummy=jdummy),
        "port": SimpleNamespace(config=tconfig, gateway=tgateway, dummy=tdummy)}


def _normalized(doc):
    """A response body without what differs between runs: the request id
    the gateway makes and the creation time."""
    if isinstance(doc, dict):
        doc = dict(doc)
        if str(doc.get("id", "")).startswith("gw-"):
            doc["id"] = "gw-<id>"
        if "created" in doc:
            doc["created"] = 0
    return doc


def _call(port, method, path, body=None, *, hang_up_after=None):
    """One HTTP request: (status, JSON body) or, for an event stream, (status,
    [frame payloads]); ``hang_up_after`` frames closes the socket early."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    data = body if isinstance(body, bytes) or body is None else json.dumps(body)
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.getheader("Content-Type") != "text/event-stream":
        out = (resp.status, _normalized(json.loads(resp.read())))
        conn.close()
        return out
    events, buf = [], b""
    while hang_up_after is None or len(events) < hang_up_after:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            if event.startswith(b"data: "):
                text = event[6:].decode()
                events.append(text if text == "[DONE]" else _normalized(json.loads(text)))
    resp.close()  # the socket goes with it: a reader that leaves early hangs up
    conn.close()
    return resp.status, events


def _sse_text(events) -> str:
    out = ""
    for e in events[:-1]:
        choice = e["choices"][0]
        out += choice.get("text") or choice.get("delta", {}).get("content", "")
    return out


CHAT = [{"role": "user", "content": "hello chat"}]
REQUESTS = [
    ("POST", "/v1/completions", {"prompt": "gateway round trip", "max_tokens": 8}),
    ("POST", "/v1/completions", {"prompt": "gateway round trip", "stream": True}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "temperature": 0.0}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "stream": True}),
    ("GET", "/v1/models", None),
    ("GET", "/healthz", None),
    ("GET", "/nope", None),
    ("POST", "/v1/embeddings", {"input": "x"}),
    ("POST", "/v1/completions", b"{not json"),
    ("POST", "/v1/completions", {"prompt": ""}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "priority": "urgent"}),
]


async def _dummy_session(pkg: str):
    p = PKGS[pkg]
    cfg = p.config.Config(broker_url=f"memory://gw-{pkg}-{uuid.uuid4().hex[:8]}")
    gw = p.gateway.ServingGateway("gq", config=cfg, port=0, request_timeout_s=30)
    await gw.astart()
    worker = p.dummy.DummyWorker("gq", delay=0, config=cfg, concurrency=4)
    task = asyncio.ensure_future(worker.run())
    try:
        answers = [await asyncio.to_thread(_call, gw.port, m, path, body)
                   for m, path, body in REQUESTS]
        return answers, gw.mgr.interactive_routed, gw.requests_streamed
    finally:
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=30)
        await gw.astop()


def test_gateway_answers_as_the_reference_gateway():
    want = asyncio.run(_dummy_session("jax"))
    got = asyncio.run(_dummy_session("port"))
    assert got == want
    answers, routed, streamed = got
    assert routed == 4 and streamed == 2  # every generation rode the fast lane
    assert [status for status, _ in answers] == [200] * 6 + [404] * 2 + [400] * 3
    (_, blocking), (_, frames) = answers[:2]
    assert blocking["choices"][0]["text"] == _sse_text(frames) == "echo gateway round trip"
    assert frames[-1] == "[DONE]" and frames[-2]["choices"][0]["finish_reason"] == "stop"


# --- the engines ------------------------------------------------------------------------

ENGINE = dict(max_num_seqs=4, max_model_len=512, page_size=8, num_pages=160, kv_dtype="f32",
              min_prefill_bucket=16)
_CORES = []


@pytest.fixture(scope="module")
def cores():
    """One JAX engine and one port engine over one tree, for the file."""
    if not _CORES:
        _CORES.extend(_cores(JConfig.tiny(), **ENGINE))
    return _CORES


def _counts(core, before=None):
    """The latency histograms' observation counts (less ``before``'s)."""
    s = core.stats()
    out = dict(ttft=core.ttft_hist.total, itl=core.itl_hist.total,
               ttft_interactive=core.ttft_hist_interactive.total,
               queue_wait=core.scheduler.queue_wait_hist.total,
               dispatch={k: v["count"] for k, v in s["dispatch_ms"].items()})
    if before is not None:
        out = {k: ({d: n - before[k].get(d, 0) for d, n in v.items()} if k == "dispatch"
                   else v - before[k]) for k, v in out.items()}
    return out


LATENCY_KEYS = {"ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p95_ms",
                "itl_p99_ms", "dispatch_ms", "queue_wait_p50_ms", "queue_wait_p95_ms",
                "preemption_delay_p50_ms", "ttft_p50_ms_interactive", "ttft_p95_ms_interactive",
                "itl_p50_ms_interactive", "itl_p95_ms_interactive"}


def test_engine_latency_stats_count_as_the_jax_engine(cores):
    jcore, tcore = cores
    before = _counts(jcore), _counts(tcore)
    requests = [("s0", "The queue said", dict(max_tokens=9, ignore_eos=True)),
                ("s1", "Hello there, worker", dict(max_tokens=5, ignore_eos=True)),
                ("s2", "abc", dict(max_tokens=7, ignore_eos=True))]
    _run(jcore, requests, JParams)
    _run(tcore, requests, TParams)
    for rid, prompt, kw in (("s3", "an interactive one", dict(max_tokens=6, ignore_eos=True)),):
        jcore.add_request(rid, prompt=prompt, params=JParams(temperature=0.0, **kw),
                          priority="interactive")
        tcore.add_request(rid, prompt=prompt, params=TParams(temperature=0.0, **kw),
                          priority="interactive")
    for core in (jcore, tcore):
        while core.has_work:
            core.step()
    want, got = _counts(jcore, before[0]), _counts(tcore, before[1])
    assert got == want
    assert got["ttft"] == 4 and got["itl"] == 8 + 4 + 6 + 5 and got["ttft_interactive"] == 1
    assert set(got["dispatch"]) == {"prefill", "decode_block"}
    assert LATENCY_KEYS <= set(tcore.stats()) and LATENCY_KEYS <= set(jcore.stats())
    assert tcore.stats()["ttft_p50_ms"] > 0


async def _engine_session(pkg, core, *, cancel_prompt=None):
    """The package's engine worker behind its gateway: blocking requests,
    then the same streamed, then (port) a stream the client leaves."""
    url = f"memory://gwe-{pkg}-{uuid.uuid4().hex[:8]}"
    results = {}
    if pkg == "port":
        from llmq_tpu_torch.workers.torch_worker import TorchWorker

        engine = tengine.AsyncEngine(core)
        cfg = tconfig.Config(broker_url=url)
        worker = TorchWorker("gq", engine, config=cfg)
    else:
        from llmq_tpu.workers.tpu_worker import TPUWorker

        engine = jengine.AsyncEngine(core)
        cfg = jconfig.Config(broker_url=url)
        worker = TPUWorker("gq", model="preset://tiny", config=cfg,
                           engine_factory=lambda _: engine)
    gw = PKGS[pkg].gateway.ServingGateway("gq", config=cfg, port=0, request_timeout_s=60)
    on_result = gw._on_result

    async def recording(message):
        body = json.loads(message.body)
        results[body["id"]] = body
        await on_result(message)

    gw._on_result = recording
    await gw.astart()
    task = asyncio.ensure_future(worker.run())
    out = dict(blocking=[], streamed=[])
    try:
        for prompt in PROMPTS:
            body = {"prompt": prompt, "max_tokens": 12, "temperature": 0.0}
            status, doc = await asyncio.to_thread(_call, gw.port, "POST", "/v1/completions",
                                                  body)
            assert status == 200, doc
            out["blocking"].append(doc["choices"][0]["text"])
            status, frames = await asyncio.to_thread(_call, gw.port, "POST", "/v1/completions",
                                                     {**body, "stream": True})
            assert status == 200 and frames[-1] == "[DONE]", frames[-3:]
            out["streamed"].append(_sse_text(frames))
        out["traces"] = [comparable_trace(r["trace"])[2] for r in results.values()]
        if cancel_prompt is not None:
            body = {"prompt": cancel_prompt, "max_tokens": 480, "temperature": 0.0,
                    "stream": True}
            await asyncio.to_thread(_call, gw.port, "POST", "/v1/completions", body,
                                    hang_up_after=2)
            for _ in range(1000):
                if len(results) > 2 * len(PROMPTS):
                    break
                await asyncio.sleep(0.01)
            [cancelled] = [r for r in results.values() if r["prompt"] == cancel_prompt]
            out["cancelled"] = (cancelled["finish_reason"],
                                cancelled["usage"]["completion_tokens"] < 480,
                                gw.cancels_sent, worker.jobs_cancelled, core.cancellations)
            sched = core.scheduler
            for _ in range(500):
                free = engine.call_on_engine(lambda: sched.allocator.available)
                if free == sched.config.num_pages - 1:
                    break
                await asyncio.sleep(0.01)
            out["pages_free"] = (free, sched.config.num_pages - 1)
        return out
    finally:
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=60)
        await gw.astop()
        engine.shutdown()


PROMPTS = ["The queue said", "Hello there, worker"]
TRACE_NAMES = ["submitted", "claimed", "tokenized", "admitted", "prefill_start", "first_token",
               "decode", "finished"]


def test_engine_worker_through_the_gateway_equals_the_jax_worker(cores):
    jcore, tcore = cores
    want = asyncio.run(_engine_session("jax", jcore))
    got = asyncio.run(_engine_session("port", tcore, cancel_prompt="Tell me a long story"))
    assert got["blocking"] == want["blocking"]
    assert got["streamed"] == got["blocking"]
    assert got["traces"] == want["traces"]
    assert [e["name"] for e in got["traces"][0]] == TRACE_NAMES
    assert got["cancelled"] == ("cancelled", True, 1, 1, 1)
    free, total = got["pages_free"]
    assert free == total


# --- queue 3 item 21: a stream the client leaves before any text ------------------------

def test_first_frame_goes_out_without_text_unlike_the_reference():
    """The port's worker publishes its first frame at the first token even
    when that token has no text (an id past the byte tokenizer's 256), so
    the gateway learns where to send a cancel; the reference's publishes
    nothing until text comes."""
    from llmq_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    from test_torch_obs import stream_frames

    tokens = [300, 300, ord("a") + 1]
    ref = stream_frames("jax", JByteTokenizer(), tokens, "a")
    port = stream_frames("port", ByteTokenizer(), tokens, "a")
    assert [f["text"] for f in ref] == ["a", ""] and ref[-1]["done"]
    assert [(f["text_offset"], f["text"]) for f in port] == [(0, ""), (0, "a"), (1, "")]
    assert port[0]["worker_id"] and not port[0].get("done")


def _leave_stream(port: int, wait_s: float) -> bytes:
    """Ask for a stream, read its first chunk (or wait ``wait_s`` for one),
    and hang up."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=wait_s)
    conn.request("POST", "/v1/completions", json.dumps({"prompt": "p", "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    try:
        first = resp.read1(65536)
    except TimeoutError:
        first = b""
    resp.close()
    conn.close()
    return first


async def _left_while_silent(pkg: str):
    """A gateway over ``memory://`` whose job gets one frame without text
    (as the port's worker sends it) from a worker ``w1``; its client leaves.
    Returns what the client read and the cancel on ``gq.ctl.w1``, if any."""
    p = PKGS[pkg]
    gw = p.gateway.ServingGateway("gq", config=p.config.Config(
        broker_url=f"memory://leave-{pkg}-{uuid.uuid4().hex[:8]}"), port=0, request_timeout_s=30)
    await gw.astart()
    broker = gw.mgr.broker
    try:
        client = asyncio.ensure_future(asyncio.to_thread(_leave_stream, gw.port, 0.5))
        msg = None
        for _ in range(500):
            if (msg := await broker.get("gq.interactive")) is not None:
                break
            await asyncio.sleep(0.01)
        job_id = json.loads(msg.body)["id"]
        await msg.ack()
        await broker.declare_queue("gq.ctl.w1", ttl_ms=30_000, max_redeliveries=1)
        await broker.publish(f"gq.stream.{job_id}", json.dumps(
            {"id": job_id, "text_offset": 0, "text": "", "worker_id": "w1"}).encode())
        first = await client
        cancel = None
        for _ in range(100):  # the port's check runs every 0.25 s
            if (ctl := await broker.get("gq.ctl.w1")) is not None:
                cancel = json.loads(ctl.body)
                await ctl.ack()
                break
            await asyncio.sleep(0.01)
        return first, cancel, job_id
    finally:
        await gw.astop()


def test_a_client_that_leaves_before_any_text_is_cancelled_unlike_the_reference():
    """The reference's gateway writes no chunk for a frame without text and
    learns of a client that left only from a failed write, so a stream
    whose tokens have no text yet decodes on for nobody; the port's
    forwards the first frame and checks for the client between frames."""
    first, cancel, _ = asyncio.run(_left_while_silent("jax"))
    assert first == b"" and cancel is None
    first, cancel, job_id = asyncio.run(_left_while_silent("port"))
    chunk = json.loads(first.decode().split("data: ", 1)[1])
    assert chunk["choices"][0] == {"index": 0, "finish_reason": None, "text": ""}
    assert cancel == {"cancel": job_id}


# --- queue 3 item 22: a burst of clients ------------------------------------------------

def _burst(port: int, n: int) -> float:
    """The slowest of ``n`` simultaneous ``/healthz`` requests, in seconds."""
    from concurrent.futures import ThreadPoolExecutor

    def one(_):
        t0 = time.perf_counter()
        status, _ = _call(port, "GET", "/healthz")
        assert status == 200
        return time.perf_counter() - t0

    with ThreadPoolExecutor(n) as pool:
        return max(pool.map(one, range(n)))


async def _slowest_of_bursts(pkg: str, n_bursts: int) -> float:
    """The slowest request of up to ``n_bursts`` bursts of 32 (stopping at
    the first one that waits out a retransmit)."""
    p = PKGS[pkg]
    gw = p.gateway.ServingGateway("gq", config=p.config.Config(
        broker_url=f"memory://burst-{pkg}-{uuid.uuid4().hex[:8]}"), port=0)
    await gw.astart()
    slowest = 0.0
    try:
        for _ in range(n_bursts):
            slowest = max(slowest, await asyncio.to_thread(_burst, gw.port, 32))
            if slowest >= 0.9:
                break
        return slowest
    finally:
        await gw.astop()


def test_a_burst_of_clients_is_not_held_back_unlike_the_reference():
    """32 clients at once: the reference's gateway listens with
    ``socketserver``'s backlog of 5, so clients past it wait out a SYN
    retransmit (1 s) before their request is read; the port's listens with
    128 and answers every client of each burst at once."""
    assert asyncio.run(_slowest_of_bursts("jax", 3)) >= 0.9
    assert asyncio.run(_slowest_of_bursts("port", 2)) < 0.9
