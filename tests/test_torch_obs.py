"""The port's observability plane, held against the JAX package's.

- The metrics registry (``obs/metrics.py``): the same seeded observations
  give the same Prometheus text, heartbeat summary and percentiles, for
  each kind of metric.
- The lifecycle trace (``obs/trace.py``): under frozen clocks the same
  records, timelines and ``LLMQ_TRACE_LOG`` sink lines.
- The exporter (``obs/exporter.py``): ``/metrics`` on a bound port serves
  the same body; ``LLMQ_METRICS_PORT=0`` starts one process-wide exporter.
- Traces through the workers: a redelivered job, a shed job and a two-stage
  pipeline hand-off give result (or dead-letter) traces with the
  reference's event names, order and non-time fields, and the same sink
  lines.
- Queue 3 item 20: the reference's token stream sends U+FFFD for a
  multi-byte character split across two flushes and never sends the
  character; the port holds the partial character back, and its frames
  join to the result's text.
"""

import asyncio
import http.client
import json
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from llmq_tpu.broker import manager as jmanager
from llmq_tpu.core import config as jconfig
from llmq_tpu.core import models as jmodels
from llmq_tpu.core import pipeline as jpipeline
from llmq_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llmq_tpu.obs import exporter as jexporter
from llmq_tpu.obs import metrics as jmetrics
from llmq_tpu.obs import trace as jtrace
from llmq_tpu.utils import clock as jclock
from llmq_tpu.workers import dummy as jdummy
from llmq_tpu_torch.broker import manager as tmanager
from llmq_tpu_torch.core import config as tconfig
from llmq_tpu_torch.core import models as tmodels
from llmq_tpu_torch.core import pipeline as tpipeline
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.obs import exporter as texporter
from llmq_tpu_torch.obs import metrics as tmetrics
from llmq_tpu_torch.obs import trace as ttrace
from llmq_tpu_torch.utils import clock as tclock
from llmq_tpu_torch.workers import dummy as tdummy

pytestmark = pytest.mark.unit

PKGS = {
    "jax": SimpleNamespace(manager=jmanager, config=jconfig, models=jmodels, dummy=jdummy,
                           pipeline=jpipeline, trace=jtrace),
    "port": SimpleNamespace(manager=tmanager, config=tconfig, models=tmodels, dummy=tdummy,
                            pipeline=tpipeline, trace=ttrace),
}


# --- the registry ----------------------------------------------------------------------

def _feed(mod, kind: str, values: np.ndarray):
    """A fresh registry holding one metric of ``kind`` fed ``values``, and
    the metric."""
    reg = mod.MetricsRegistry()
    if kind == "counter":
        metric = reg.counter("llmq_things", "Things counted", labels={"queue": "q"})
        for v in values:
            metric.inc(float(v))
        assert reg.counter("llmq_things", labels={"queue": "q"}) is metric  # get-or-create
    elif kind == "gauge":
        metric = reg.gauge("llmq_level", "A level")
        for v in values:
            metric.set(float(v))
    elif kind == "gauge_fn":
        seen = list(values)
        metric = reg.register(mod.Gauge("llmq_live", "A read-through level",
                                        fn=lambda: sum(seen)))
        reg.register(mod.Gauge("llmq_dead", "A broken callback", fn=lambda: 1 / 0))
    else:
        buckets = (0.0001, 0.00025, 0.0005) + mod.DEFAULT_BUCKETS if kind == "itl" else \
            mod.DEFAULT_BUCKETS
        metric = reg.register(mod.Histogram("llmq_lat_seconds", "A latency", buckets=buckets,
                                            labels={"class": "interactive"}
                                            if kind == "itl" else None))
        reg.register(mod.Histogram("llmq_empty_seconds", "Never observed"))
        for v in values:
            metric.observe(float(v))
    return reg, metric


@pytest.mark.parametrize("kind", ["counter", "gauge", "gauge_fn", "histogram", "itl"])
def test_registry_renders_and_summarizes_as_the_reference(kind):
    values = np.random.default_rng(14).lognormal(-4.0, 2.0, 500)
    out = []
    for mod in (jmetrics, tmetrics):
        reg, metric = _feed(mod, kind, values)
        pcts = ([metric.percentile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)]
                + [metric.snapshot()] if hasattr(metric, "percentile") else None)
        out.append((reg.render_prometheus(), reg.summary(), pcts))
    assert out[1] == out[0]
    assert tmetrics.to_ms(0.0123456) == jmetrics.to_ms(0.0123456)
    assert tmetrics.get_registry() is tmetrics.get_registry()


# --- the trace -------------------------------------------------------------------------

class _FrozenClock:
    def __init__(self, t: float) -> None:
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t + 1_700_000_000.0


@pytest.fixture()
def frozen_clocks():
    clk = _FrozenClock(1000.0)
    jclock.set_clock(clk)
    tclock.set_clock(clk)
    yield clk
    jclock.set_clock(jclock.Clock())
    tclock.set_clock(tclock.Clock())


def _trace_session(mod, clk, sink):
    """Every trace function over one record, the clock stepping between."""
    clk.t = 1000.0
    rec = mod.new_trace("job-1")
    assert mod.trace_event(None, "ignored") is None
    mod.trace_event(rec, "submitted", queue="q")
    clk.t += 0.25
    mod.trace_event(rec, "claimed", worker_id="w", delivery_count=0)
    mod.trace_event_at(rec, "first_token", 1000.125)
    mod.trace_event_at(rec, "never", 0.0)  # a phase that never happened
    rec["events"].append({"name": "remote", "t_wall": clk.time() + 0.5, "t_mono": 5.0,
                          "host": "elsewhere"})
    clk.t += 1.0
    mod.trace_event(rec, "finished", duration_ms=1250.0)
    for job_id, name, fields in (("job-1", "claimed", {"worker_id": "w"}),
                                 ("job-1", "requeued", {"reason": "timeout"}),
                                 ("w", "role_switch", {"role_from": "prefill"})):
        mod.emit_trace_event(job_id, name, **fields)
    return dict(
        record=rec,
        payload=mod.trace_from_payload({mod.TRACE_FIELD: rec}),
        malformed=[mod.trace_from_payload(p) for p in
                   (None, {}, {mod.TRACE_FIELD: {"events": "no"}}, {mod.TRACE_FIELD: []})],
        wall=mod.mono_to_wall(999.0),
        timeline=mod.timeline(rec),
        sink=sink.read_text().splitlines(),
    )


def test_trace_records_timelines_and_sink_equal_the_reference(frozen_clocks, tmp_path,
                                                              monkeypatch):
    out = []
    for mod in (jtrace, ttrace):
        sink = tmp_path / f"{mod.__name__}.jsonl"
        monkeypatch.setenv("LLMQ_TRACE_LOG", str(sink))
        out.append(_trace_session(mod, frozen_clocks, sink))
    assert out[1] == out[0]
    got = out[1]
    assert [r["name"] for r in got["timeline"]] == ["submitted", "first_token", "claimed",
                                                    "remote", "finished"]
    assert len(got["sink"]) == 3 and json.loads(got["sink"][1])["event"] == "requeued"
    monkeypatch.delenv("LLMQ_TRACE_LOG")
    assert ttrace.trace_log_path() is None
    ttrace.emit_trace_event("job-1", "unlogged")  # the sink off: a no-op


# --- the exporter ----------------------------------------------------------------------

def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), body


def test_exporter_serves_the_reference_body(monkeypatch):
    values = np.random.default_rng(3).exponential(0.05, 64)
    got = []
    for mod, exp in ((jmetrics, jexporter), (tmetrics, texporter)):
        reg, _ = _feed(mod, "histogram", values)
        exporter = exp.MetricsExporter(reg, port=0, host="127.0.0.1").start()
        try:
            got.append([_get(exporter.port, path) for path in ("/metrics", "/", "/nope")])
        finally:
            exporter.stop()
    assert got[1][:2] == got[0][:2]
    assert got[1][0][0] == 200 and b"llmq_lat_seconds_count 64" in got[1][0][2]
    assert got[1][2][0] == got[0][2][0] == 404

    monkeypatch.setenv("LLMQ_METRICS_PORT", "0")
    try:
        exporter = texporter.maybe_start_exporter(reg)
        assert exporter is not None and texporter.maybe_start_exporter() is exporter
        status, _, body = _get(exporter.port, "/metrics")
        assert status == 200 and body.decode() == reg.render_prometheus()
    finally:
        texporter.stop_exporter()
    monkeypatch.setenv("LLMQ_METRICS_PORT", "not-a-port")
    assert texporter.maybe_start_exporter() is None


# --- traces through the workers ----------------------------------------------------------

TIME_FIELDS = {"t_wall", "t_mono", "duration_ms", "latency_ms"}


def comparable_trace(trace: dict):
    """A trace without what a run stamps: times, and the worker's id (the two
    packages' workers differ) as ``W``."""
    events = []
    for event in trace["events"]:
        event = {k: v for k, v in event.items() if k not in TIME_FIELDS}
        if "worker_id" in event:
            event["worker_id"] = "W"
        events.append(event)
    return trace["job_id"], trace["redeliveries"], events


def _sink_lines(path) -> list:
    out = []
    for line in path.read_text().splitlines():
        rec = {k: v for k, v in json.loads(line).items() if k not in TIME_FIELDS}
        if "worker_id" in rec:
            rec["worker_id"] = "W"
        out.append(rec)
    return out


async def _serve_dummies(pkg, url, workers, publish, results_queue, n):
    """Run ``workers`` (factories of (package, config)) until ``n`` messages
    are on ``results_queue``, after ``publish(package, manager)``."""
    p = PKGS[pkg]
    cfg = p.config.Config(broker_url=url)
    mgr = p.manager.BrokerManager(cfg)
    await mgr.connect()
    running = [make(p, cfg) for make in workers]
    tasks = [asyncio.create_task(w.run()) for w in running]
    out = []
    try:
        await publish(p, mgr)
        for _ in range(1000):
            if len(out) >= n:
                break
            msg = await mgr.broker.get(results_queue)
            if msg is None:
                await asyncio.sleep(0.01)
                continue
            out.append((json.loads(msg.body), dict(msg.headers or {})))
            await msg.ack()
    finally:
        for w in running:
            w.request_shutdown()
        await asyncio.gather(*tasks)
        await mgr.disconnect()
    assert len(out) == n
    return out


def _flaky(p, cfg):
    """A dummy worker whose first attempt at each job fails."""

    class Flaky(p.dummy.DummyWorker):
        failed: set = set()

        async def _process_job(self, job):
            if job.id not in self.failed:
                self.failed.add(job.id)
                raise RuntimeError("flaky")
            return await super()._process_job(job)

    return Flaky("tq", delay=0, config=cfg)


async def _publish_plain(p, mgr):
    await mgr.publish_job("tq", p.models.Job(id="plain", prompt="hello {x}", x="there"))


async def _publish_doomed(p, mgr):
    await mgr.setup_queue_infrastructure("tq")
    await mgr.publish_job("tq", p.models.Job(id="doomed", prompt="late", deadline_ms=1,
                                             deadline_at=1.0))


async def _publish_to_stage_one(p, mgr):
    cfg = _two_stages(p)
    await mgr.setup_pipeline_infrastructure(cfg)
    await mgr.publish_job(cfg.get_stage_queue_name("a"), p.models.Job(id="piped", prompt="p"))


def _two_stages(p):
    return p.pipeline.PipelineConfig.model_validate(
        {"name": "tp", "stages": [{"name": "a", "worker": "dummy"},
                                  {"name": "b", "worker": "dummy"}]})


def _stage(name):
    def make(p, cfg):
        pipe = _two_stages(p)
        return p.dummy.DummyWorker(pipe.get_stage_queue_name(name), delay=0, config=cfg,
                                   pipeline=pipe, stage_name=name)
    return make


CASES = {
    # A job that fails its first delivery: requeued, then served; the
    # redelivery re-reads the submit-time record, so no event repeats.
    "redelivered": ([_flaky], _publish_plain, "tq.results", ["submitted", "claimed",
                                                             "finished"]),
    # A deadline already past at submit: shed to <q>.failed with its trace.
    "shed": ([], _publish_doomed, "tq.failed", ["shed"]),
    # Two stages: the record rides the hand-off (a second "submitted").
    "pipeline": ([_stage("a"), _stage("b")], _publish_to_stage_one, "pipeline.tp.results",
                 ["submitted", "claimed", "finished", "submitted", "claimed", "finished"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_worker_traces_equal_the_reference(case, tmp_path, monkeypatch):
    workers, publish, results, names = CASES[case]
    got = []
    for pkg in ("jax", "port"):
        sink = tmp_path / f"{pkg}.jsonl"
        monkeypatch.setenv("LLMQ_TRACE_LOG", str(sink))
        url = f"memory://obs-{case}-{uuid.uuid4().hex[:8]}"
        [(payload, headers)] = asyncio.run(_serve_dummies(pkg, url, workers, publish,
                                                          results, 1))
        trace = PKGS[pkg].trace.trace_from_payload(payload)
        got.append((comparable_trace(trace), _sink_lines(sink) if sink.exists() else [],
                    {k: v for k, v in headers.items() if k != "x-worker-id"}))
    assert got[1] == got[0]
    (_, redeliveries, events), sink, _ = got[1]
    assert [e["name"] for e in events] == names
    assert redeliveries == (1 if case == "redelivered" else 0)
    if case == "redelivered":
        assert [r["event"] for r in sink] == ["claimed", "requeued", "claimed", "finished"]
        summary = tmetrics.get_registry().summary()
        assert summary["llmq_broker_publish_seconds_ms"]["count"] > 0
        assert summary["llmq_broker_settle_seconds_ms"]["count"] > 0


# --- queue 3 item 20: a character split across two stream flushes ----------------------

class _StreamEngine:
    """The engine surface the stream path touches: its tokenizer and the
    per-request token callbacks."""

    def __init__(self, tokenizer) -> None:
        self.core = SimpleNamespace(tokenizer=tokenizer, cfg=SimpleNamespace(max_num_seqs=4))
        self.callbacks = {}

    def set_token_callback(self, rid, cb) -> None:
        self.callbacks[rid] = cb

    def clear_token_callback(self, rid) -> None:
        self.callbacks.pop(rid, None)


class _FrameSink:
    def __init__(self) -> None:
        self.frames = []

    async def declare_queue(self, *args, **kwargs) -> None:
        return None

    async def publish(self, queue, body, **kwargs) -> None:
        self.frames.append(json.loads(body))


def stream_worker(pkg: str, tokenizer):
    """A worker of ``pkg`` over a stub engine with ``tokenizer``, whose
    broker records the frames it publishes."""
    engine = _StreamEngine(tokenizer)
    url = f"memory://stream-{uuid.uuid4().hex[:8]}"
    if pkg == "port":
        from llmq_tpu_torch.workers.torch_worker import TorchWorker

        worker = TorchWorker("sq", engine, config=tconfig.Config(broker_url=url))
    else:
        from llmq_tpu.workers.tpu_worker import TPUWorker

        worker = TPUWorker("sq", model="preset://tiny", config=jconfig.Config(broker_url=url),
                           engine_factory=lambda _: None)
        worker.engine = engine
    worker.broker = SimpleNamespace(broker=_FrameSink())
    return worker, engine


def stream_frames(pkg: str, tokenizer, token_ids, final_text: str) -> list:
    """Drive the worker's stream with one flush a token, then finish it as
    a request whose result text is ``final_text``; the frames published."""
    worker, engine = stream_worker(pkg, tokenizer)
    job = PKGS[pkg].models.Job(id="s1", prompt="p", stream=True)

    async def main():
        assert await worker._stream_begin(job)
        for n, token in enumerate(token_ids, 1):
            engine.callbacks["s1"](token, n)
            for _ in range(4):  # the token's flush runs to its end
                await asyncio.sleep(0)
        await worker._stream_finish(job, SimpleNamespace(finish_reason="stop", text=final_text))

    asyncio.run(main())
    return worker.broker.broker.frames


def joined(frames) -> str:
    """The text a reader assembles, each frame's text at its offset."""
    text = ""
    for frame in frames:
        assert frame["text_offset"] == len(text)
        text += frame["text"]
    return text


def test_a_character_split_across_flushes_streams_whole_unlike_the_reference():
    text = "café ok"
    tokens = ByteTokenizer().encode(text)
    assert tokens == JByteTokenizer().encode(text) and len(tokens) == len(text) + 1  # é: 2
    ref = stream_frames("jax", JByteTokenizer(), tokens, text)
    assert joined(ref) == "caf� ok" != text  # the reference: é is never sent
    port = stream_frames("port", ByteTokenizer(), tokens, text)
    assert joined(port) == text
    assert "�" not in "".join(f["text"] for f in port)
    assert port[-1]["done"] and port[-1]["finish_reason"] == "stop"
    # The split character waits one token: no frame for its first byte.
    assert [f["text"] for f in port] == ["c", "a", "f", "é", " ", "o", "k", ""]
