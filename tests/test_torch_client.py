"""The port's client and operator commands, held against the JAX package.

- Every ported command (``submit``, ``receive``, the hidden ``pipeline`` /
  ``receive-pipeline``, ``status``, ``health``, ``errors``, ``clear``,
  ``trace``, ``serve``, ``monitor top``, ``worker run`` / ``dummy`` /
  ``dedup`` / ``pipeline``, ``broker serve``) takes the reference's click
  arguments and options, with their names, flags, choices and defaults, as
  argparse actions; ``serve``, ``trace`` and ``monitor top --once`` run
  (the gateway on a bound port answers ``/healthz``), and ``broker serve
  --native`` is refused as out of scope.
- ``run_pipeline_worker`` picks the reference's worker type for each stage
  type, with the reference's arguments, and exits 1 where it does.
- ``submit``, ``worker dummy`` and ``receive`` over ``memory://`` print the
  reference's result lines (ids, results, extras), and ``submit --stream``
  streams them; the operator commands print the reference's fields;
  ``monitor top``'s summary, columns and cells equal the reference's
  (its ``rich`` markup dropped), and ``trace`` prints the reference's rows
  for a result, a dead letter and a job with neither.
"""

import argparse
import asyncio
import inspect
import json
import uuid
from types import SimpleNamespace

import click
import pytest

from llmq_tpu_torch.cli import main as port_main

pytestmark = pytest.mark.unit


def _port_commands():
    parser = port_main.build_parser()

    def sub(p):
        return next(a for a in p._actions if isinstance(a, argparse._SubParsersAction))

    groups = sub(parser).choices
    out = {name: p for name, p in groups.items() if name not in ("worker", "broker", "monitor")}
    for group in ("worker", "broker", "monitor"):
        for name, p in sub(groups[group]).choices.items():
            out[f"{group} {name}"] = p
    return out


def _ref_commands():
    from llmq_tpu.cli.main import cli

    out = {}
    for name, cmd in cli.commands.items():
        if isinstance(cmd, click.Group):
            out.update({f"{name} {sub}": c for sub, c in cmd.commands.items()})
        else:
            out[name] = cmd
    return out


PORTED = ("submit", "receive", "pipeline", "receive-pipeline", "status", "health", "errors",
          "clear", "trace", "serve", "monitor top", "worker run", "worker dummy", "worker dedup",
          "worker pipeline", "broker serve")
#: the port's own options: the device of an engine, worker run's log level
PORT_ONLY = {"worker run": {"device", "log_level"}, "worker pipeline": {"device"}}


def _click_params(cmd):
    out = {}
    for p in cmd.params:
        # click 8.2 marks "no default" with a sentinel
        default = None if type(p.default).__name__ == "Sentinel" else p.default
        if isinstance(p, click.Argument):
            out[p.name] = dict(flags=(), default=default, required=p.required)
            continue
        if p.multiple:
            default = list(default or ())
        choices = list(p.type.choices) if isinstance(p.type, click.Choice) else None
        out[p.name] = dict(flags=tuple(p.opts) + tuple(p.secondary_opts), default=default,
                           choices=choices, type=p.type.name if not p.is_flag else "flag")
    return out


def _argparse_params(parser):
    out = {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        if not a.option_strings:
            out[a.dest] = dict(flags=(), default=a.default, required=a.nargs != "?")
            continue
        entry = out.setdefault(a.dest, dict(flags=(), default=a.default,
                                            choices=list(a.choices) if a.choices else None))
        entry["flags"] += tuple(a.option_strings)
        if isinstance(a, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
            entry["type"] = "flag"
        elif a.type is int:
            entry["type"] = "integer"
        elif a.type is float:
            entry["type"] = "float"
        elif a.choices:
            entry["type"] = "choice"
        else:
            entry["type"] = "text"
        if isinstance(a, argparse._AppendAction):
            entry["default"] = list(a.default)
    return out


@pytest.mark.parametrize("name", PORTED)
def test_each_command_takes_the_reference_options(name):
    want = _click_params(_ref_commands()[name])
    got = _argparse_params(_port_commands()[name])
    for dest in PORT_ONLY.get(name, ()):
        got.pop(dest)
    assert got == want


#: what each command that was refused until the M16 slice prints as it runs
RUNS = {"serve": "Serving q on http://127.0.0.1:", "trace": "No result for job 'job-1'",
        "monitor": "queue q — 0 fresh worker(s), 0 stale | ready 0 | fleet 0.0 tok/s"}


@pytest.mark.parametrize("argv,item", [
    (["serve", "q", "--port", "0"], "M16"), (["trace", "job-1", "-q", "q"], "M16"),
    (["monitor", "top", "q", "--once"], "M16"), (["broker", "serve", "--native"], "Out of scope"),
])
def test_unported_commands_are_refused_with_their_item(argv, item, monkeypatch, capsys):
    """The commands of M16 (once refused here) run: ``serve`` binds its port
    and answers ``/healthz`` until interrupted, ``trace`` and ``monitor top
    --once`` read an empty queue. ``broker serve --native`` stays refused."""
    assert argv[0] in _ref_commands() or f"{argv[0]} {argv[1]}" in _ref_commands()
    if item != "M16":
        with pytest.raises(NotImplementedError, match=item):
            port_main.main(argv)
        return
    import http.client

    monkeypatch.setenv("LLMQ_BROKER_URL", f"memory://cmd-{uuid.uuid4().hex[:8]}")
    answers = []

    def probe_then_interrupt(gateway):
        conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=10)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        answers.append((resp.status, json.loads(resp.read())))
        raise KeyboardInterrupt

    monkeypatch.setattr(port_main, "_serve_until_interrupted", probe_then_interrupt)
    assert port_main.main(argv) == 0
    assert RUNS[argv[0]] in capsys.readouterr().out
    if argv[0] == "serve":
        assert answers == [(200, {"ok": True, "queue": "q"})]


# --- run_pipeline_worker's choice of worker ----------------------------------------

STAGES = """name: choose
stages:
  - {name: gen, worker: tpu, config: {model: /models/m, max_model_len: 256, max_num_seqs: 8,
                                      prompt: "{text}"}}
  - {name: legacy, worker: vllm, config: {model: /models/v}}
  - {name: echo, worker: dummy, config: {delay: 0.25}}
  - {name: echo-default, worker: dummy}
  - {name: filt, worker: dedup, config: {batch_size: 16, mode: outliers, threshold: 0.5}}
  - {name: semhash, worker: semhash}
  - {name: nomodel, worker: tpu}
  - {name: weird, worker: spark}
"""
KINDS = {"TPUWorker": "engine", "TorchWorker": "engine", "DummyWorker": "dummy",
         "DedupWorker": "dedup"}


def _chosen(worker, engine_args):
    out = dict(kind=KINDS[type(worker).__name__], queue=worker.queue,
               stage=worker.stage_name, pipeline=worker.pipeline.name,
               concurrency=worker.concurrency)
    if out["kind"] == "engine":
        out.update(engine_args(worker))
    elif out["kind"] == "dummy":
        out["delay"] = worker.delay
    else:
        out.update(batch_size=worker.batch_size, mode=worker.mode, threshold=worker.threshold,
                   embedding=worker.embedding)
    return out


def _choose(run, module, stage, engine_args, monkeypatch, path):
    chosen = []
    monkeypatch.setattr(module, "_run", lambda w: chosen.append(w))
    try:
        run(str(path), stage, concurrency=300)
    except SystemExit as exc:
        return ("exit", exc.code)
    return _chosen(chosen[0], engine_args)


@pytest.mark.parametrize("stage", ["gen", "legacy", "echo", "echo-default", "filt", "semhash",
                                   "nomodel", "weird", "missing"])
def test_pipeline_worker_picks_the_reference_worker(stage, tmp_path, monkeypatch):
    from llmq_tpu.cli import worker as ref_worker

    from llmq_tpu_torch.cli import worker as port_worker

    monkeypatch.setenv("LLMQ_BROKER_URL", "memory://choose")
    path = tmp_path / "p.yaml"
    path.write_text(STAGES)
    built = []

    def stub_engine(model, **kwargs):
        built.append(dict(model=model, **kwargs))
        return SimpleNamespace(core=SimpleNamespace(cfg=SimpleNamespace(max_num_seqs=4)),
                               shutdown=lambda: None)

    dtype = inspect.signature(port_worker.build_engine).parameters["dtype"].default
    monkeypatch.setattr(port_worker, "build_engine", stub_engine)
    want = _choose(ref_worker.run_pipeline_worker, ref_worker, stage,
                   lambda w: dict(model=w.model, max_model_len=w._max_model_len,
                                  max_num_seqs=w._max_num_seqs, dtype=w._dtype), monkeypatch, path)
    got = _choose(port_worker.run_pipeline_worker, port_worker, stage,
                  lambda w: dict({k: v for k, v in built[-1].items() if k != "device"},
                                 dtype=built[-1].get("dtype", dtype)),
                  monkeypatch, path)
    assert got == want
    if isinstance(got, dict) and got["kind"] == "engine":
        assert built[-1]["device"] == "cuda"  # the port's default, as worker run's


# --- submit / worker dummy / receive over memory:// ---------------------------------

ROWS = [
    {"id": "a", "prompt": "Translate {text}", "text": "hallo", "lang": "de"},
    {"text": "plain text row", "score": 0.5},
    {"messages": [{"role": "user", "content": "chat row"}], "tag": "c"},
    {"question": "2+2?", "prompt": "Q: {question}", "lang": "en"},
    {"nothing": "usable"},
    {"id": "vip", "prompt": "urgent {text}", "text": "now", "priority": "interactive"},
    {"text": "past the limit"},
]
MAPPING = {"source": "unit", "label": "lang", "note": "{lang}!"}
N_SUBMITTED = 5  # --limit: rows 1-4 and 6 (row 5 has nothing to prompt with)


async def _drive(submit, receive, worker_cls, jobs_path, *, stream: bool):
    """submit, a dummy worker until every result is out, then receive."""
    worker = worker_cls("cq", delay=0.0)
    task = asyncio.create_task(worker.run())
    try:
        await submit("cq", str(jobs_path), dict(MAPPING), stream=stream, limit=N_SUBMITTED,
                     priority="batch")
        if not stream:
            await asyncio.wait_for(receive("cq", limit=N_SUBMITTED, timeout=30), 60)
    finally:
        worker.request_shutdown()
        await task


def test_submit_routes_by_prefix_affinity_as_the_reference(tmp_path, monkeypatch, capsys):
    """With ``LLMQ_PREFIX_AFFINITY`` on (once refused by the port's
    submit), the rows that share a worker's advertised template land on
    its private ``<q>.w.<id>`` and the others on ``<q>``, in both
    packages."""
    from llmq_tpu.broker import manager as jmanager
    from llmq_tpu.cli.submit import run_submit as ref_submit
    from llmq_tpu.core import config as jconfig
    from llmq_tpu.core import models as jmodels

    from llmq_tpu_torch.broker import manager as tmanager
    from llmq_tpu_torch.cli.submit import run_submit
    from llmq_tpu_torch.core import config as tconfig
    from llmq_tpu_torch.core import models as tmodels
    from llmq_tpu_torch.utils.hashing import text_prefix_chain

    template = "You are a careful translator. " * 10
    jobs = tmp_path / "aff.jsonl"
    jobs.write_text("\n".join(json.dumps(r) for r in (
        {"prompt": template + "Translate: hallo"}, {"text": "a short unrelated row"},
        {"prompt": template + "Translate: danke"})) + "\n")

    async def drive(submit, manager, config, models):
        mgr = manager.BrokerManager(config.get_config())
        await mgr.connect()
        await mgr.setup_queue_infrastructure("aq")
        health = models.WorkerHealth(worker_id="w1", status="running", jobs_processed=1,
                                     last_seen=models.utcnow(),
                                     prefix_chains=text_prefix_chain(template))
        await mgr.broker.publish("aq.health", health.model_dump_json().encode("utf-8"))
        await submit("aq", str(jobs), {})
        depths = [(await mgr.get_queue_stats(q)).message_count for q in ("aq.w.w1", "aq")]
        await mgr.disconnect()
        return depths

    monkeypatch.setenv("LLMQ_PREFIX_AFFINITY", "1")
    depths = []
    for pkg in ((ref_submit, jmanager, jconfig, jmodels),
                (run_submit, tmanager, tconfig, tmodels)):
        monkeypatch.setenv("LLMQ_BROKER_URL", f"memory://client-aff-{uuid.uuid4().hex[:8]}")
        depths.append(asyncio.run(drive(*pkg)))
    capsys.readouterr()
    assert depths == [[2, 1], [2, 1]]


def _lines(out: str) -> dict:
    results = {}
    for line in out.strip().splitlines():
        r = json.loads(line)
        for key in ("worker_id", "duration_ms", "timestamp", "trace"):
            r.pop(key, None)
        # Ids the submitter makes are <run id>-<row number>.
        r["id"] = r["id"].split("-", 1)[-1]
        results[r["id"]] = r
    return results


@pytest.mark.parametrize("stream", [False, True], ids=["receive", "stream"])
def test_submit_dummy_receive_print_the_reference_lines(stream, tmp_path, monkeypatch, capsys):
    from llmq_tpu.cli.receive import run_receive as ref_receive
    from llmq_tpu.cli.submit import run_submit as ref_submit
    from llmq_tpu.workers.dummy import DummyWorker as RefDummy

    from llmq_tpu_torch.cli.receive import run_receive
    from llmq_tpu_torch.cli.submit import run_submit
    from llmq_tpu_torch.workers.dummy import DummyWorker

    jobs = tmp_path / "jobs.jsonl"
    jobs.write_text("not json\n" + "\n".join(json.dumps(r) for r in ROWS) + "\n")
    outs = []
    for submit, receive, worker in ((ref_submit, ref_receive, RefDummy),
                                    (run_submit, run_receive, DummyWorker)):
        monkeypatch.setenv("LLMQ_BROKER_URL", f"memory://client-{uuid.uuid4().hex[:8]}")
        asyncio.run(_drive(submit, receive, worker, jobs, stream=stream))
        outs.append(_lines(capsys.readouterr().out))
    want, got = outs
    assert got == want
    assert sorted(got) == ["2", "3", "4", "a", "vip"]
    assert got["a"]["result"] == "echo Translate hallo" and got["a"]["note"] == "de!"
    assert got["3"]["result"] == "echo chat row" and got["3"]["prompt"] == ""
    assert got["4"]["result"] == "echo Q: 2+2?" and got["4"]["source"] == "unit"
    assert got["vip"]["priority"] == "interactive" and got["2"]["priority"] == "batch"


# --- the operator commands ------------------------------------------------------------

async def _operator_session(manager_cls, job_cls, health_cls, utcnow, monitor):
    """Dead letters, heartbeats (one stale) and a backlog on ``oq``, then
    every operator command of ``monitor``."""
    from datetime import timedelta

    async with manager_cls() as mgr:
        await mgr.setup_queue_infrastructure("oq")
        await mgr.broker.declare_queue("oq.health", max_redeliveries=10**9)
        for i in range(3):
            job = job_cls(id=f"f{i}", prompt="p")
            await mgr.broker.publish("oq.failed", job.model_dump_json().encode(),
                                     message_id=job.id,
                                     headers={"x-error": "boom", "x-failure-reason": "timeout",
                                              "x-delivery-count": 2, "x-worker-id": "w1"})
        for i in range(2):
            job = job_cls(id=f"j{i}", prompt="p")
            await mgr.publish_job("oq", job)
        for wid, age in (("w-fresh", 0), ("w-stale", 300)):
            beat = health_cls(worker_id=wid, status="running", jobs_processed=5, queue="oq",
                              last_seen=utcnow() - timedelta(seconds=age), reconnects=1,
                              avg_duration_ms=12.0)
            await mgr.broker.publish("oq.health", beat.model_dump_json().encode())
        await monitor.show_status("oq")
        await monitor.check_health("oq")
        await monitor.show_errors("oq", limit=2)
        await monitor.requeue_errors("oq", limit=2)
        await monitor.show_errors("missing")
        await monitor.clear_queue("oq")
        await monitor.show_connection_status()


REFERENCE_MESSAGES = [
    "⚠ No consumers — jobs will sit in the queue until a worker attaches",
    "1 worker(s) stale (no heartbeat in 60s)",
    "Requeued 2 failed job(s) from 'oq.failed' back to 'oq' (1 still dead-lettered",
    "No dead-lettered jobs in 'missing.failed'",
    "Purged 4 messages from 'oq'",
    "Connected to broker at memory://",
]


def test_operator_commands_print_the_reference_fields(monkeypatch, capsys):
    from llmq_tpu.broker.manager import BrokerManager as RefManager
    from llmq_tpu.cli import monitor as ref_monitor
    from llmq_tpu.core import models as ref_models

    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.cli import monitor
    from llmq_tpu_torch.core import models

    monkeypatch.setattr(ref_monitor.console, "width", 200)
    outs = []
    for mgr, mod, mon in ((RefManager, ref_models, ref_monitor),
                          (BrokerManager, models, monitor)):
        monkeypatch.setenv("LLMQ_BROKER_URL", f"memory://ops-{uuid.uuid4().hex[:8]}")
        asyncio.run(_operator_session(mgr, mod.Job, mod.WorkerHealth, mod.utcnow, mon))
        outs.append(capsys.readouterr().out)
    want, got = outs
    for message in REFERENCE_MESSAGES:
        assert message in want and message in got, message
    for field in ("w-fresh", "w-stale", "stale", "boom", "timeout", "f0", "f1", "oq.results",
                  "oq.failed", "reconnects", "redeliveries"):
        assert field in want and field in got, field
    assert "f2" not in got.split("Requeued")[0]  # --limit 2 lists two


# --- monitor top and trace (M16) ----------------------------------------------------------

def _plain(markup: str) -> str:
    from rich.text import Text

    return Text.from_markup(markup).plain


def _fleet(models):
    """Three heartbeats: a busy auto worker with every optional column's
    field, a stale decode worker with a tripped breaker, a bare one."""
    from datetime import timedelta

    now = models.utcnow()
    busy = dict(tokens_per_sec=812.345, batch_occupancy=0.5, prefix_hit_rate=0.25,
                ttft_p50_ms=120.4, ttft_p95_ms=300.6, itl_p50_ms=7.1, itl_p95_ms=9.9,
                ttft_p95_ms_interactive=200.0, itl_p95_ms_interactive=8.2, jobs_quarantined=2,
                kv_fetch_failures=1, priority_preemptions=3, handoff_ms_p50=100.0,
                handoff_ms_p95=210.0, role_mode="auto", guard_trips=1)
    return {
        "w-a": models.WorkerHealth(worker_id="w-a", status="running", jobs_processed=40,
                                   last_seen=now, engine_stats=busy, reconnects=1,
                                   integrity="ok", role="prefill"),
        "w-b": models.WorkerHealth(worker_id="w-b", status="running", jobs_processed=3,
                                   last_seen=now - timedelta(minutes=5), role="decode",
                                   engine_stats=dict(breaker_tripped=True,
                                                     wedged_dispatch="decode", batch_occupancy=0.9),
                                   integrity="suspect"),
        "w-c": models.WorkerHealth(worker_id="w-c", status="stopping", jobs_processed=0,
                                   last_seen=now),
    }


@pytest.mark.parametrize("top", [40, 2])
def test_monitor_top_cells_equal_the_reference(top):
    """The dashboard's summary, columns, cells and caption over the same
    heartbeats, the reference's ``rich`` markup dropped."""
    from llmq_tpu.cli import monitor as ref_monitor
    from llmq_tpu.core import models as ref_models

    from llmq_tpu_torch.cli import monitor
    from llmq_tpu_torch.core import models

    kw = dict(quarantine_depth=4, top=top, decode_depth=7, interactive_depth=2)
    group = ref_monitor._render_top(
        "q", _fleet(ref_models), ref_models.QueueStats(queue_name="q", message_count_ready=9),
        **kw)
    header, table = group.renderables
    want = (_plain(header), table.title, [c.header for c in table.columns],
            [[_plain(cell) for cell in row] for row in zip(*(c._cells for c in table.columns))],
            table.caption)
    got = monitor._top_frame("q", _fleet(models),
                             models.QueueStats(queue_name="q", message_count_ready=9), **kw)
    assert got == want
    assert len(got[3]) == min(top, 3) and "WEDGED:decode BRK" in str(got[3])
    text = monitor._render_top("q", _fleet(models),
                               models.QueueStats(queue_name="q", message_count_ready=9), **kw)
    assert text.startswith(got[0]) and all(cell in text for row in got[3] for cell in row)


async def _trace_session(pkg, monitor, job_id: str) -> None:
    """A result with a trace and a dead letter on ``tq``, then ``trace``."""
    async with pkg.manager.BrokerManager() as mgr:
        await mgr.setup_queue_infrastructure("tq")
        rec = pkg.trace.new_trace("done-1")
        for name, fields in (("submitted", {"queue": "tq"}), ("claimed", {"worker_id": "w"}),
                             ("first_token", {}), ("finished", {"duration_ms": 12.5})):
            pkg.trace.trace_event(rec, name, **fields)
        rec["redeliveries"] = 1
        result = {"id": "done-1", "prompt": "p", "result": "r", "worker_id": "w",
                  "duration_ms": 12.5, "trace": rec}
        await mgr.broker.publish("tq.results", json.dumps(result).encode(), message_id="done-1")
        dead = pkg.trace.new_trace("dead-1")
        pkg.trace.trace_event(dead, "submitted", queue="tq")
        await mgr.broker.publish("tq.failed", json.dumps({"id": "dead-1", "prompt": "p",
                                                          "trace": dead}).encode(),
                                 message_id="dead-1",
                                 headers={"x-death-queue": "tq", "x-delivery-count": 4})
        await monitor.trace_job("tq", job_id)
        # trace peeks: both messages are still there
        assert (await mgr.get_queue_stats("tq.results")).message_count == 1
        assert (await mgr.get_queue_stats("tq.failed")).message_count == 1


def _rows(out: str) -> list:
    """A table's rows, from ``rich`` box lines or the port's plain table."""
    import re

    if "│" in out:
        return [[c.strip() for c in re.split("[│┃]", line)[1:-1]] for line in out.splitlines()
                if re.search("[│┃]", line)]

    lines = out.splitlines()
    head = next(i for i, line in enumerate(lines) if line.startswith("event"))
    starts = [m.start() for m in re.finditer(r"\S+( \S+)*", lines[head])]
    return [[line[a:b].strip() for a, b in zip(starts, starts[1:] + [None])]
            for line in [lines[head]] + lines[head + 2:] if line and not line.startswith("total")]


@pytest.mark.parametrize("job_id", ["done-1", "dead-1", "missing"])
def test_trace_prints_the_reference_rows(job_id, monkeypatch, capsys):
    """``trace``: the timeline of a result's trace, a dead letter's (its
    death headers and a synthesized ``retry_exhausted``), or the message
    for a job with neither; the same events, clocks, deltas and details
    as the reference's table."""
    from llmq_tpu.broker import manager as jmanager
    from llmq_tpu.cli import monitor as ref_monitor
    from llmq_tpu.obs import trace as jtrace

    from llmq_tpu_torch.broker import manager as tmanager
    from llmq_tpu_torch.cli import monitor
    from llmq_tpu_torch.obs import trace as ttrace

    from llmq_tpu.utils import clock as jclock

    from llmq_tpu_torch.utils import clock as tclock

    class Frozen:  # the events' clocks, so both tables show the same times
        def monotonic(self):
            return 500.0

        def time(self):
            return 1_700_000_000.25

    monkeypatch.setattr(ref_monitor.console, "width", 200)
    outs = []
    try:
        for pkg, mon, clk in ((SimpleNamespace(manager=jmanager, trace=jtrace), ref_monitor,
                               jclock),
                              (SimpleNamespace(manager=tmanager, trace=ttrace), monitor, tclock)):
            clk.set_clock(Frozen())
            monkeypatch.setenv("LLMQ_BROKER_URL", f"memory://trace-{uuid.uuid4().hex[:8]}")
            asyncio.run(_trace_session(pkg, mon, job_id))
            outs.append(capsys.readouterr().out)
    finally:
        jclock.set_clock(jclock.Clock())
        tclock.set_clock(tclock.Clock())
    want, got = outs
    if job_id == "missing":
        assert want.strip().lstrip("✗ ") == got.strip().lstrip("✗ ")
        return
    rows = _rows(got)
    assert rows == _rows(want)
    assert len(rows) == (5 if job_id == "done-1" else 3)
    for line in want.splitlines():
        if line.startswith(("Job ", "total", "Trace:")):
            assert line.strip() in got
