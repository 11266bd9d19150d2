"""The port's client and operator commands, held against the JAX package.

- Every ported command (``submit``, ``receive``, the hidden ``pipeline`` /
  ``receive-pipeline``, ``status``, ``health``, ``errors``, ``clear``,
  ``worker run`` / ``dummy`` / ``dedup`` / ``pipeline``, ``broker serve``)
  takes the reference's click arguments and options, with their names,
  flags, choices and defaults, as argparse actions; ``serve``, ``monitor
  top``, ``trace`` and ``broker serve --native`` are refused with their
  ROADMAP item.
- ``run_pipeline_worker`` picks the reference's worker type for each stage
  type, with the reference's arguments, and exits 1 where it does.
- ``submit``, ``worker dummy`` and ``receive`` over ``memory://`` print the
  reference's result lines (ids, results, extras), and ``submit --stream``
  streams them; the operator commands print the reference's fields.
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
    out = {name: p for name, p in groups.items() if name not in ("worker", "broker")}
    for group in ("worker", "broker"):
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
          "clear", "worker run", "worker dummy", "worker dedup", "worker pipeline",
          "broker serve")
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


@pytest.mark.parametrize("argv,item", [
    (["serve", "q", "--port", "0"], "M16"), (["trace", "job-1", "-q", "q"], "M16"),
    (["monitor", "top", "q", "--once"], "M16"), (["broker", "serve", "--native"], "Out of scope"),
])
def test_unported_commands_are_refused_with_their_item(argv, item):
    assert argv[0] in _ref_commands() or f"{argv[0]} {argv[1]}" in _ref_commands()
    with pytest.raises(NotImplementedError, match=item):
        port_main.main(argv)


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
