"""Command line of the port (counterpart of ``llmq_tpu/cli/main.py``).

    python -m llmq_tpu_torch worker run MODEL QUEUE [options]
    python -m llmq_tpu_torch worker pipeline PIPELINE_FILE STAGE [-c N] [--device cuda]
    python -m llmq_tpu_torch worker dummy QUEUE | worker dedup QUEUE
    python -m llmq_tpu_torch submit QUEUE SOURCE [--map f=TPL ...] [--stream] [--limit N]
    python -m llmq_tpu_torch submit -p PIPELINE_FILE SOURCE ...
    python -m llmq_tpu_torch receive [-p] QUEUE_OR_PIPELINE [--timeout S] [--limit N]
    python -m llmq_tpu_torch status [QUEUE] [-p PIPELINE_FILE] | health QUEUE
    python -m llmq_tpu_torch errors QUEUE [--limit N] [--requeue] | clear QUEUE [--yes]
    python -m llmq_tpu_torch broker serve [--host H] [--port P] [--persist-dir DIR]
    python -m llmq_tpu_torch serve QUEUE [--host H] [--port P] [--model-name M] [--priority C]
    python -m llmq_tpu_torch trace JOB_ID -q QUEUE
    python -m llmq_tpu_torch monitor top QUEUE [--interval S] [--once] [--top N]

Every command takes the reference's arguments, options and defaults
(``argparse``, not click: the port's machines need no package beyond
torch, numpy and pydantic), and the hidden ``pipeline`` / ``receive-pipeline``
aliases of ``submit -p`` / ``receive -p``. The broker is the one at
``LLMQ_BROKER_URL`` (``tcp://host:port`` for the llmq broker daemon, the
reference's or the port's ``broker serve``; ``file:///dir`` for the on-disk
broker; ``memory://`` in process; any of them behind ``chaos+``).

``worker run`` serves ``QUEUE`` with MODEL, a ``preset://NAME`` or an HF
checkpoint directory, through :func:`cli.worker.run_torch_worker`, until
a SIGINT or SIGTERM stops it (the jobs in flight are handed back to the
queue as resumable snapshots, which a peer continues; the process exits
0). The worker's queue and failure policy come from the environment
(``core/config.py``); a variable of a feature the port lacks is refused
with its ROADMAP item. The options of the reference's ``worker run``
(:336-412) that the port serves keep their names: ``-c/--concurrency``,
``--max-num-seqs``, ``--max-model-len``, ``--dtype``, ``--kv-dtype``,
``--prefill-chunk``, ``--prefix-caching``, ``--prefix-host-gb``,
``--decode-block``, ``--spec-tokens``, ``--mixed-step``, ``--role``
(unified, prefill, decode or auto). The others are accepted and, set to
anything but their default, raise ``NotImplementedError`` with their
ROADMAP item. ``worker run`` and ``worker pipeline`` take one option of
the port's own: ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path). ``worker run``'s ``--log-level`` (default
``LLMQ_LOG_LEVEL``, else INFO) sets the root logger's level.

``serve`` runs the OpenAI-compatible HTTP/SSE gateway (``gateway/``) in
front of QUEUE until interrupted (``--port`` default: ``LLMQ_SERVE_PORT``,
8100; 0 binds a free port, printed on its first line); ``trace`` prints a
job's lifecycle timeline; ``monitor top`` the fleet dashboard over the
heartbeats (``--once``: one refresh).

Refused (``NotImplementedError``): ``broker serve --native`` (the C++
daemon, out of scope). ``lint`` and ``sim`` are out of scope.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys
import threading
import time
from typing import Callable, List, Optional

from llmq_tpu_torch import __version__
from llmq_tpu_torch.utils.logging import setup_logging

#: option (argparse dest) -> (is it turned on?, ROADMAP.md queue 1 item)
UNPORTED_OPTIONS = {
    "tensor_parallel": (lambda v: v is not None and v > 1, "M13"),
    "data_parallel": (lambda v: v > 1, "M13"),
    "sequence_parallel": (lambda v: v > 1, "M13"),
    "tp_overlap": (lambda v: v not in (None, "off"), "M13"),
}


def _add_submit_options(p: argparse.ArgumentParser, *, pipeline_flag: bool) -> None:
    p.add_argument("--map", dest="map_args", action="append", default=[],
                   help="field=TEMPLATE mapping")
    if pipeline_flag:
        p.add_argument("-p", "--pipeline", dest="is_pipeline", action="store_true",
                       help="QUEUE arg is a pipeline YAML")
    p.add_argument("--stream", action="store_true",
                   help="Stream results to stdout while submitting")
    p.add_argument("--split", default="train", help="HF dataset split")
    p.add_argument("--subset", default=None, help="HF dataset subset/config name")
    p.add_argument("--limit", type=int, default=None, help="Submit at most N jobs")


def _add_receive_options(p: argparse.ArgumentParser, *, pipeline_flag: bool) -> None:
    if pipeline_flag:
        p.add_argument("-p", "--pipeline", dest="is_pipeline", action="store_true",
                       help="Arg is a pipeline YAML")
    p.add_argument("--timeout", type=float, default=None,
                   help="Idle timeout seconds (exit when no results)")
    p.add_argument("--limit", type=int, default=None, help="Stop after N results")


def _add_worker_run(commands) -> None:
    run = commands.add_parser("run", help="serve a queue with a model")
    run.add_argument("model", help="preset://NAME or an HF checkpoint directory")
    run.add_argument("queue")
    run.add_argument("-c", "--concurrency", type=int, default=None,
                     help="Override prefetch/in-flight job count")
    run.add_argument("--max-num-seqs", type=int, default=None, help="Engine batch slots")
    run.add_argument("--max-model-len", type=int, default=None, help="Context window cap")
    run.add_argument("--dtype", default="bfloat16",
                     choices=["bfloat16", "float32", "int8", "int4"],
                     help="int8 / int4: weight-only quantization, bf16 compute")
    run.add_argument("--kv-dtype", default=None, choices=["auto", "bf16", "fp8", "fp8_e5m2"],
                     help="KV cache storage dtype (default: the compute dtype or LLMQ_KV_DTYPE)")
    run.add_argument("--prefill-chunk", type=int, default=None,
                     help="Chunked prefill: positions per chunk")
    run.add_argument("--prefix-caching", action="store_true",
                     help="Reuse cached KV for shared prompt prefixes (needs --prefill-chunk)")
    run.add_argument("--prefix-host-gb", type=float, default=None,
                     help="Host-RAM tier (GiB) for evicted prefix pages (needs "
                          "--prefix-caching; LLMQ_PREFIX_HOST_GB)")
    run.add_argument("--decode-block", type=int, default=None,
                     help="Fused decode: device iterations per dispatch (LLMQ_DECODE_BLOCK)")
    run.add_argument("--spec-tokens", type=int, default=None,
                     help="Speculative decoding: draft tokens per step (LLMQ_SPEC_TOKENS)")
    run.add_argument("--mixed-step", default=None, choices=["off", "on"],
                     help="Piggyback prefill chunks into decode dispatches (needs "
                          "--prefill-chunk; LLMQ_MIXED_STEP)")
    run.add_argument("--role", default=None, choices=["unified", "prefill", "decode", "auto"],
                     help="Disaggregated serving: 'prefill' runs the prompt phase and hands "
                          "each job to <queue>.decode; 'decode' serves <queue>.decode. "
                          "Default: LLMQ_WORKER_ROLE or unified")
    run.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu (the plain PyTorch path)")
    run.add_argument("--log-level", default=None,
                     help="Logging level (default: LLMQ_LOG_LEVEL, else INFO)")
    # The reference's options that the port does not serve yet.
    run.add_argument("-tp", "--tensor-parallel", type=int, default=None)
    run.add_argument("-dp", "--data-parallel", type=int, default=1)
    run.add_argument("-sp", "--sequence-parallel", type=int, default=1)
    run.add_argument("--tp-overlap", default=None, choices=["off", "on", "auto"])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m llmq_tpu_torch",
        description="llmq of the PyTorch/CUDA port: queue-based LLM batch inference")
    parser.add_argument("--version", action="version",
                        version=f"llmq_tpu_torch, version {__version__}")
    groups = parser.add_subparsers(
        dest="group", required=True,
        metavar="{submit,receive,status,health,errors,clear,trace,serve,monitor,worker,broker}")

    submit = groups.add_parser("submit", help="Submit jobs from a JSONL file, '-' (stdin), "
                                              "or an HF dataset")
    submit.add_argument("queue_or_pipeline")
    submit.add_argument("source")
    _add_submit_options(submit, pipeline_flag=True)
    submit.add_argument("--priority", choices=["interactive", "batch"], default=None,
                        help="SLO class stamped on every job (row-level fields win)")
    receive = groups.add_parser("receive", help="Receive results as JSONL on stdout")
    receive.add_argument("queue_or_pipeline")
    _add_receive_options(receive, pipeline_flag=True)
    # Deprecated aliases of `submit -p` / `receive -p`, hidden as in the reference.
    pipeline = groups.add_parser("pipeline")
    pipeline.add_argument("pipeline_path")
    pipeline.add_argument("source")
    _add_submit_options(pipeline, pipeline_flag=False)
    receive_pipeline = groups.add_parser("receive-pipeline")
    receive_pipeline.add_argument("pipeline_path")
    _add_receive_options(receive_pipeline, pipeline_flag=False)

    status = groups.add_parser("status", help="Show connection, queue, or pipeline status")
    status.add_argument("queue", nargs="?", default=None)
    status.add_argument("-p", "--pipeline", dest="pipeline_path", default=None,
                        help="Pipeline YAML to visualize")
    health = groups.add_parser("health", help="Heuristic health check for a queue")
    health.add_argument("queue")
    errors = groups.add_parser("errors", help="List dead-lettered jobs from <queue>.failed")
    errors.add_argument("queue")
    errors.add_argument("--limit", type=int, default=10,
                        help="Max jobs to list, or to move with --requeue (0 = all)")
    errors.add_argument("--requeue", action="store_true",
                        help="Move the failed jobs back onto the queue for retry")
    clear = groups.add_parser("clear", help="Purge all ready messages from a queue")
    clear.add_argument("queue")
    clear.add_argument("--yes", action="store_true", help="Skip confirmation")
    trace = groups.add_parser("trace", help="Show a job's lifecycle timeline from the trace "
                                            "record in its result")
    trace.add_argument("job_id")
    trace.add_argument("-q", "--queue", required=True,
                       help="Queue the job was submitted to (its .results queue is peeked "
                            "non-destructively)")
    serve = groups.add_parser("serve", help="Run the OpenAI-compatible HTTP/SSE gateway in "
                                            "front of QUEUE")
    serve.add_argument("queue")
    serve.add_argument("--host", default="127.0.0.1", help="Bind address for the HTTP server")
    serve.add_argument("--port", type=int, default=None,
                       help="Bind port (default: config serve_port / LLMQ_SERVE_PORT; "
                            "0 = ephemeral)")
    serve.add_argument("--model-name", default="llmq-tpu",
                       help="Model id reported by /v1/models and in responses")
    serve.add_argument("--priority", choices=["interactive", "batch"], default="interactive",
                       help="Default SLO class for requests that don't set one")
    monitor = groups.add_parser("monitor", help="Live observability dashboards")
    monitor_commands = monitor.add_subparsers(dest="command", required=True)
    top = monitor_commands.add_parser("top", help="Live fleet dashboard from fresh worker "
                                                  "heartbeats")
    top.add_argument("queue")
    top.add_argument("--interval", type=float, default=2.0, help="Refresh period in seconds")
    top.add_argument("--once", action="store_true",
                     help="Render one snapshot and exit (scripts/tests)")
    top.add_argument("--top", dest="top_n", type=int, default=40,
                     help="Rows to render: the N busiest workers by occupancy")

    worker = groups.add_parser("worker", help="run workers")
    commands = worker.add_subparsers(dest="command", required=True)
    _add_worker_run(commands)
    dummy = commands.add_parser("dummy", help="Run a dummy echo worker (testing)")
    dummy.add_argument("queue")
    dummy.add_argument("-c", "--concurrency", type=int, default=None)
    dummy.add_argument("--delay", type=float, default=1.0,
                       help="Simulated processing seconds per job")
    dedup = commands.add_parser("dedup", help="Run a semantic dedup/filter worker")
    dedup.add_argument("queue")
    dedup.add_argument("--batch-size", type=int, default=256)
    dedup.add_argument("--mode", choices=["dedup", "outliers", "representative"],
                       default="dedup")
    dedup.add_argument("--threshold", type=float, default=0.9,
                       help="Similarity threshold for duplicate detection")
    dedup.add_argument("--embedding", choices=["lexical", "model"], default="lexical",
                       help="Similarity backend: lexical n-grams, or a model's embedding table")
    dedup.add_argument("--model", default=None,
                       help="Local HF checkpoint dir for --embedding model")
    stage = commands.add_parser("pipeline", help="Run a worker for one STAGE of a pipeline")
    stage.add_argument("config_path")
    stage.add_argument("stage")
    stage.add_argument("-c", "--concurrency", type=int, default=None)
    stage.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu (the plain PyTorch path), for tpu stages")

    broker = groups.add_parser("broker", help="Run the self-hosted broker daemon")
    broker_commands = broker.add_subparsers(dest="command", required=True)
    serve = broker_commands.add_parser("serve", help="Start the llmq broker daemon")
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=5672)
    serve.add_argument("--persist-dir", default=None,
                       help="Journal directory for durability across restarts")
    serve.add_argument("--native", dest="native", action="store_true", default=False,
                       help="The reference's C++ daemon (refused: out of the port's scope)")
    serve.add_argument("--no-native", dest="native", action="store_false")
    return parser


def worker_run_kwargs(args: argparse.Namespace) -> dict:
    """``run_torch_worker``'s arguments from parsed ``worker run`` options;
    raises ``NotImplementedError`` for an unported option turned on."""
    for dest, (turned_on, item) in UNPORTED_OPTIONS.items():
        value = getattr(args, dest)
        if turned_on(value):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(
                f"{flag}={value!r} is not ported yet (ROADMAP.md queue 1, {item})")
    return dict(
        device=args.device, concurrency=args.concurrency, max_num_seqs=args.max_num_seqs,
        max_model_len=args.max_model_len, dtype=args.dtype, kv_dtype=args.kv_dtype,
        prefill_chunk_size=args.prefill_chunk, enable_prefix_caching=args.prefix_caching,
        prefix_host_gb=args.prefix_host_gb, decode_block=args.decode_block,
        spec_tokens=args.spec_tokens, mixed_step=args.mixed_step, role=args.role,
    )


def parse_maps(parser: argparse.ArgumentParser, map_args: List[str]) -> dict:
    """Repeated ``--map field=SPEC`` options -> ``{field: spec}``."""
    from llmq_tpu_torch.core.template import parse_map_spec

    mapping = {}
    for raw in map_args:
        if "=" not in raw:
            parser.error(f"--map must be field=TEMPLATE, got {raw!r}")
        field, _, spec = raw.partition("=")
        mapping[field.strip()] = parse_map_spec(spec)
    return mapping


def _submit(args, mapping: dict, *, is_pipeline: bool, path: str) -> None:
    from llmq_tpu_torch.cli.submit import run_pipeline_submit, run_submit

    kw = dict(stream=args.stream, split=args.split, subset=args.subset, limit=args.limit)
    priority = getattr(args, "priority", None)
    if is_pipeline:
        if priority is not None:
            mapping.setdefault("priority", priority)
        asyncio.run(run_pipeline_submit(path, args.source, mapping, **kw))
    else:
        asyncio.run(run_submit(path, args.source, mapping, priority=priority, **kw))


def _receive(args, *, is_pipeline: bool, path: str) -> None:
    from llmq_tpu_torch.cli.receive import run_pipeline_receive, run_receive

    run = run_pipeline_receive if is_pipeline else run_receive
    asyncio.run(run(path, timeout=args.timeout, limit=args.limit))


def _monitor(args) -> None:
    from llmq_tpu_torch.cli import monitor

    if args.group == "status":
        if args.pipeline_path:
            asyncio.run(monitor.show_pipeline_status(args.pipeline_path))
        elif args.queue:
            asyncio.run(monitor.show_status(args.queue))
        else:
            asyncio.run(monitor.show_connection_status())
    elif args.group == "health":
        asyncio.run(monitor.check_health(args.queue))
    elif args.group == "errors":
        if args.requeue:
            asyncio.run(monitor.requeue_errors(args.queue,
                                               limit=None if args.limit == 0 else args.limit))
        else:
            asyncio.run(monitor.show_errors(args.queue, limit=args.limit))
    else:  # clear
        if not args.yes:
            answer = input(f"Purge all messages from '{args.queue}'? [y/N]: ")
            if answer.strip().lower() not in ("y", "yes"):
                print("Aborted!", file=sys.stderr)
                raise SystemExit(1)
        asyncio.run(monitor.clear_queue(args.queue))


def _broker_serve(args) -> None:
    if args.native:
        raise NotImplementedError(
            "broker serve --native execs the reference's C++ daemon (native/), which is out "
            "of the port's scope (ROADMAP.md, Out of scope)")
    from llmq_tpu_torch.broker.tcp import BrokerServer

    setup_logging(structured=False)
    server = BrokerServer(args.host, args.port, persist_dir=args.persist_dir)
    print(f"llmq broker daemon on {args.host}:{args.port}"
          + (f" (journal: {args.persist_dir})" if args.persist_dir else " (in-memory)"),
          flush=True)
    try:
        asyncio.run(server.serve_forever())
    except KeyboardInterrupt:
        print("broker stopped", flush=True)


def _serve_until_interrupted(gateway) -> None:
    """Block until Ctrl-C (or SIGTERM, which ``_serve`` maps to it)."""
    while True:
        time.sleep(1.0)


def _interrupt(signum, frame) -> None:
    raise KeyboardInterrupt


def _serve(args) -> None:
    from llmq_tpu_torch.gateway import ServingGateway

    setup_logging(structured=False)
    gw = ServingGateway(args.queue, host=args.host, port=args.port, model_name=args.model_name,
                        default_priority=args.priority)
    main = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, _interrupt) if main else None  # stop as on Ctrl-C
    try:
        gw.start()
        print(f"Serving {args.queue} on http://{args.host}:{gw.port} (Ctrl-C to stop)",
              flush=True)
        _serve_until_interrupted(gw)
    except KeyboardInterrupt:
        pass
    finally:
        gw.stop()
        if main:
            signal.signal(signal.SIGTERM, previous)


def _worker(args, run_worker: Optional[Callable[..., object]]) -> None:
    from llmq_tpu_torch.cli import worker

    if args.command == "run":
        setup_logging(structured=False, level=args.log_level)
        kwargs = worker_run_kwargs(args)
        print(f"Starting torch worker: model={args.model} queue={args.queue} "
              f"device={args.device}" + (f" role={args.role}" if args.role else ""),
              file=sys.stderr, flush=True)
        (run_worker or worker.run_torch_worker)(args.model, args.queue, **kwargs)
    elif args.command == "dummy":
        worker.run_dummy_worker(args.queue, concurrency=args.concurrency, delay=args.delay)
    elif args.command == "dedup":
        worker.run_dedup_worker(args.queue, batch_size=args.batch_size, mode=args.mode,
                                threshold=args.threshold, embedding=args.embedding,
                                model=args.model)
    else:  # pipeline
        worker.run_pipeline_worker(args.config_path, args.stage, concurrency=args.concurrency,
                                   device=args.device)


def main(argv: Optional[List[str]] = None,
         run_worker: Optional[Callable[..., object]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    group = args.group
    if group == "serve":
        _serve(args)
    elif group == "trace":
        from llmq_tpu_torch.cli.monitor import trace_job

        asyncio.run(trace_job(args.queue, args.job_id))
    elif group == "monitor":
        from llmq_tpu_torch.cli.monitor import monitor_top

        try:
            asyncio.run(monitor_top(args.queue, interval=args.interval,
                                    iterations=1 if args.once else None, top=args.top_n))
        except KeyboardInterrupt:
            pass
    elif group in ("submit", "pipeline"):
        is_pipeline = group == "pipeline" or args.is_pipeline
        if group == "pipeline":
            print("Warning: `pipeline` is deprecated; use `submit -p`.", file=sys.stderr)
        _submit(args, parse_maps(parser, args.map_args), is_pipeline=is_pipeline,
                path=args.pipeline_path if group == "pipeline" else args.queue_or_pipeline)
    elif group in ("receive", "receive-pipeline"):
        if group == "receive-pipeline":
            print("Warning: `receive-pipeline` is deprecated; use `receive -p`.",
                  file=sys.stderr)
            _receive(args, is_pipeline=True, path=args.pipeline_path)
        else:
            _receive(args, is_pipeline=args.is_pipeline, path=args.queue_or_pipeline)
    elif group in ("status", "health", "errors", "clear"):
        _monitor(args)
    elif group == "broker":
        _broker_serve(args)
    else:
        _worker(args, run_worker)
    return 0
