"""Command line of the port (counterpart of ``llmq_tpu/cli/main.py``).

    python -m llmq_tpu_torch worker run MODEL QUEUE [options]

``worker run`` serves ``QUEUE`` from the broker at ``LLMQ_BROKER_URL``
(``tcp://host:port`` for the llmq broker daemon, the reference's or the
port's ``broker/tcp.py::BrokerServer``; ``file:///dir`` for the on-disk
broker; ``memory://`` in process; any of them behind ``chaos+``) with
MODEL, a ``preset://NAME`` or an HF checkpoint directory, through
:func:`cli.worker.run_torch_worker`, until a SIGINT or SIGTERM stops it
(the jobs in flight are handed back to the queue as resumable snapshots,
which a peer continues; the process exits 0). The worker's queue and
failure policy come from the environment (``core/config.py``:
``LLMQ_JOB_TTL_MINUTES``, ``LLMQ_MAX_REDELIVERIES``,
``LLMQ_JOB_TIMEOUT_S``, ``LLMQ_QUARANTINE_ATTEMPTS``,
``LLMQ_BREAKER_FAILURES``, ``LLMQ_RECONNECT_*``, ...); a variable of a
feature the port lacks is refused with its ROADMAP item. ``argparse``, not click: the port's machines need no
package beyond torch, numpy and pydantic.

The options of the reference's ``worker run`` (:336-412) that the port
serves keep their names: ``-c/--concurrency``, ``--max-num-seqs``,
``--max-model-len``, ``--dtype``, ``--kv-dtype``, ``--prefill-chunk``,
``--prefix-caching``, ``--prefix-host-gb``, ``--decode-block``,
``--spec-tokens``, ``--mixed-step``, ``--role`` (unified, prefill or
decode). The others are accepted and, set to anything but
their default, raise ``NotImplementedError`` with their ROADMAP item. One
option is the port's own: ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch path). ``--log-level`` (default ``LLMQ_LOG_LEVEL``, else
INFO) sets the root logger's level, as the reference's ``setup_logging``
reads ``LLMQ_LOG_LEVEL``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Callable, List, Optional

from llmq_tpu_torch.core.config import get_config

#: option (argparse dest) -> (is it turned on?, ROADMAP.md queue 1 item)
UNPORTED_OPTIONS = {
    "tensor_parallel": (lambda v: v is not None and v > 1, "M13"),
    "data_parallel": (lambda v: v > 1, "M13"),
    "sequence_parallel": (lambda v: v > 1, "M13"),
    "tp_overlap": (lambda v: v not in (None, "off"), "M13"),
    "role": (lambda v: v == "auto", "M6"),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m llmq_tpu_torch",
        description="llmq worker of the PyTorch/CUDA port")
    groups = parser.add_subparsers(dest="group", required=True)
    worker = groups.add_parser("worker", help="run workers")
    commands = worker.add_subparsers(dest="command", required=True)
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


def main(argv: Optional[List[str]] = None,
         run_worker: Optional[Callable[..., object]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=(args.log_level or get_config().log_level).upper(),
                        stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    kwargs = worker_run_kwargs(args)
    if run_worker is None:
        from llmq_tpu_torch.cli.worker import run_torch_worker as run_worker
    print(f"Starting torch worker: model={args.model} queue={args.queue} "
          f"device={args.device}" + (f" role={args.role}" if args.role else ""),
          file=sys.stderr, flush=True)
    run_worker(args.model, args.queue, **kwargs)
    return 0
