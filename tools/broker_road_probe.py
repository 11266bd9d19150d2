#!/usr/bin/env python3
"""What a large payload costs on the port's tcp:// road, on the host alone.

    python3 tools/broker_road_probe.py [--jobs 16] [--job-mb 7.0] [--pages 34]

Starts the port's ``BrokerServer`` in a process of its own and times,
with message bodies as raw bytes after each frame's JSON (``raw``) and as
JSON text (``text``, what the reference's daemon and client exchange):

- ``jobs``: ``--jobs`` handoff-sized job bodies (a JSON job whose base64
  snapshot decodes to ``--job-mb`` MB) published back to back and
  consumed by a second client; the publish-all time, the drain time and
  the per-job latency from the body's stamp to its parse (p50, max);
- ``fetch``: one prefix-page fetch reply of ``--pages`` qwen2.5-3b pages
  (36 layers, page 32, 2 KV heads of 128, bf16 bits) as
  ``TorchWorker._serve_kv_fetch`` builds it and ``_fetch_from_peer``
  checks and decodes it, each stage timed: the chunk codec and base64,
  the outer digests, the reply's JSON, the publish, the get, the parse,
  the requester's digests, the chunk decode.

Prints one JSON line per mode. No GPU and no engine: the host's share of
a handoff or a fetch, measured apart from the card.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from llmq_tpu_torch.broker.tcp import BrokerServer, TcpBroker  # noqa: E402
from llmq_tpu_torch.engine import prefix_store  # noqa: E402
from llmq_tpu_torch.workers.torch_worker import _chunk_digest, _chunks_reply  # noqa: E402


def _serve(port_q) -> None:
    async def main() -> None:
        server = BrokerServer("127.0.0.1", 0)
        await server.start()
        port_q.put(server._server.sockets[0].getsockname()[1])
        await asyncio.Event().wait()

    asyncio.run(main())


class _TextBroker(TcpBroker):
    """A client that never asks for raw bodies, as the reference's."""

    async def _request(self, obj, body=None):
        return await super()._request({k: v for k, v in obj.items() if k != "raw_body"}, body)


async def _client(port: int, raw: bool) -> TcpBroker:
    broker = (TcpBroker if raw else _TextBroker)(f"tcp://127.0.0.1:{port}")
    await broker.connect()
    return broker


async def _jobs(port: int, raw: bool, n: int, job_mb: float) -> dict:
    pub, sub = await _client(port, raw), await _client(port, raw)
    queue = f"jobs-{raw}"
    await pub.declare_queue(queue)
    snapshot = base64.b64encode(os.urandom(int(job_mb * 1e6))).decode("ascii")
    latency, done = [], asyncio.Event()

    async def take(message) -> None:
        latency.append(time.time() - json.loads(message.body)["stamp"])
        await message.ack()
        if len(latency) == n:
            done.set()

    await sub.consume(queue, take, prefetch=8)
    t0 = time.perf_counter()
    for i in range(n):
        await pub.publish(queue, json.dumps({"id": f"j{i}", "stamp": time.time(),
                                             "llmq_resume": {"snapshot": snapshot}}).encode())
    published = time.perf_counter() - t0
    await done.wait()
    drained = time.perf_counter() - t0
    await pub.close()
    await sub.close()
    latency.sort()
    return dict(jobs=n, body_mb=(len(snapshot) + 64) / 1e6, publish_all_s=published,
                drain_s=drained, latency_p50_s=latency[n // 2], latency_max_s=latency[-1])


async def _fetch(port: int, raw: bool, n_pages: int) -> dict:
    a, b = await _client(port, raw), await _client(port, raw)
    queue = f"reply-{raw}"
    await a.declare_queue(queue)
    rng = np.random.default_rng(0)
    shape = (36, 32, 2, 128)  # qwen2.5-3b: layers, page, KV heads, head dim
    pages = [(rng.bytes(16), rng.integers(0, 1 << 16, shape, dtype=np.uint16),
              rng.integers(0, 1 << 16, shape, dtype=np.uint16)) for _ in range(n_pages)]
    t, stages = time.perf_counter(), {}

    def lap(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        stages[name] = now - t
        t = now

    chunks = [prefix_store.chunk_to_b64(prefix_store.chunk_to_bytes(
        key, k, v, model_sig={"probe": 1}, page_size=32)) for key, k, v in pages]
    lap("export_codec_b64_s")
    body = _chunks_reply("probe", chunks)
    lap("reply_build_with_digests_s")
    await a.publish(queue, body)
    lap("publish_s")
    message = await b.get(queue)
    lap("get_s")
    reply = json.loads(message.body)
    lap("parse_s")
    ok = all(_chunk_digest(c) == d for c, d in zip(reply["chunks"], reply["digests"]))
    lap("requester_digests_s")
    for c in reply["chunks"]:
        prefix_store.chunk_from_bytes(prefix_store.chunk_from_b64(c))
    lap("ingest_codec_s")
    await message.ack()
    await a.close()
    await b.close()
    return dict(pages=n_pages, reply_mb=len(body) / 1e6, digests_ok=ok,
                total_s=sum(stages.values()), **stages)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--job-mb", type=float, default=7.0,
                    help="the snapshot's MB before base64 (9.4 MB of JSON a job at 7.0)")
    ap.add_argument("--pages", type=int, default=34)
    args = ap.parse_args()
    port_q: mp.Queue = mp.Queue()
    server = mp.Process(target=_serve, args=(port_q,), daemon=True)
    server.start()
    try:
        port = port_q.get(timeout=60)
        for raw in (True, False):
            rec = dict(probe="broker_road", mode="raw" if raw else "text",
                       jobs=asyncio.run(_jobs(port, raw, args.jobs, args.job_mb)),
                       fetch=asyncio.run(_fetch(port, raw, args.pages)))
            print(json.dumps(rec), flush=True)
    finally:
        server.terminate()
        server.join(10)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
