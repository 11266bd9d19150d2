"""The port's worker command line and its main path through a real broker.

- ``python -m llmq_tpu_torch worker run``: its options parse into
  ``run_torch_worker``'s arguments (monkeypatched, no engine), and each
  unported option of the reference's ``worker run`` raises
  ``NotImplementedError`` naming its ROADMAP item.
- Worker identity (ROADMAP M6's "done when"): the offline
  ``tests/make_hf_fixture.py`` checkpoint served in f32 on the CPU by the
  port's worker, over ``memory://`` and over ``tcp://`` against the
  reference's ``BrokerServer``, gives results identical to a ``TPUWorker``
  run of the same jobs on JAX's CPU backend: ids, usage, text, extras.
- The command as a process: the worker subprocess serves a ``tcp://``
  queue of the reference daemon and exits 0 on SIGTERM.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import pytest

from llmq_tpu_torch.cli import main as cli
from llmq_tpu_torch.core.models import Job

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
QUEUE = "cli"


def test_worker_run_options_parse_into_run_torch_worker_arguments():
    calls = []
    argv = ["worker", "run", "/models/qwen", "jobs", "-c", "12", "--max-num-seqs", "8",
            "--max-model-len", "512", "--dtype", "int8", "--kv-dtype", "fp8",
            "--prefill-chunk", "64", "--prefix-caching", "--device", "cpu", "-tp", "1",
            "--tp-overlap", "off", "--role", "unified"]
    assert cli.main(argv, run_worker=lambda *a, **k: calls.append((a, k))) == 0
    assert calls == [(("/models/qwen", "jobs"), dict(
        device="cpu", concurrency=12, max_num_seqs=8, max_model_len=512, dtype="int8",
        kv_dtype="fp8", prefill_chunk_size=64, enable_prefix_caching=True,
        prefix_host_gb=None, decode_block=None, spec_tokens=None, mixed_step=None,
        role="unified"))]
    cli.main(["worker", "run", "preset://tiny", "q"], run_worker=lambda *a, **k: calls.append(k))
    assert calls[-1] == dict(device="cuda", concurrency=None, max_num_seqs=None,
                             max_model_len=None, dtype="bfloat16", kv_dtype=None,
                             prefill_chunk_size=None, enable_prefix_caching=False,
                             prefix_host_gb=None, decode_block=None, spec_tokens=None,
                             mixed_step=None, role=None)


@pytest.mark.parametrize("option,flag,item", [
    (["-tp", "2"], "--tensor-parallel", "M13"), (["-dp", "2"], "--data-parallel", "M13"),
    (["-sp", "2"], "--sequence-parallel", "M13"),
    (["--tp-overlap", "on"], "--tp-overlap", "M13"), (["--role", "auto"], "--role", "M6"),
])
def test_unported_worker_options_raise_with_their_item(option, flag, item):
    """The multi-device options raise naming M13. ``--role auto`` (M6's
    second part, once refused here) is ported: it reaches the worker."""
    if item == "M6":
        calls = []
        cli.main(["worker", "run", "preset://tiny", "q", *option],
                 run_worker=lambda *a, **k: calls.append(k))
        assert [k["role"] for k in calls] == ["auto"]
        return
    with pytest.raises(NotImplementedError, match=f"{flag}=.*{item}"):
        cli.main(["worker", "run", "preset://tiny", "q", *option],
                 run_worker=lambda *a, **k: pytest.fail("must not start a worker"))


@pytest.mark.parametrize("option,passed", [
    (["--decode-block", "4"], dict(decode_block=4)),
    (["--spec-tokens", "3"], dict(spec_tokens=3)),
    (["--mixed-step", "on", "--prefill-chunk", "64"], dict(mixed_step="on",
                                                         prefill_chunk_size=64)),
    (["--prefix-host-gb", "1.5", "--prefix-caching", "--prefill-chunk", "64"],
     dict(prefix_host_gb=1.5, enable_prefix_caching=True, prefill_chunk_size=64)),
    (["--role", "prefill"], dict(role="prefill")),
    (["--role", "decode"], dict(role="decode")),
])
def test_fused_mode_options_reach_the_worker(option, passed):
    """The reference's --decode-block, --spec-tokens and --mixed-step (M10,
    once refused here), --prefix-host-gb and --role prefill / decode (M11b,
    once refused here) reach ``run_torch_worker`` as the JAX CLI hands
    them to ``run_tpu_worker``; the worker resolves them as the JAX
    worker does (``test_torch_worker.py``, ``test_torch_disagg.py``)."""
    calls = []
    assert cli.main(["worker", "run", "preset://tiny", "q", "--device", "cpu", *option],
                    run_worker=lambda *a, **k: calls.append(k)) == 0
    assert {k: calls[0][k] for k in passed} == passed


# --- worker identity against the JAX worker ----------------------------------


def _jobs():
    return [
        Job(id="p0", prompt="The quick brown {animal}", animal="fox", temperature=0.0,
            max_tokens=6, ignore_eos=True, row=0),
        Job(id="p1", prompt="Message queues decouple", temperature=0.0, max_tokens=5,
            ignore_eos=True, row=1, lang="en"),
        Job(id="p2", prompt="Paged attention stores", sampling={"temperature": 0.0,
                                                               "max_tokens": 4},
            ignore_eos=True, row=2),
        Job(id="c0", messages=[{"role": "user", "content": "Say hello."}], temperature=0.0,
            max_tokens=6, ignore_eos=True, row=3),
    ]


def _comparable(results):
    """Results by id, without the fields a run stamps (worker, times) and
    the reference's lifecycle ``trace``, which the port does not write yet
    (ROADMAP M16)."""
    out = {}
    for r in results:
        r = dict(r)
        for key in ("worker_id", "duration_ms", "timestamp", "trace"):
            r.pop(key, None)
        out[r["id"]] = r
    return out


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    pytest.importorskip("transformers")
    from tests.make_hf_fixture import build

    return build(tmp_path_factory.mktemp("hf") / "qwen2-micro")


ENGINE = dict(dtype="float32", max_num_seqs=4, max_model_len=64)


@pytest.fixture(scope="module")
def jax_results(hf_dir):
    """The jobs served by a ``TPUWorker`` over the reference's memory://."""
    from llmq_tpu.broker.base import make_broker
    from llmq_tpu.core.config import Config
    from llmq_tpu.workers.tpu_worker import TPUWorker

    url = f"memory://torch-cli-ref-{uuid.uuid4().hex[:8]}"

    async def main():
        broker = make_broker(url)
        await broker.connect()
        for job in _jobs():
            await broker.publish(QUEUE, job.model_dump_json().encode(), message_id=job.id)
        worker = TPUWorker(QUEUE, model=str(hf_dir), config=Config(broker_url=url), **ENGINE)
        task = asyncio.create_task(worker.run())
        for _ in range(2400):
            if ((await broker.stats(QUEUE + ".results")).message_count or 0) >= len(_jobs()):
                break
            await asyncio.sleep(0.05)
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=60)
        results = []
        while (msg := await broker.get(QUEUE + ".results")) is not None:
            results.append(json.loads(msg.body))
            await msg.ack()
        await broker.close()
        return results

    return _comparable(asyncio.run(main()))


async def _publish(url, jobs):
    from llmq_tpu_torch.broker.base import make_broker

    broker = make_broker(url)
    await broker.connect()
    for job in jobs:
        await broker.publish(QUEUE, job.model_dump_json().encode(), message_id=job.id)
    await broker.close()


async def _results(url, n, timeout=120.0):
    from llmq_tpu_torch.broker.base import make_broker

    broker = make_broker(url)
    await broker.connect()
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        msg = await broker.get(QUEUE + ".results")
        if msg is None:
            await asyncio.sleep(0.05)
            continue
        out.append(json.loads(msg.body))
        await msg.ack()
    await broker.close()
    return out


class _ReferenceDaemon:
    """The reference's ``BrokerServer`` on a free local port, in a thread
    with its own event loop."""

    def __enter__(self):
        from llmq_tpu.broker.tcp import BrokerServer

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = BrokerServer("127.0.0.1", 0)
        asyncio.run_coroutine_threadsafe(self.server.start(), self.loop).result(10)
        self.url = f"tcp://127.0.0.1:{self.server._server.sockets[0].getsockname()[1]}"
        return self

    def __exit__(self, *exc):
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.mark.parametrize("scheme", ["memory", "tcp"])
def test_checkpoint_worker_matches_the_jax_worker(hf_dir, jax_results, scheme):
    from llmq_tpu_torch.cli.worker import run_torch_worker

    jobs = _jobs()

    def serve(url):
        asyncio.run(_publish(url, jobs))
        worker = run_torch_worker(str(hf_dir), QUEUE, device="cpu", broker_url=url,
                                  max_jobs=len(jobs), **ENGINE)
        assert worker.jobs_processed == len(jobs)
        return _comparable(asyncio.run(_results(url, len(jobs))))

    if scheme == "memory":
        got = serve(f"memory://torch-cli-{uuid.uuid4().hex[:8]}")
    else:
        with _ReferenceDaemon() as daemon:
            got = serve(daemon.url)
    assert sorted(got) == sorted(j.id for j in jobs)
    for job in jobs:
        assert got[job.id] == jax_results[job.id], job.id
    assert [got[j.id]["usage"]["completion_tokens"] for j in jobs] == [6, 5, 4, 6]
    assert got["p0"]["animal"] == "fox" and got["p1"]["lang"] == "en"


def test_worker_process_serves_tcp_and_exits_0_on_sigterm():
    """``python -m llmq_tpu_torch worker run`` against the reference
    daemon: it answers every job as an in-process engine does, then a
    SIGTERM stops it with exit code 0."""
    from llmq_tpu_torch.cli.worker import build_engine
    from llmq_tpu_torch.engine.sampling import SamplingParams

    jobs = [Job(id=f"t{i}", prompt=f"tcp job {i}", temperature=0.0, max_tokens=4,
                ignore_eos=True) for i in range(3)]
    with _ReferenceDaemon() as daemon:
        asyncio.run(_publish(daemon.url, jobs))
        env = dict(os.environ, LLMQ_BROKER_URL=daemon.url, PYTHONPATH=str(ROOT))
        proc = subprocess.Popen(
            [sys.executable, "-m", "llmq_tpu_torch", "worker", "run", "preset://tiny", QUEUE,
             "--device", "cpu", "--dtype", "float32", "--max-num-seqs", "4",
             "--max-model-len", "64"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            results = _comparable(asyncio.run(_results(daemon.url, len(jobs))))
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    assert sorted(results) == [j.id for j in jobs]
    engine = build_engine("preset://tiny", device="cpu", dtype="float32", max_num_seqs=4,
                          max_model_len=64)
    try:
        for job in jobs:
            expect = engine.generate_sync(
                rid=job.id, prompt=job.prompt, timeout=60,
                params=SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True))
            assert results[job.id]["result"] == expect.text
            assert results[job.id]["usage"]["completion_tokens"] == 4
    finally:
        engine.shutdown()


@pytest.mark.parametrize("variables", [
    {},
    {"LLMQ_BROKER_URL": "tcp://10.0.0.5:5999/", "LLMQ_QUEUE_PREFETCH": "7",
     "LLMQ_MAX_TOKENS": "300"},
    {"BROKER_URL": "tcp://broker:5672/", "VLLM_QUEUE_PREFETCH": "250", "VLLM_MAX_TOKENS": "64"},
])
def test_worker_reads_the_broker_section_as_the_reference(monkeypatch, variables):
    """``broker_url``, ``queue_prefetch`` and ``max_tokens`` resolve from
    the same variables as the reference's ``Config``, and the worker's
    prefetch is ``TPUWorker``'s: the variable, raised to 1.5x the batch
    slots when no concurrency is given."""
    from types import SimpleNamespace

    from llmq_tpu.core.config import Config as RefConfig

    from llmq_tpu_torch.core.config import get_config
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    for name in ("LLMQ_BROKER_URL", "BROKER_URL", "RABBITMQ_URL", "LLMQ_QUEUE_PREFETCH",
                 "VLLM_QUEUE_PREFETCH", "LLMQ_MAX_TOKENS", "VLLM_MAX_TOKENS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in variables.items():
        monkeypatch.setenv(name, value)
    ours, ref = get_config(), RefConfig()
    for field in ("broker_url", "queue_prefetch", "max_tokens"):
        assert getattr(ours, field) == getattr(ref, field), field
    for slots in (4, 150):
        engine = SimpleNamespace(core=SimpleNamespace(cfg=SimpleNamespace(max_num_seqs=slots)))
        worker = TorchWorker(QUEUE, engine)
        assert worker.broker_url == ref.broker_url and worker.max_tokens == ref.max_tokens
        assert worker.concurrency == max(ref.queue_prefetch, slots + slots // 2)
        assert TorchWorker(QUEUE, engine, concurrency=3).concurrency == 3
