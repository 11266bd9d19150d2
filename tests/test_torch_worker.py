"""The port's worker over ``memory://``: jobs in, results out.

Drives ``run_torch_worker`` on the CPU with the tiny preset and checks
ids, ``usage.completion_tokens``, extra-field passthrough, and that each
result's text equals ``generate_sync`` of an engine with the same seeded
weights.
"""

import asyncio
import json

import pytest
import torch

from llmq_tpu_torch.broker.base import make_broker
from llmq_tpu_torch.broker.memory import reset_namespace
from llmq_tpu_torch.cli.worker import build_engine, run_torch_worker
from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.engine.sampling import SamplingParams
from llmq_tpu_torch.workers.torch_worker import TorchWorker

pytestmark = pytest.mark.unit

URL, QUEUE = "memory://torch-worker-test", "jobs"
ENGINE = dict(device="cpu", dtype="float32", max_num_seqs=4, max_model_len=64)


async def _submit(payloads, url=URL):
    broker = make_broker(url)
    await broker.connect()
    for body in payloads:
        await broker.publish(QUEUE, body)
    await broker.close()


async def _drain(queue, url=URL):
    broker = make_broker(url)
    await broker.connect()
    out = []
    while (msg := await broker.get(queue)) is not None:
        out.append(msg.body)
        await msg.ack()
    await broker.close()
    return out


def test_worker_serves_memory_queue():
    reset_namespace(URL.split("://")[1])
    jobs = [
        Job(id=f"j{i}", prompt="Say {word} {n}", word="hi", n=i, temperature=0.0,
            max_tokens=5 + i, ignore_eos=True, result="collides")
        for i in range(5)
    ]
    payloads = [j.model_dump_json().encode() for j in jobs] + [b"{not json"]
    asyncio.run(_submit(payloads))
    worker = run_torch_worker("preset://tiny", QUEUE, broker_url=URL, max_jobs=6, **ENGINE)
    assert (worker.jobs_processed, worker.jobs_failed) == (5, 1)
    results = {r["id"]: r for r in map(json.loads, asyncio.run(_drain(QUEUE + ".results")))}
    assert sorted(results) == [j.id for j in jobs]
    assert asyncio.run(_drain(QUEUE + ".failed")) == [b"{not json"]  # dead-lettered

    reference = build_engine("preset://tiny", **ENGINE)
    try:
        for i, job in enumerate(jobs):
            r = results[job.id]
            assert r["usage"] == {"prompt_tokens": len(f"Say hi {i}"),
                                  "completion_tokens": 5 + i}
            assert r["prompt"] == f"Say hi {i}"
            assert (r["word"], r["n"], r["job_result"]) == ("hi", i, "collides")
            assert r["finish_reason"] == "length"
            expect = reference.generate_sync(
                rid=job.id, prompt=f"Say hi {i}", timeout=60,
                params=SamplingParams(temperature=0.0, max_tokens=5 + i, ignore_eos=True),
            )
            assert r["result"] == expect.text
    finally:
        reference.shutdown()


def test_worker_stops_with_the_engine_failure():
    """A failed engine step (a kernel launch error, say) stops the worker:
    ``run`` raises with the engine's exception as the cause, every job goes
    back to the queue once, and nothing is published or dead-lettered."""
    url = "memory://torch-worker-fail"
    reset_namespace(url.split("://")[1])
    jobs = [Job(id=f"f{i}", prompt=f"job {i}", temperature=0.0, max_tokens=4) for i in range(3)]
    asyncio.run(_submit([j.model_dump_json().encode() for j in jobs], url))
    engine = build_engine("preset://tiny", **ENGINE)

    def failing_step():
        raise RuntimeError("paged_decode kernel launch failed: CUDA error 700")

    engine.core.step = failing_step
    worker = TorchWorker(QUEUE, engine, broker_url=url, max_jobs=len(jobs))
    try:
        with pytest.raises(RuntimeError, match="engine failed") as info:
            asyncio.run(worker.run())
    finally:
        engine.shutdown()
    assert "CUDA error 700" in str(info.value.__cause__)
    assert worker.jobs_processed == 0
    requeued = [json.loads(b)["id"] for b in asyncio.run(_drain(QUEUE, url))]
    assert sorted(requeued) == [j.id for j in jobs]
    assert asyncio.run(_drain(QUEUE + ".results", url)) == []
    assert asyncio.run(_drain(QUEUE + ".failed", url)) == []


def test_worker_serves_templated_jobs_with_chunked_prefix_cache():
    """The chunked prefill + prefix-cache path through the worker: every
    job is answered, and later jobs reuse the shared head's pages."""
    url = "memory://torch-worker-prefix"
    reset_namespace(url.split("://")[1])
    head = "Classify the sentiment of this review as positive or negative. " * 2
    jobs = [Job(id=f"t{i}", prompt=head + f"Review {i}: fine.", temperature=0.0,
                max_tokens=4, ignore_eos=True) for i in range(6)]
    asyncio.run(_submit([j.model_dump_json().encode() for j in jobs], url=url))
    worker = run_torch_worker("preset://tiny", QUEUE, broker_url=url, max_jobs=6,
                              prefill_chunk_size=32, enable_prefix_caching=True,
                              **{**ENGINE, "max_model_len": 256})
    results = [json.loads(b) for b in asyncio.run(_drain(QUEUE + ".results", url=url))]
    assert sorted(r["id"] for r in results) == [j.id for j in jobs]
    assert all(r["usage"]["completion_tokens"] == 4 for r in results)
    stats = worker.engine.core.stats()
    assert stats["prefix_cache_hit_pages"] > 0 and stats["decode_kernel"] == "plain"


@pytest.mark.parametrize("dtype,kv_dtype", [("int8", None), ("int4", "fp8")])
def test_worker_serves_quantized_weights(monkeypatch, dtype, kv_dtype):
    """``dtype="int8"|"int4"``: bf16 compute over weight-only quantized
    weights, as the JAX worker's ``--dtype``; the pool follows the compute
    dtype unless ``kv_dtype`` (or ``LLMQ_KV_DTYPE``) names one. With the
    kernel switches on, the CPU runs the kernels' plain versions."""
    from llmq_tpu_torch.cli.worker import resolve_pool_dtype
    from llmq_tpu_torch.models import quant as qm

    monkeypatch.delenv("LLMQ_KV_DTYPE", raising=False)
    assert resolve_pool_dtype("float32") == "float32"
    assert resolve_pool_dtype(dtype) == "bfloat16" and resolve_pool_dtype(dtype, "fp8") == "fp8"
    monkeypatch.setenv("LLMQ_KV_DTYPE", "f32")
    assert resolve_pool_dtype(dtype) == "f32"
    monkeypatch.delenv("LLMQ_KV_DTYPE")
    monkeypatch.setenv("LLMQ_INT8_MATMUL", "pallas")
    monkeypatch.setenv("LLMQ_INT4_MATMUL", "pallas")
    url = f"memory://torch-worker-{dtype}"
    reset_namespace(url.split("://")[1])
    jobs = [Job(id=f"{dtype}{i}", prompt=f"quantized job {i}", temperature=0.0, max_tokens=3,
                ignore_eos=True) for i in range(2)]
    asyncio.run(_submit([j.model_dump_json().encode() for j in jobs], url=url))
    worker = run_torch_worker("preset://tiny", QUEUE, broker_url=url, max_jobs=2,
                              **{**ENGINE, "dtype": dtype, "kv_dtype": kv_dtype})
    results = [json.loads(b) for b in asyncio.run(_drain(QUEUE + ".results", url=url))]
    assert sorted(r["id"] for r in results) == [j.id for j in jobs]
    assert all(r["usage"]["completion_tokens"] == 3 for r in results)
    core = worker.engine.core
    assert core.stats()["kv_dtype"] == ("float8_e5m2" if kv_dtype else "bfloat16")
    w = core.model.layer_params(0)["q_proj"]
    assert qm.is_int4(w) == (dtype == "int4") and w["scale"].dtype == torch.bfloat16
    assert core.model.top_params()["embed"]["q"].dtype == torch.int8
    assert core.model.quant_kernels == frozenset({"int8", "int4"})
