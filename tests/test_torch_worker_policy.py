"""The port's worker failure policy against the reference's.

- The same scripted events drive both packages' ``BaseWorker`` (a scripted
  subclass each, over each package's ``memory://`` core): success,
  ``ValueError``, a job that fails until quarantine, a job that times out
  until quarantine, a job that fails twice and then succeeds, an
  unparseable body, a lapsed deadline; then, with quarantine off, the
  broker's redelivery cap and the circuit breaker's self-drain. They give
  the same settles (which queue each job ends on), the same headers (but
  ``x-worker-id``'s value), the same counters and heartbeats with the
  same keys and robustness counters. The heartbeat's ``metrics`` differ:
  the reference fills it from its metrics registry, which the port gets
  with M16.
- One end to end: a ``TorchWorker`` on the tiny preset over
  ``chaos+memory://`` with connection kills and duplicate deliveries.
"""

import asyncio
import json
import time
from collections import Counter

import pytest

import llmq_tpu.core.config as jconfig
import llmq_tpu_torch.core.config as tconfig
from llmq_tpu.broker import memory as jmem
from llmq_tpu.workers import base as jbase
from llmq_tpu_torch.broker import memory as tmem
from llmq_tpu_torch.workers import base as tbase

pytestmark = pytest.mark.unit

# --- scripted workers ------------------------------------------------------

def _scripted(base_mod):
    """A worker of ``base_mod`` whose jobs act out their ``act`` extra."""

    class Scripted(base_mod.BaseWorker):
        def _generate_worker_id(self):
            return f"scripted-{base_mod.__name__.split('.')[0]}"

        async def _initialize_processor(self):
            self.attempts = Counter()

        async def _cleanup_processor(self):
            return None

        async def _process_job(self, job):
            act = job.extras().get("act", "ok")
            self.attempts[job.id] += 1
            if act == "invalid":
                raise ValueError("not a job this worker can serve")
            if act == "crash":
                raise RuntimeError("deterministic crash")
            if act == "hang":
                await asyncio.sleep(30)
            if act == "flaky" and self.attempts[job.id] <= 2:
                raise RuntimeError("transient")
            return f"echo {job.prompt}"

    return Scripted


SCRIPTS = {
    "quarantine": (dict(quarantine_attempts=3, job_timeout_s=0.15, max_redeliveries=5), [
        {"id": "ok1", "prompt": "a"},
        {"id": "bad", "prompt": "b", "act": "invalid"},
        {"id": "poison", "prompt": "c", "act": "crash"},
        {"id": "slow", "prompt": "d", "act": "hang"},
        {"id": "flaky", "prompt": "e", "act": "flaky"},
        b"{not a job",
        {"id": "late", "prompt": "f", "deadline_at": 1.0},
        {"id": "ok2", "prompt": "g", "priority": "interactive"},
    ]),
    "breaker": (dict(quarantine_attempts=0, max_redeliveries=0, breaker_failures=3), [
        {"id": "ok1", "prompt": "a"},
        {"id": "crash1", "prompt": "b", "act": "crash"},
        {"id": "crash2", "prompt": "c", "act": "crash"},
        {"id": "crash3", "prompt": "d", "act": "crash"},
    ]),
}
FINAL = ("q", "q.results", "q.failed", "q.quarantine", "q.interactive")


def _settled(core) -> dict:
    return {name: [(m.message_id, m.headers) for m in core.queues[name].ready]
            for name in FINAL if name in core.queues}


async def _drive(base_mod, mem_mod, ns, fields, script):
    """Publish the script, serve it with prefetch 1 (one job at a time, so
    the order of events is the script's), stop once every queue is at rest
    or the breaker drained the worker; the settled queues, the results,
    the counters and one heartbeat."""
    cfg_cls = (jconfig if base_mod is jbase else tconfig).Config
    core = mem_mod.get_namespace(ns)
    worker = _scripted(base_mod)("q", concurrency=1, config=cfg_cls(
        broker_url=f"memory://{ns}", priority_classes=False, drain_timeout_s=5, **fields))
    await worker.initialize()
    for i, item in enumerate(script):
        body = item if isinstance(item, bytes) else json.dumps(item).encode()
        core.publish("q", body, message_id=item["id"] if isinstance(item, dict) else f"raw{i}",
                     headers={"x-origin": "script"} if isinstance(item, bytes) else None)
    worker.running = True
    await worker._start_role_consumers()
    deadline = time.monotonic() + 20
    while worker.running and (core.queues["q"].ready or core.queues["q"].unacked):
        assert time.monotonic() < deadline, "the script never came to rest"
        await asyncio.sleep(0.01)
    await worker._publish_heartbeat()
    worker.request_shutdown()
    await worker.shutdown()
    settled = _settled(core)
    results = sorted((json.loads(b)["id"], json.loads(b)["result"])
                     for b in (m.body for m in core.queues["q.results"].ready))
    beat = json.loads(core.queues["q.health"].ready[-1].body)
    counters = {k: getattr(worker, k) for k in (
        "jobs_processed", "jobs_failed", "jobs_timed_out", "jobs_quarantined",
        "jobs_deadline_exceeded", "breaker_tripped", "_consecutive_failures")}
    return settled, results, counters, beat, worker.worker_id


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_worker_policy_settles_as_the_reference(script):
    fields, items = SCRIPTS[script]
    out = {}
    for name, (base_mod, mem_mod) in {"reference": (jbase, jmem), "port": (tbase, tmem)}.items():
        ns = f"policy-{script}-{name}"
        try:
            out[name] = asyncio.run(_drive(base_mod, mem_mod, ns, fields, items))
        finally:
            mem_mod.reset_namespace(ns)
    (jset, jres, jcount, jbeat, jwid), (tset, tres, tcount, tbeat, twid) = (
        out["reference"], out["port"])

    def anonymous(settled, wid):
        out = {}
        for queue, msgs in settled.items():
            rows = []
            for mid, headers in msgs:
                headers = dict(headers)
                if "x-worker-id" in headers:
                    assert headers["x-worker-id"] == wid
                    headers["x-worker-id"] = "<worker>"
                rows.append((mid, headers))
            out[queue] = rows
        return out

    assert anonymous(tset, twid) == anonymous(jset, jwid)
    assert tres == jres and tcount == jcount
    # Heartbeats: the same keys; the same values but the worker's id, its
    # clock, its durations and `metrics` (the reference's registry, M16).
    assert set(tbeat) == set(jbeat)
    for key in ("worker_id", "last_seen", "avg_duration_ms", "metrics"):
        tbeat.pop(key), jbeat.pop(key)
    assert tbeat == jbeat
    if script == "quarantine":
        quarantined = {mid: h["x-failure-reason"] for mid, h in jset["q.quarantine"]}
        assert quarantined == {"poison": "engine_error:RuntimeError", "slow": "timeout"}
        assert [mid for mid, _ in jset["q.failed"]] == ["raw5", "late"]
        assert jcount["jobs_timed_out"] == 3 and jbeat["engine_stats"]["jobs_quarantined"] == 2
    else:  # each crash dead-letters at the cap of 0; the third trips the breaker
        assert [mid for mid, _ in jset["q.failed"]] == ["crash1", "crash2", "crash3"]
        assert jcount["breaker_tripped"] and jbeat["engine_stats"] == {"breaker_tripped": True}


# --- one end to end: the TorchWorker under chaos ----------------------------

def _quiet(chaos, *, ops: int, deliveries: int) -> bool:
    """The chaos broker's next ``ops`` operations and ``deliveries``
    deliveries inject no kill and no duplicate."""
    kill = chaos.kill_every and any((chaos._ops + i) % chaos.kill_every == 0
                                    for i in range(1, ops + 1))
    dup = chaos.dup_every and any((chaos._deliveries + i) % chaos.dup_every == 0
                                  for i in range(1, deliveries + 1))
    return not kill and not dup


async def _results(plain, task, ids, timeout=60.0) -> dict:
    """Token ids of the results of ``ids``, deduped by job id."""
    got, deadline = {}, time.monotonic() + timeout
    while not ids <= set(got):
        assert time.monotonic() < deadline and not task.done(), sorted(got)
        msg = await plain.broker.get("cq.results")
        if msg is None:
            await asyncio.sleep(0.01)
            continue
        r = json.loads(msg.body)
        got.setdefault(r["id"], r["token_ids"])
        await msg.ack()
    return got


@pytest.fixture(scope="module")
def tiny_engine():
    """The engine of the file's worker (a worker's drain hands its engine
    off: the engine takes no request after it)."""
    from llmq_tpu_torch.cli.worker import build_engine

    engine = build_engine("preset://tiny", device="cpu", dtype="float32", max_num_seqs=8,
                          max_model_len=96)
    yield engine
    engine.shutdown()


def test_torch_worker_under_chaos_answers_every_job_and_quarantines_a_slow_one(
        tiny_engine, monkeypatch):
    """Connection kills and duplicate deliveries (``chaos+memory://``):
    every job is answered, its token ids equal to the engine's direct
    serve (readers dedupe by id, as the reference's chaos tests do); a job
    that outlasts ``job_timeout_s`` at each attempt is quarantined as
    ``timeout``; the session reconnected; a heartbeat reads back."""
    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.engine.sampling import SamplingParams
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    monkeypatch.setattr(tbase, "HEARTBEAT_INTERVAL_S", 0.05)
    ns = "policy-chaos"
    jobs = [Job(id=f"c{i}", prompt=f"chaos job {i} " * (1 + i % 3), temperature=0.0,
                max_tokens=4, ignore_eos=True) for i in range(8)]

    class Slowed(TorchWorker):
        """The job ``slow`` outlasts the timeout before it reaches the engine."""

        async def _process_job(self, job):
            if job.id == "slow":
                await asyncio.sleep(30)
            return await super()._process_job(job)

    async def direct():
        outs = await asyncio.gather(*[tiny_engine.generate(
            rid=f"direct-{j.id}", prompt=j.prompt,
            params=SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)) for j in jobs])
        return {j.id: list(o.token_ids) for j, o in zip(jobs, outs)}

    async def main():
        want = await direct()
        plain = BrokerManager(Config(broker_url=f"memory://{ns}", max_redeliveries=1000))
        await plain.connect()
        await plain.setup_queue_infrastructure("cq")
        for job in jobs:
            await plain.publish_job("cq", job)
        worker = Slowed("cq", tiny_engine, concurrency=8, config=Config(
            broker_url=f"chaos+memory://{ns}?kill_every=9&dup_every=3&seed=3",
            max_redeliveries=1000, reconnect_base_delay_s=0.01, reconnect_max_delay_s=0.05,
            job_timeout_s=0.6, quarantine_attempts=2, result_digest=True))
        task = asyncio.create_task(worker.run())
        got = await _results(plain, task, {j.id for j in jobs})
        chaos = worker.broker.broker.inner
        health = await plain.get_worker_health("cq")
        # The slow job goes in a window the chaos leaves alone (kills and
        # duplicates bump delivery counts, which quarantine reads too):
        # no heartbeat, and one-token fillers until the next 4 operations
        # and 2 deliveries inject nothing.
        monkeypatch.setattr(tbase, "HEARTBEAT_INTERVAL_S", 3600.0)
        n = 0
        while not _quiet(chaos, ops=4, deliveries=2):
            await plain.publish_job("cq", Job(id=f"filler{n}", prompt="x", max_tokens=1))
            await _results(plain, task, {f"filler{n}"})
            n += 1
        await plain.publish_job("cq", Job(id="slow", prompt="slow", max_tokens=4))
        # Jobs whose copies a kill or a duplicate pushed to the attempt count
        # were quarantined too, as the reference's policy does: their
        # results are out already. Collect the slow job's entries.
        quarantined, deadline = [], time.monotonic() + 30
        while not quarantined:
            assert time.monotonic() < deadline and not task.done(), "slow was not quarantined"
            msg = await plain.broker.get("cq.quarantine")
            if msg is None:
                await asyncio.sleep(0.01)
                continue
            if msg.message_id == "slow":
                quarantined.append(msg.headers)
            await msg.ack()
        session = dict(worker.broker.session_stats.as_dict(), kills=chaos.kills,
                       duplicates=chaos.duplicates)
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=30)
        failed = (await plain.get_queue_stats("cq.failed")).message_count
        await plain.disconnect()
        return want, got, quarantined, health, worker, failed, session

    try:
        want, got, quarantined, health, worker, failed, session = asyncio.run(main())
    finally:
        tmem.reset_namespace(ns)
    assert got == want
    assert [(h["x-failure-reason"], h["x-delivery-count"]) for h in quarantined] == [("timeout", 2)]
    assert failed == 0
    assert session["reconnects"] >= 1 and session["kills"] >= 1 and session["duplicates"] >= 1
    assert worker.worker_id in health and health[worker.worker_id].status == "running"


def test_a_second_request_of_an_id_in_the_engine_joins_it():
    """A redelivered or retried job reaches the engine while its first
    request still runs (a kill redelivers it to the same worker; a timed-out
    attempt's request keeps decoding): the second request of the id joins
    the first, both resolve with its output, and no slot stays held (queue
    3 item 12: the JAX engine adds a second row of the id; when one ends,
    its id-keyed running map no longer holds the other, which no step
    serves again and which keeps its slot and pages). The engine thread's
    steps wait on a gate that the test opens only once the second request
    is in, so the first cannot finish before it, however fast the engine."""
    import threading

    from llmq_tpu_torch.cli.worker import build_engine
    from llmq_tpu_torch.engine.sampling import SamplingParams

    params = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    tiny_engine = build_engine("preset://tiny", device="cpu", dtype="float32", max_num_seqs=4,
                               max_model_len=64)
    core = tiny_engine.core
    gate = threading.Event()
    step = core.step

    def held_step():
        assert gate.wait(timeout=30), "the test never opened the gate"
        return step()

    core.step = held_step

    async def submitted(rid):
        task = asyncio.ensure_future(tiny_engine.generate(rid=rid, prompt="join me",
                                                          params=params))
        await asyncio.sleep(0)  # the task runs up to its await: the request is in
        return task

    async def main():
        before = core.stats()["generated_tokens"]
        first = await submitted("twice")
        second = await submitted("twice")
        gate.set()
        a = await asyncio.wait_for(first, 30)
        second = await asyncio.wait_for(second, 30)
        # A caller that gives up (a job timeout) leaves the request running;
        # a retry of the id joins it.
        gate.clear()
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(tiny_engine.generate(rid="again", prompt="join me",
                                                        params=params), 0.05)
        retry = await submitted("again")
        gate.set()
        retry = await asyncio.wait_for(retry, 30)
        for _ in range(100):
            if not any(s is not None for s in core.scheduler.slots):
                break
            await asyncio.sleep(0.01)
        return a, second, retry, core.stats()["generated_tokens"] - before

    try:
        a, second, retry, generated = asyncio.run(main())
    finally:
        gate.set()
        tiny_engine.shutdown()
    assert list(a.token_ids) == list(second.token_ids) == list(retry.token_ids)
    assert generated == 2 * 12  # one request of each id ran
    assert not any(s is not None for s in core.scheduler.slots)
