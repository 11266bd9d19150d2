"""The port's disaggregated serving against the JAX package's (M11b, and
M6's second part for the direct offer).

Over ``memory://``: a port ``prefill`` worker serves the queue alone until
every job has taken the ``<q>.decode`` road (its prompt-KV snapshot under
``RESUME_FIELD``, offset 0, a ``handoff_at`` stamp), then a ``decode``
worker adopts them all; the results equal a unified port worker's and a
JAX ``TPUWorker``'s (on the JAX engine of ``test_torch_prefix_store.py``),
token ids and digests included,
as the reference's own fallback test holds them
(``tests/test_disagg.py::test_fallback_handoff_token_parity``). With a
decode worker up first, the prefill worker offers every job to it
directly (``<q>.kv.<peer>``, parked on ``<q>.d.<peer>``) with the same
results, as ``test_ship_handoff_token_parity``; a decode peer that
declines sends the job to ``<q>.decode``. A unified
worker serves the ``<q>.interactive`` fast lane; a prefill worker forwards
a job that already carries resume state. The roles resolve and refuse as
the reference's; the JAX encoder's binary and b64 frames decode in the port;
results carry their token ids and the reference's digest under
``LLMQ_RESULT_DIGEST``;
the host-memory governor's eviction ladder and its serve rung act as the
reference's, and
evicts the host tier from another thread while the engine serves.
"""

import asyncio
import json
import threading
import time
import uuid

import pytest

from llmq_tpu.engine import engine as jengine
from llmq_tpu.engine import snapshot as jsnap
from llmq_tpu.utils import host_mem as jhost_mem
from llmq_tpu_torch.broker.base import decode_queue_name, interactive_queue_name, make_broker
from llmq_tpu_torch.broker.manager import BrokerManager, decode_adopt_queue_name
from llmq_tpu_torch.core.config import Config
from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine import snapshot as tsnap
from llmq_tpu_torch.engine.sampling import SamplingParams as TParams
from llmq_tpu_torch.utils import host_mem
from llmq_tpu_torch.utils.hashing import token_fold
from llmq_tpu_torch.workers.resume import RESUME_FIELD
from llmq_tpu_torch.workers.torch_worker import TorchWorker, worker_role

from test_torch_prefix_store import PROMPT, TEMPLATE, greedy, jax_core, run, tcore

pytestmark = pytest.mark.unit

QUEUE = "dq"


def _jobs():
    return [Job(id=f"d{i}", prompt=f"disaggregated job {i} " + "ab" * i, temperature=0.0,
                max_tokens=12, ignore_eos=True, row=i) for i in range(4)]


async def _publish(url, jobs, queue=QUEUE):
    broker = make_broker(url)
    await broker.connect()
    for job in jobs:
        await broker.publish(queue, job.model_dump_json().encode(), message_id=job.id)
    await broker.close()


async def _results(broker, n, timeout=60.0):
    out, deadline = {}, time.monotonic() + timeout
    while len(out) < n:
        assert time.monotonic() < deadline, f"{len(out)} of {n} results"
        msg = await broker.get(QUEUE + ".results")
        if msg is None:
            await asyncio.sleep(0.01)
            continue
        r = json.loads(msg.body)
        assert r["id"] not in out, f"duplicate result for {r['id']}"
        out[r["id"]] = r
        await msg.ack()
    return out


def _worker(url, role="unified", **cfg):
    """A port worker over a ROOMY engine; its results carry their token
    ids (``result_digest``)."""
    return TorchWorker(QUEUE, tengine.AsyncEngine(tcore()), broker_url=url, concurrency=8,
                       config=Config(broker_url=url, worker_role=role, result_digest=True,
                                     **cfg))


async def _stop(*pairs):
    for worker, task in pairs:
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=60)
        worker.engine.shutdown()


def _unified(url, jobs):
    async def main():
        await _publish(url, jobs)
        worker = _worker(url)
        task = asyncio.create_task(worker.run())
        broker = make_broker(url)
        await broker.connect()
        out = await _results(broker, len(jobs))
        await _stop((worker, task))
        await broker.close()
        return out

    return asyncio.run(main())


@pytest.fixture(scope="module")
def reference_results():
    """The jobs served by a unified ``TPUWorker`` over the JAX engine."""
    from llmq_tpu.broker.base import make_broker as jmake_broker
    from llmq_tpu.core.config import Config as JWorkerConfig
    from llmq_tpu.workers.tpu_worker import TPUWorker

    url = f"memory://disagg-ref-{uuid.uuid4().hex[:8]}"
    jcore = jax_core()
    jcore.abort_all("reset")

    async def main():
        broker = jmake_broker(url)
        await broker.connect()
        for job in _jobs():
            await broker.publish(QUEUE, job.model_dump_json().encode(), message_id=job.id)
        worker = TPUWorker(QUEUE, model="preset://tiny",
                           config=JWorkerConfig(broker_url=url, result_digest=True),
                           engine_factory=lambda w: jengine.AsyncEngine(jcore))
        task = asyncio.create_task(worker.run())
        out = await _results(broker, len(_jobs()))
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=60)
        await broker.close()
        return out

    return asyncio.run(main())


def test_prefill_then_decode_workers_equal_unified_and_jax_worker(reference_results):
    """The reference's fallback road with no decode peer alive: every job
    hands off to ``<q>.decode`` first, then a decode worker adopts them."""
    url = f"memory://disagg-{uuid.uuid4().hex[:8]}"
    jobs = _jobs()

    async def main():
        await _publish(url, jobs)
        wp = _worker(url, "prefill")
        tp = asyncio.create_task(wp.run())
        deadline = time.monotonic() + 60
        while wp.handoffs_fallback < len(jobs):
            assert time.monotonic() < deadline, f"fallbacks stuck at {wp.handoffs_fallback}"
            await asyncio.sleep(0.02)
        broker = make_broker(url)
        await broker.connect()
        held = []
        while (msg := await broker.get(decode_queue_name(QUEUE))) is not None:
            held.append(msg)
        parked = [json.loads(m.body) for m in held]
        for msg in held:  # back for the decode worker
            await msg.reject(requeue=True)
        wd = _worker(url, "decode")
        td = asyncio.create_task(wd.run())
        results = await _results(broker, len(jobs))
        await _stop((wp, tp), (wd, td))
        await broker.close()
        return wp, wd, parked, results

    wp, wd, parked, results = asyncio.run(main())
    unified = _unified(f"memory://disagg-uni-{uuid.uuid4().hex[:8]}", jobs)
    assert wp.handoffs_fallback == len(jobs) and wp.jobs_processed == 0
    assert wd.jobs_adopted == len(jobs) == wd.jobs_processed
    assert sorted(p["id"] for p in parked) == sorted(j.id for j in jobs)
    for p in parked:
        resume = p[RESUME_FIELD]
        assert resume["offset"] == 0 and resume["handoff_at"] > 0
        snap = tsnap.snapshot_from_wire(resume["snapshot"])
        assert snap.output_ids == [] and snap.kv_valid == len(snap.prompt_ids) - 1
    same = ("result", "usage", "token_ids", "token_digest")
    for rid, ref in reference_results.items():
        got = results[rid]
        assert [got[k] for k in same] == [unified[rid][k] for k in same], rid
        assert [got[k] for k in same] == [ref[k] for k in same], rid
        assert got["token_digest"] == token_fold(got["token_ids"])
        assert got["row"] == ref["row"] and RESUME_FIELD not in got
        assert got["resume_offset"] == 0 and got["finish_reason"] == "length"
    st = wd.stats()
    assert st["role"] == "decode" and st["jobs_adopted"] == len(jobs)
    assert 0 <= st["handoff_ms_p50"] <= st["handoff_ms_p95"]
    assert wp.stats()["handoffs_fallback"] == len(jobs) and "jobs_adopted" not in wp.stats()


def test_prefill_worker_ships_every_job_to_a_decode_peer_equal_to_the_jax_worker(
        reference_results):
    """The reference's ship road: with a decode worker beating before the
    jobs land, the prefill worker offers each prefill-complete job to it
    directly; it parks each on its ``<q>.d.<id>`` and adopts it. None takes
    the ``<q>.decode`` road, and the results equal the JAX worker's."""
    url = f"memory://disagg-ship-{uuid.uuid4().hex[:8]}"
    jobs = _jobs()

    async def main():
        wd = _worker(url, "decode")
        td = asyncio.create_task(wd.run())
        mgr = BrokerManager(Config(broker_url=url))
        await mgr.connect()
        deadline = time.monotonic() + 30
        while not any(h.role == "decode" for h in (await mgr.get_worker_health(QUEUE)).values()):
            assert time.monotonic() < deadline, "the decode worker never beat"
            await asyncio.sleep(0.02)
        wp = _worker(url, "prefill")
        tp = asyncio.create_task(wp.run())
        await _publish(url, jobs)
        broker = make_broker(url)
        await broker.connect()
        results = await _results(broker, len(jobs))
        left = [(await mgr.get_queue_stats(q)).message_count
                for q in (decode_adopt_queue_name(QUEUE, wd.worker_id), decode_queue_name(QUEUE))]
        await _stop((wp, tp), (wd, td))
        await broker.close()
        await mgr.disconnect()
        return wp, wd, left, results

    wp, wd, left, results = asyncio.run(main())
    assert (wp.handoffs_shipped, wp.handoffs_fallback, wd.jobs_adopted) == (4, 0, 4)
    assert left == [0, 0] and wp.jobs_processed == 0 and wd.jobs_processed == 4
    same = ("result", "usage", "token_ids", "token_digest")
    for rid, ref in reference_results.items():
        assert [results[rid][k] for k in same] == [ref[k] for k in same], rid
        assert results[rid]["resume_offset"] == 0
    assert wp.stats()["handoffs_shipped"] == 4 and wp.handoff_bytes > 0
    assert wd.stats()["handoff_ms_p50"] >= 0


def test_a_declining_decode_peer_sends_the_job_to_the_decode_pool():
    """A decode peer that is not serving declines the offer (``busy``):
    the job takes the ``<q>.decode`` road at once, its snapshot aboard,
    and the peer is not negative-cached (a decline is load, not death)."""
    url = f"memory://disagg-decline-{uuid.uuid4().hex[:8]}"
    job = _jobs()[0]

    async def main():
        peer = _worker(url, "decode")
        await peer.initialize()
        await peer._start_extra_consumers()
        await peer._publish_heartbeat()  # role decode, but not running: it declines
        wp = _worker(url, "prefill")
        tp = asyncio.create_task(wp.run())
        await _publish(url, [job])
        deadline = time.monotonic() + 30
        while wp.handoffs_fallback < 1:
            assert time.monotonic() < deadline, "no fallback"
            await asyncio.sleep(0.02)
        broker = make_broker(url)
        await broker.connect()
        msg = await broker.get(decode_queue_name(QUEUE))
        await msg.ack()
        parked = await broker.get(decode_adopt_queue_name(QUEUE, peer.worker_id))
        await _stop((wp, tp))
        await peer.broker.disconnect()
        peer.engine.shutdown()
        await broker.close()
        return wp, msg, parked

    wp, msg, parked = asyncio.run(main())
    assert (wp.handoffs_shipped, wp.handoffs_fallback) == (0, 1) and wp._dead_peers == {}
    assert parked is None and msg.message_id == job.id
    assert json.loads(msg.body)[RESUME_FIELD]["offset"] == 0


def test_worker_serves_the_interactive_lane():
    """A unified worker consumes ``<q>.interactive`` beside ``<q>`` while
    the priority classes are on (the default), and not with them off."""
    url = f"memory://disagg-lane-{uuid.uuid4().hex[:8]}"
    fast = Job(id="vip", prompt="an interactive question", temperature=0.0, max_tokens=6,
               ignore_eos=True, priority="interactive")
    slow = Job(id="bulk", prompt="a batch question", temperature=0.0, max_tokens=6,
               ignore_eos=True)

    async def main():
        await _publish(url, [fast], interactive_queue_name(QUEUE))
        await _publish(url, [slow])
        worker = _worker(url)
        task = asyncio.create_task(worker.run())
        broker = make_broker(url)
        await broker.connect()
        out = await _results(broker, 2)
        await _stop((worker, task))
        await broker.close()
        return worker, out

    worker, out = asyncio.run(main())
    assert sorted(out) == ["bulk", "vip"] and worker.jobs_processed == 2
    want = run(tcore(), [("vip", fast.prompt, 6)])["vip"]
    assert out["vip"]["result"] == want.text
    assert worker._role_queues() == [interactive_queue_name(QUEUE), QUEUE]
    off = TorchWorker(QUEUE, worker.engine, config=Config(priority_classes=False))
    assert off._role_queues() == [QUEUE]
    dec = TorchWorker(QUEUE, worker.engine, config=Config(worker_role="decode"))
    assert dec._role_queues() == [decode_queue_name(QUEUE)]


def test_prefill_worker_forwards_a_job_carrying_resume_state():
    """A job that already carries resume state (a drained peer's) skips a
    prefill worker: it lands on ``<q>.decode`` with its payload intact."""
    url = f"memory://disagg-fwd-{uuid.uuid4().hex[:8]}"
    src = tcore()
    snap = run(src, [("f0", PROMPT, 8)], prefill_only=True)["f0"].snapshot
    job = Job(id="f0", prompt=PROMPT, temperature=0.0, max_tokens=8, ignore_eos=True,
              **{RESUME_FIELD: {"snapshot": tsnap.snapshot_to_b64(snap), "offset": 0}})

    async def main():
        await _publish(url, [job])
        worker = _worker(url, "prefill")
        task = asyncio.create_task(worker.run())
        broker = make_broker(url)
        await broker.connect()
        deadline, msg = time.monotonic() + 30, None
        while msg is None:
            assert time.monotonic() < deadline, "nothing reached the decode pool"
            msg = await broker.get(decode_queue_name(QUEUE))
            await asyncio.sleep(0.01)
        await msg.ack()
        await _stop((worker, task))
        await broker.close()
        return worker, msg

    worker, msg = asyncio.run(main())
    assert msg.body == job.model_dump_json().encode() and msg.message_id == "f0"
    assert worker.handoffs_fallback == 0 and worker.jobs_processed == 0


@pytest.mark.parametrize("role", ["unified", "prefill", "decode", "auto", "oracle", None])
def test_worker_role_resolves_as_the_jax_worker(monkeypatch, role):
    """``LLMQ_WORKER_ROLE`` reads as the reference's ``Config.worker_role``
    (unset: unified); the four roles are taken as the reference's
    ``BaseWorker`` takes them (``auto`` serves prefill first) and an
    unknown role is a ValueError, as the reference raises."""
    from llmq_tpu.core.config import Config as JConfig
    from llmq_tpu.workers.dummy import DummyWorker

    monkeypatch.delenv("LLMQ_WORKER_ROLE", raising=False)
    if role is not None:
        monkeypatch.setenv("LLMQ_WORKER_ROLE", role)
    assert Config().worker_role == JConfig().worker_role == (role or "unified")
    if role == "oracle":
        with pytest.raises(ValueError, match="LLMQ_WORKER_ROLE"):
            worker_role(Config())
        with pytest.raises(ValueError):
            DummyWorker("q", delay=0, config=JConfig(broker_url="memory://role"))
    elif role == "auto":
        ref = DummyWorker("q", delay=0, config=JConfig(broker_url="memory://role"))
        assert worker_role(Config()) == ref.role == "auto"
        port = TorchWorker("q", tengine.AsyncEngine(tcore()), config=Config())
        port.engine.shutdown()
        assert (port.role, port.role_active) == (ref.role, ref.role_active) == ("auto", "prefill")
    else:
        assert worker_role(Config()) == DummyWorker(
            "q", delay=0, config=JConfig(broker_url="memory://role")).role


def test_binary_wire_frames_decode_on_both_sides(monkeypatch):
    """The JAX encoder's frames, binary (``LLMQ_WIRE_FORMAT=binary``) and
    b64, decode in the port to the snapshot's bytes, as in JAX."""
    src = tcore()
    snap = run(src, [("w0", PROMPT, 8)], prefill_only=True)["w0"].snapshot
    jsnp = jsnap.RequestSnapshot.from_bytes(snap.to_bytes())
    monkeypatch.setenv("LLMQ_WIRE_FORMAT", "binary")
    frame = jsnap.snapshot_to_wire(jsnp)
    assert isinstance(frame, bytes) and frame[: len(tsnap.WIRE_MAGIC)] == tsnap.WIRE_MAGIC
    assert jsnap.snapshot_from_wire(frame).to_bytes() == snap.to_bytes()
    assert tsnap.snapshot_from_wire(frame).to_bytes() == snap.to_bytes()
    assert tsnap.snapshot_from_wire(memoryview(frame)).to_bytes() == snap.to_bytes()
    monkeypatch.delenv("LLMQ_WIRE_FORMAT")
    b64 = jsnap.snapshot_to_wire(jsnp)
    assert b64 == tsnap.snapshot_to_b64(snap)
    assert tsnap.snapshot_from_wire(b64).to_bytes() == snap.to_bytes()
    with pytest.raises(tsnap.SnapshotIntegrityError):
        tsnap.snapshot_from_wire(frame[: len(tsnap.WIRE_MAGIC) + 2])


class _Store:
    """A consumer of the host budget that frees ``unit`` bytes at a time."""

    def __init__(self, nbytes, unit):
        self.nbytes, self.unit = nbytes, unit

    def usage(self):
        return self.nbytes

    def evict(self, want):
        freed = 0
        while freed < want and self.nbytes > 0:
            self.nbytes -= self.unit
            freed += self.unit
        return freed


def test_governor_ladder_acts_as_the_jax_governor():
    """Prefix eviction before a swap refusal, eviction pressure from a
    resume blob, and the counters, step for step the reference's."""
    trace = []
    for mod in (host_mem, jhost_mem):
        gov = mod.HostMemoryGovernor(1000)
        prefix, swap = _Store(600, 100), _Store(200, 0)
        gov.register("prefix", prefix.usage, evict_fn=prefix.evict)
        gov.register("swap", swap.usage)
        steps = [gov.admit_swap(50), gov.admit_swap(300), prefix.nbytes,
                 gov.admit_swap(900), gov.evictions_forced, gov.swap_refusals]
        gov.note_resume_blob(0)
        prefix.nbytes = 700
        gov.note_resume_blob(400)
        steps += [prefix.nbytes, gov.usage_bytes(), gov.evictions_forced]
        gov.unregister("prefix")
        steps += [gov.usage_bytes(), gov.admit_swap(700), gov.swap_refusals]
        trace.append(steps)
    assert trace[0] == trace[1]
    assert host_mem.HostMemoryGovernor(0).admit_swap(1 << 40)  # disabled: always yes


def test_governor_serve_rung_acts_as_the_jax_governor():
    """The third rung: a serve of prefix pages to a peer is refused only
    above ``SERVE_REFUSE_FRAC`` of the budget, counted in ``stats()``,
    step for step the reference's; a disabled governor admits every one."""
    trace = []
    for mod in (host_mem, jhost_mem):
        gov = mod.HostMemoryGovernor(1000)
        held = _Store(900, 0)
        gov.register("held", held.usage)
        steps = [mod.SERVE_REFUSE_FRAC, gov.admit_serve()]
        held.nbytes = 951
        steps += [gov.admit_serve(), gov.admit_serve(), gov.serve_refusals]
        held.nbytes = 950
        steps += [gov.admit_serve(), gov.stats()]
        trace.append(steps)
    assert trace[0] == trace[1] == [0.95, True, False, False, 2, True, trace[0][-1]]
    assert trace[0][-1]["serve_refusals"] == 2
    assert host_mem.HostMemoryGovernor(0).admit_serve()


def test_engine_registers_its_prefix_tier_with_the_governor():
    """An engine's host tier reports into the shared budget and gives way
    to a swap capture; ``close`` takes its gauges out again."""
    gov = host_mem.HostMemoryGovernor(1 << 30)
    host_mem.set_governor(gov)
    try:
        core = tcore()
        run(core, [("g0", PROMPT + "with a longer tail for pages", 4)])
        core.flush_prefix_to_host()
        held = core.prefix_store.occupancy_bytes
        assert held > 0 and gov.usage_bytes() == held
        assert gov.admit_swap(int(gov.budget_bytes * host_mem.SWAP_REFUSE_FRAC) - held // 2)
        assert core.prefix_store.occupancy_bytes < held and gov.evictions_forced == 1
        assert core.stats()["host_mem"]["evictions_forced"] == 1
        core.close()
        assert gov.stats()["usage_bytes"] == 0 and not gov._usage_fns
    finally:
        host_mem.set_governor(None)


def test_resume_blobs_evict_the_tier_from_another_thread_while_the_engine_serves():
    """A worker accounts each handoff blob on its event loop; over the
    budget that evicts the host tier from that thread while the engine
    thread demotes into it and promotes from it. The engine serves on, with
    the tokens of a run without the tier."""
    prompts = {f"t{i}": TEMPLATE + f"threaded question {i}?" for i in range(6)}
    want = run(tcore(prefix_host_gb=0.0), [(rid, p, 6) for rid, p in prompts.items()])
    gov = host_mem.HostMemoryGovernor(1 << 20)
    host_mem.set_governor(gov)
    stop, got = threading.Event(), {}

    def event_loop():
        while not stop.is_set():
            gov.note_resume_blob(gov.budget_bytes)
            stop.wait(1e-4)

    eng = tengine.AsyncEngine(tcore())
    blobs = threading.Thread(target=event_loop)
    blobs.start()
    try:
        for rid, prompt in prompts.items():
            got[rid] = eng.generate_sync(rid=rid, prompt=prompt, params=greedy(TParams, 6),
                                         timeout=60)
            # The request resolves when its finish is seen, which can be
            # before its trailing dispatches land and its pages leave the
            # deferred release: drain them first, or the flush finds no
            # cached page to demote.
            eng.call_on_engine(lambda: (eng.core._drain([]), eng.core.flush_prefix_to_host()))
    finally:
        stop.set()
        blobs.join(timeout=10)
        eng.shutdown()
        host_mem.set_governor(None)
    assert not blobs.is_alive() and eng.error is None
    assert {rid: o.token_ids for rid, o in got.items()} == {
        rid: o.token_ids for rid, o in want.items()}
    assert eng.core.prefix_demotes > 0 and gov.evictions_forced > 0


def test_token_fold_equals_the_jax_digest():
    from llmq_tpu.utils.hashing import token_fold as jax_fold

    for ids in ([], [0], [1, 2, 3], [151_935, 7, -1, 2**31 - 1]):
        assert token_fold(ids) == jax_fold(ids)
    assert Config(result_digest=False).result_digest is False
