"""The port's peers' plane against the JAX package's (M6's second part).

Routing: the same heartbeats and jobs go through both packages'
``BrokerManager.publish_job`` with prefix affinity on, over each package's
``memory://``, and every case lands on the same queue (the reference's
``tests/test_prefix_affinity.py`` cases). The janitor: both managers reclaim
a dead worker's private queues exactly once, leave a live one's alone, and
reclaim a worker whose heartbeat reports a wedged engine. ``delete_queue``
on ``memory://``, ``file://`` and ``tcp://``. The ``auto`` role's
controller: both packages' ``DummyWorker`` flip alike under the same
depths (``tests/test_disagg.py``'s cases).

Shipping: two port workers with the prefix cache and a host tier; B fetches
the template's pages from A before it prefills, promotes them, and gives
the tokens of a JAX ``TPUWorker`` for the same job (f32). A fetch that
times out, or that a peer answers busy (its serve cap, or its host-memory
governor under a tiny budget), prefills locally. The engine's want-list
equals the JAX engine's on the same state. One JAX engine for the file,
built once.
"""

import asyncio
import json
import time
import uuid
from datetime import timedelta

import jax
import jax.numpy as jnp
import pytest

from llmq_tpu.broker import manager as jmanager
from llmq_tpu.broker import memory as jmem
from llmq_tpu.core import config as jconfig
from llmq_tpu.core import models as jmodels
from llmq_tpu.engine import engine as jengine
from llmq_tpu.engine.sampling import SamplingParams as JParams
from llmq_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llmq_tpu.parallel import make_mesh
from llmq_tpu.utils import hashing as jhashing
from llmq_tpu.workers import dummy as jdummy
from llmq_tpu_torch.broker import manager as tmanager
from llmq_tpu_torch.broker import memory as tmem
from llmq_tpu_torch.core import config as tconfig
from llmq_tpu_torch.core import models as tmodels
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine.sampling import SamplingParams as TParams
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.utils import hashing as thashing
from llmq_tpu_torch.utils import host_mem
from llmq_tpu_torch.workers import dummy as tdummy
from llmq_tpu_torch.workers import torch_worker as tworker

from test_torch_prefix_store import JCFG, TCFG, TREE, digests, run

pytestmark = pytest.mark.unit

# >= 256 characters, so text_prefix_chain gives a digest: templated jobs
# share it, unrelated ones do not.
TEMPLATE = ("SYSTEM: you are a helpful assistant. " * 8)[:280]

PKGS = {
    "jax": (jmanager, jconfig, jmodels, jmem),
    "port": (tmanager, tconfig, tmodels, tmem),
}


def _ns(tag):
    return f"peers-{tag}-{uuid.uuid4().hex[:8]}"


# --- names, text, hashing --------------------------------------------------------------

def test_hashing_names_and_affinity_text_equal_jax():
    import numpy as np

    rng = np.random.default_rng(7)
    for n in (0, 255, 256, 300, 700, 1100, 2000):
        text = "".join(chr(c) for c in rng.integers(32, 0x2FF, size=n))
        assert thashing.text_prefix_chain(text) == jhashing.text_prefix_chain(text)
        assert thashing.text_prefix_chain(text, chunk_chars=64, max_chunks=9) == \
            jhashing.text_prefix_chain(text, chunk_chars=64, max_chunks=9)
    workers = [f"w{i}-{rng.integers(1 << 30)}" for i in range(7)]
    for d in range(32):
        digest = rng.bytes(16).hex()
        assert thashing.rendezvous_pick(digest, workers) == \
            jhashing.rendezvous_pick(digest, workers)
        assert thashing.rendezvous_pick(digest, workers[::-1]) == \
            thashing.rendezvous_pick(digest, workers)
    for name in ("affinity_queue_name", "kv_fetch_queue_name", "decode_adopt_queue_name"):
        assert getattr(tmanager, name)("q", "w1") == getattr(jmanager, name)("q", "w1")
    jobs = [dict(id="j", prompt="say {word}", word="hello"),
            dict(id="c", messages=[{"role": "user", "content": "hi"},
                                   {"role": "assistant", "content": " there"}]),
            dict(id="b", prompt="say {missing}"), dict(id="t", prompt=TEMPLATE + " Q?")]
    for job in jobs:
        assert tmanager.job_affinity_text(tmodels.Job(**job)) == \
            jmanager.job_affinity_text(jmodels.Job(**job))


# --- routing over each package's memory broker -------------------------------------------

async def _advertised(pkg, url, queue, chains, *, wid="w1", age_s=0.0, **cfg):
    """A connected manager of ``pkg`` and one heartbeat of ``wid`` on the
    health queue (its private queue declared, as the worker does)."""
    manager, config, models, _ = PKGS[pkg]
    mgr = manager.BrokerManager(config.Config(broker_url=url, **{"prefix_affinity": True, **cfg}))
    await mgr.connect()
    await mgr.setup_queue_infrastructure(queue)
    await mgr.broker.declare_queue(queue + manager.HEALTH_SUFFIX, ttl_ms=120_000,
                                   max_redeliveries=1_000_000_000)
    await mgr.broker.declare_queue(manager.affinity_queue_name(queue, wid))
    health = models.WorkerHealth(
        worker_id=wid, status="running", jobs_processed=1, prefix_chains=chains,
        last_seen=models.utcnow() - timedelta(seconds=age_s))
    await mgr.broker.publish(queue + manager.HEALTH_SUFFIX,
                             health.model_dump_json().encode("utf-8"))
    return mgr


async def _drain(mgr, queue):
    ids = []
    while (msg := await mgr.broker.get(queue)) is not None:
        ids.append(msg.message_id)
        await msg.ack()
    return ids


ROUTING = {
    # case: (advertised chain's text, heartbeat age s, affinity on, jobs' prompts)
    "routes_to_the_advertiser": (TEMPLATE + "anything", 0.0, True, [TEMPLATE + " Q?"]),
    "unrelated_falls_back": (TEMPLATE + "anything", 0.0, True, ["X" * 300]),
    "short_never_routes": (TEMPLATE + "anything", 0.0, True, ["short"]),
    "stale_does_not_route": (TEMPLATE + "anything", 600.0, True, [TEMPLATE + " Q?"]),
    "off_never_peeks": (TEMPLATE + "anything", 0.0, False, [TEMPLATE + " Q?"]),
    "the_map_caches": (TEMPLATE + "anything", 0.0, True, [TEMPLATE + "?"] * 5),
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_publish_job_routes_as_the_jax_manager(case):
    """Each case of the reference's routing tests, on both managers: the
    same queue for every job, the same counters, one heartbeat peek at
    most (none with affinity off), and the heartbeat still there."""
    text, age_s, on, prompts = ROUTING[case]
    chains = thashing.text_prefix_chain(text)

    async def main(pkg):
        url = f"memory://{_ns(case)}"
        mgr = await _advertised(pkg, url, "q", chains, age_s=age_s, prefix_affinity=on)
        gets = []
        get = mgr.broker.get

        async def counted(queue):
            gets.append(queue)
            return await get(queue)

        mgr.broker.get = counted  # a peek reads the health queue until it is empty
        models = PKGS[pkg][2]
        for i, prompt in enumerate(prompts):
            await mgr.publish_job("q", models.Job(id=f"j{i}", prompt=prompt))
        mgr.broker.get = get
        out = dict(shared=await _drain(mgr, "q"), private=await _drain(mgr, "q.w.w1"),
                   routed=mgr.affinity_routed, fallback=mgr.affinity_fallback,
                   peeks=gets.count("q.health") // 2,
                   beats=sorted(await mgr.get_worker_health("q")))
        await mgr.disconnect()
        return out

    port, ref = asyncio.run(main("port")), asyncio.run(main("jax"))
    assert port == ref
    assert port["peeks"] == (1 if on and case != "short_never_routes" else 0)
    assert port["beats"] == ["w1"]
    routed = case in ("routes_to_the_advertiser", "the_map_caches")
    assert len(port["private"]) == (len(prompts) if routed else 0)
    assert len(port["shared"]) == (0 if routed else len(prompts))


def test_overlapping_peeks_all_see_the_decode_peer_unlike_the_reference():
    """Queue 3 item 16: a prefill worker whose prefills end together asks
    for its decode peers once a handoff. Over tcp:// the reference's
    overlapping heartbeat peeks find the health queue empty (the first
    holds the heartbeat unacked) and cache an empty pool, so those
    handoffs fall back; the port's manager peeks once at a time and every
    caller sees the peer. Both managers run against the port's daemon."""
    from llmq_tpu_torch.broker.tcp import BrokerServer

    async def main(pkg):
        manager, config, models, _ = PKGS[pkg]
        server = BrokerServer("127.0.0.1", 0)
        await server.start()
        url = f"tcp://127.0.0.1:{server._server.sockets[0].getsockname()[1]}"
        mgr = manager.BrokerManager(config.Config(broker_url=url))
        await mgr.connect()
        health = models.WorkerHealth(worker_id="dec-1", status="running", jobs_processed=0,
                                     last_seen=models.utcnow(), role="decode")
        await mgr.broker.publish("q.health", health.model_dump_json().encode("utf-8"))
        pools = await asyncio.gather(*(mgr.decode_targets("q") for _ in range(8)))
        again = await mgr.decode_targets("q")  # from the cache
        await mgr.disconnect()
        await server.stop()
        return [sorted(p) for p in pools], sorted(again)

    pools, again = asyncio.run(main("port"))
    assert pools == [["dec-1"]] * 8 and again == ["dec-1"]
    ref_pools, _ = asyncio.run(main("jax"))
    assert [] in ref_pools  # the reference's overlapping peeks saw no peer


# --- adoption offers -------------------------------------------------------------------

def _stub_worker(url, wid, role):
    """A port worker whose engine is never touched: the offer handshake
    and its decode side need the broker session alone."""
    from types import SimpleNamespace

    engine = SimpleNamespace(core=SimpleNamespace(cfg=SimpleNamespace(max_num_seqs=4)))
    return tworker.TorchWorker("sq", engine, broker_url=url, worker_id=wid, config=tconfig.Config(
        broker_url=url, worker_role=role, max_redeliveries=1000))


async def _slow_decode_peer(mem, url, delay_s):
    """A decode peer on ``sq.kv.slow`` (over ``mem``'s broker) that accepts
    every offer after ``delay_s``, each answer on its own timer."""
    broker = mem.MemoryBroker(url)
    await broker.connect()
    await broker.declare_queue("sq.kv.slow")
    timers = set()

    async def answer(req):
        await asyncio.sleep(delay_s)
        await broker.publish(req["reply_to"], json.dumps(
            {"req": req["req"], "accepted": True}).encode("utf-8"))

    async def take(msg):
        await msg.ack()
        task = asyncio.create_task(answer(json.loads(msg.body)))
        timers.add(task)
        task.add_done_callback(timers.discard)

    await broker.consume("sq.kv.slow", take, prefetch=16)
    return broker


def test_offers_to_a_decode_peer_run_side_by_side_unlike_the_reference():
    """Queue 3 item 19: the reference's offers wait on one another (one
    reply queue a worker, held for each offer's whole wait); the port's
    match their replies by request id, so four offers to a peer that
    answers each after 0.3 s take about 0.3 s, not 1.2 s. Each accepted
    job then lands on the peer's ``<q>.d.<peer>`` once."""
    delay = 0.3

    async def main(pkg):
        url = f"memory://{_ns('offers')}"
        peer = await _slow_decode_peer(PKGS[pkg][3], url, delay)
        if pkg == "port":
            w = _stub_worker(url, "pre", "prefill")
        else:
            from llmq_tpu.workers.tpu_worker import TPUWorker

            w = TPUWorker("sq", model="preset://tiny", config=jconfig.Config(
                broker_url=url, worker_role="prefill", max_redeliveries=1000),
                engine_factory=lambda _: None)
        await w.broker.connect()
        t0 = time.monotonic()
        took = await asyncio.gather(*(w._offer_adoption("slow", f"j{i}", b'{"id": "j%d"}' % i)
                                      for i in range(4)))
        wall = time.monotonic() - t0
        parked = await _drain(w.broker, "sq.d.slow")
        await w.broker.disconnect()
        await peer.close()
        return took, wall, parked

    took, wall, parked = asyncio.run(main("port"))
    assert took == [True] * 4 and sorted(parked) == [f"j{i}" for i in range(4)]
    assert wall < 3 * delay
    ref_took, ref_wall, _ = asyncio.run(main("jax"))
    assert ref_took == [True] * 4 and ref_wall >= 4 * delay


@pytest.mark.parametrize("case", ["port_offer", "reference_offer", "not_decoding"])
def test_a_decode_worker_answers_both_kinds_of_offer(case):
    """A decode worker accepts the port's offer (no payload: the offerer
    publishes the job once accepted) without parking anything, parks the
    reference's payload-carrying offer on its ``<q>.d.<id>`` under the job
    id before it accepts, and answers busy while it serves another role."""
    url = f"memory://{_ns(case)}"

    async def main():
        w = _stub_worker(url, "dec", "prefill" if case == "not_decoding" else "decode")
        await w.broker.connect()
        await w.broker.broker.declare_queue("replies")
        w.running = True
        payload = "" if case == "port_offer" else '{"id": "job-x", "prompt": "p"}'
        await w._serve_adopt_offer({"adopt": payload, "reply_to": "replies", "req": "job-x"})
        reply = json.loads((await w.broker.broker.get("replies")).body)
        parked = []
        while (msg := await w.broker.broker.get("sq.d.dec")) is not None:
            parked.append((msg.message_id, msg.body))
            await msg.ack()
        await w.broker.disconnect()
        return reply, parked

    reply, parked = asyncio.run(main())
    if case == "not_decoding":
        assert reply == {"req": "job-x", "busy": True} and parked == []
    else:
        assert reply == {"req": "job-x", "accepted": True}
        assert parked == ([] if case == "port_offer"
                          else [("job-x", b'{"id": "job-x", "prompt": "p"}')])


# --- the orphan janitor ----------------------------------------------------------------

def test_janitor_reclaims_dead_workers_queues_exactly_once_as_jax(monkeypatch):
    """A dead worker's ``<q>.w.<id>`` goes back to the shared queue and a
    dead decode worker's ``<q>.d.<id>`` to ``<q>.decode``, once; the queues
    (and ``<q>.kv.<id>``) stop existing, a live worker's private queue
    keeps its message, and a second pass moves nothing. With
    ``LLMQ_WATCHDOG_RECLAIM`` a worker that still beats but reports a
    wedged engine (``last_dispatch_ok_age_s`` past the limit) is reclaimed
    too; without it, it is not. Both packages, the same counts."""

    async def main(pkg):
        manager, config, models, mem = PKGS[pkg]
        ns = _ns("janitor")
        mgr = manager.BrokerManager(config.Config(broker_url=f"memory://{ns}",
                                                  max_redeliveries=1000))
        await mgr.connect()
        await mgr.setup_queue_infrastructure("oq")
        names = {w: (manager.affinity_queue_name("oq", w), manager.kv_fetch_queue_name("oq", w),
                     manager.decode_adopt_queue_name("oq", w)) for w in ("deadw", "livew")}
        for qs in names.values():
            for name in qs:
                await mgr.broker.declare_queue(name)
        for i in range(4):
            await mgr.publish_job(names["deadw"][0], models.Job(id=f"o{i}", prompt=f"s {i}"))
        for i in range(2):
            await mgr.broker.publish(names["deadw"][2], b"{}", message_id=f"adopt{i}",
                                     headers={"x-keep": i})
        await mgr.broker.publish(names["livew"][0], b"{}", message_id="keep")
        mgr._worker_seen["oq"] = {"deadw": time.time() - 1000.0, "livew": time.time()}
        first = await mgr.reclaim_orphaned_affinity_queues("oq")
        shared, pool = await _drain(mgr, "oq"), []
        while (msg := await mgr.broker.get("oq.decode")) is not None:
            pool.append((msg.message_id, msg.headers.get("x-keep")))
            await msg.ack()
        core = mem.get_namespace(ns)
        gone = [name for name in names["deadw"] if name not in core.queues]
        keep = await mgr.broker.get(names["livew"][0])
        kept = keep.message_id
        await keep.reject(requeue=True)
        second = await mgr.reclaim_orphaned_affinity_queues("oq")
        # A live heartbeat that reports a wedged engine.
        health = models.WorkerHealth(worker_id="livew", status="running", jobs_processed=1,
                                     last_seen=models.utcnow(), last_dispatch_ok_age_s=500.0)
        await mgr.broker.publish("oq.health", health.model_dump_json().encode("utf-8"))
        monkeypatch.delenv("LLMQ_WATCHDOG_RECLAIM", raising=False)
        unwedged = await mgr.reclaim_orphaned_affinity_queues("oq")
        monkeypatch.setenv("LLMQ_WATCHDOG_RECLAIM", "100")
        wedged = await mgr.reclaim_orphaned_affinity_queues("oq")
        monkeypatch.delenv("LLMQ_WATCHDOG_RECLAIM")
        out = dict(first=first, shared=sorted(shared), pool=sorted(pool), gone=len(gone),
                   kept=kept, second=second, unwedged=unwedged, wedged=wedged,
                   total=mgr.affinity_reclaimed, seen=sorted(mgr._worker_seen["oq"]),
                   back=await _drain(mgr, "oq"))
        await mgr.disconnect()
        mem.reset_namespace(ns)
        return out

    port, ref = asyncio.run(main("port")), asyncio.run(main("jax"))
    assert port == ref
    assert port["first"] == 6 and port["shared"] == [f"o{i}" for i in range(4)]
    assert port["pool"] == [("adopt0", 0), ("adopt1", 1)] and port["gone"] == 3
    assert port["kept"] == "keep" and port["second"] == 0 and port["unwedged"] == 0
    assert port["wedged"] == 1 and port["back"] == ["keep"] and port["total"] == 7
    assert port["seen"] == []
    monkeypatch.setenv("LLMQ_WATCHDOG_RECLAIM", "soon")
    with pytest.raises(ValueError, match="LLMQ_WATCHDOG_RECLAIM"):
        tmanager.watchdog_reclaim_s()


@pytest.mark.parametrize("scheme", ["memory", "file", "tcp"])
def test_delete_queue_removes_the_queue_on_each_transport(tmp_path, scheme):
    """``delete_queue`` drops a queue and what it holds, through the
    resilient session (which also forgets it, so a re-dial does not
    declare it again); another queue is untouched."""
    from llmq_tpu_torch.broker.resilient import ResilientBroker
    from llmq_tpu_torch.broker.tcp import BrokerServer

    async def main():
        server = None
        if scheme == "tcp":
            server = BrokerServer("127.0.0.1", 0)
            await server.start()
            url = f"tcp://127.0.0.1:{server._server.sockets[0].getsockname()[1]}"
        else:
            url = f"memory://{_ns('delete')}" if scheme == "memory" else f"file://{tmp_path}/b"
        broker = ResilientBroker(url)
        await broker.connect()
        for name in ("gone", "kept"):
            await broker.declare_queue(name, ttl_ms=60_000)
            await broker.publish(name, b"x", message_id=name)
        await broker.delete_queue("gone")
        await broker.delete_queue("never-declared")  # no error
        dirs = (sorted(p.name for p in (tmp_path / "b" / "queues").iterdir())
                if scheme == "file" else [None])
        out = ("gone" in broker._topology, (await broker.stats("gone")).message_count or 0,
               (await broker.stats("kept")).message_count, len(dirs))
        await broker.close()
        if server is not None:
            await server.stop()
        return out

    assert asyncio.run(main()) == (False, 0, 1, 1)  # on file://, only "kept" has a directory


# --- the auto role's controller ---------------------------------------------------------

async def _collect(mgr, queue, want, timeout=30.0):
    got, deadline = set(), time.monotonic() + timeout
    while not want <= got:
        assert time.monotonic() < deadline, f"missing {sorted(want - got)}"
        msg = await mgr.broker.get(queue)
        if msg is None:
            await asyncio.sleep(0.01)
            continue
        got.add(json.loads(msg.body)["id"])
        await msg.ack()
    return got


async def _auto_trace(pkg, scenario):
    """Drive one package's auto-role ``DummyWorker`` through a scenario and
    record (role served, switches) after each controller call."""
    manager, config, models, mem = PKGS[pkg]
    dummy = tdummy if pkg == "port" else jdummy
    ns = _ns(scenario)
    cfg = dict(broker_url=f"memory://{ns}", max_redeliveries=1000, worker_role="auto",
               role_dwell_s=3600.0 if scenario == "dwell" else 0.0, role_check_interval_s=0.0)
    trace = []
    if scenario == "fixed":
        for role in ("prefill", "decode", "unified"):
            w = dummy.DummyWorker("aq", delay=0, config=config.Config(**{**cfg, "worker_role": role}))
            w.running = True
            await w._maybe_switch_role()  # no broker traffic: it is not even connected
            trace.append((role, w.role_active, w.role_switches))
        return trace
    w = dummy.DummyWorker("aq", delay=0.01, config=config.Config(**cfg))
    await w.initialize()
    w.running = True
    trace.append((w.role, w.role_active))
    mgr = manager.BrokerManager(config.Config(broker_url=f"memory://{ns}", max_redeliveries=1000))
    await mgr.connect()
    try:
        if scenario == "band":
            await w._maybe_switch_role()
            trace.append((w.role_active, w.role_switches))
            w.role_active = "decode"
            await w._maybe_switch_role()
            trace.append((w.role_active, w.role_switches))
            return trace
        first = [models.Job(id=f"a{i}", prompt=f"x{i}") for i in range(6)]
        for job in first:
            await mgr.publish_job(manager.decode_queue_name("aq"), job)
        await w._maybe_switch_role()
        trace.append((w.role_active, w.role_switches))
        if scenario == "dwell":
            w._role_since = float("-inf")
            await w._maybe_switch_role()
            trace.append((w.role_active, w.role_switches))
        await _collect(mgr, "aq.results", {j.id for j in first})
        if scenario == "both_ways":
            second = [models.Job(id=f"b{i}", prompt=f"y{i}") for i in range(6)]
            for job in second:
                await mgr.publish_job("aq", job)
            await w._maybe_switch_role()
            trace.append((w.role_active, w.role_switches))
            await _collect(mgr, "aq.results", {j.id for j in second})
        trace.append(w._stats_with_robustness())
        return trace
    finally:
        await mgr.disconnect()
        await w.shutdown()
        mem.reset_namespace(ns)


@pytest.mark.parametrize("scenario", ["both_ways", "band", "dwell", "fixed"])
def test_auto_role_controller_flips_as_the_jax_controller(scenario):
    """A decode backlog flips prefill -> decode and a shared backlog after
    it back, each backlog served; a ratio inside the band holds either
    role; a long dwell blocks the flip until it has passed; the fixed roles
    never switch. The same trace, role for role, as the reference's."""
    port = asyncio.run(_auto_trace("port", scenario))
    assert port == asyncio.run(_auto_trace("jax", scenario))
    want = {"both_ways": [("auto", "prefill"), ("decode", 1), ("prefill", 2)],
            "band": [("auto", "prefill"), ("prefill", 0), ("decode", 0)],
            "dwell": [("auto", "prefill"), ("prefill", 0), ("decode", 1)],
            "fixed": [(r, r, 0) for r in ("prefill", "decode", "unified")]}[scenario]
    assert port[:len(want)] == want


# --- shipping prefix pages between two port workers -------------------------------------

# Page 8, chunks of 32, the prefix cache and a host tier; room for a
# 280-character template.
SHIP = dict(max_num_seqs=4, max_model_len=320, page_size=8, num_pages=200, kv_dtype="f32",
            min_prefill_bucket=16, prefill_chunk_size=32, enable_prefix_caching=True,
            prefix_host_gb=0.05, admit_max_wait_s=1e9)
_JAX = []


def jax_ship_core():
    """The file's JAX engine (SHIP), built once."""
    if not _JAX:
        _JAX.append(jengine.EngineCore(
            JCFG, jax.tree.map(jnp.asarray, TREE), JByteTokenizer(),
            mesh=make_mesh(tensor_parallel=1),
            engine_config=jengine.EngineConfig(**{**SHIP, "kv_dtype": jnp.float32})))
    core = _JAX[0]
    core.abort_all("reset")  # both prefix tiers emptied
    return core


def ship_core(**overrides):
    return tengine.EngineCore(TCFG, params_from_numpy(TREE), ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(**{**SHIP, **overrides}))


def _peer(url, wid, queue="sq", **cfg):
    return tworker.TorchWorker(
        queue, tengine.AsyncEngine(ship_core()), broker_url=url, worker_id=wid, concurrency=4,
        config=tconfig.Config(broker_url=url, prefix_affinity=True, max_redeliveries=1000, **cfg))


def _job(rid, tail, n=6):
    return tmodels.Job(id=rid, prompt=TEMPLATE + tail, temperature=0.0, max_tokens=n,
                       ignore_eos=True)


async def _warm_advertiser(url, **cfg):
    """Worker A, serving its KV RPC, after one templated job: it holds the
    template's pages and advertises its chain in a heartbeat."""
    a = _peer(url, "peer-a", **cfg)
    await a.initialize()
    a.running = True
    await a._start_extra_consumers()
    await a._process_job(_job("warm", " item 0"))
    await a._publish_heartbeat()
    return a


async def _close(*workers):
    for w in workers:
        await w.broker.disconnect()
        w.engine.shutdown()


def _jax_worker_tokens(job):
    """The job served by a unified JAX ``TPUWorker`` over the file's engine."""
    from llmq_tpu.broker.base import make_broker as jmake_broker
    from llmq_tpu.workers.tpu_worker import TPUWorker

    url = f"memory://{_ns('jaxw')}"

    async def main():
        broker = jmake_broker(url)
        await broker.connect()
        await broker.publish("sq", job.model_dump_json().encode(), message_id=job.id)
        worker = TPUWorker("sq", model="preset://tiny",
                           config=jconfig.Config(broker_url=url, result_digest=True),
                           engine_factory=lambda w: jengine.AsyncEngine(jax_ship_core()))
        task = asyncio.create_task(worker.run())
        deadline = time.monotonic() + 60
        while (msg := await broker.get("sq.results")) is None:
            assert time.monotonic() < deadline, "the JAX worker gave no result"
            await asyncio.sleep(0.02)
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=60)
        await broker.close()
        return json.loads(msg.body)["token_ids"]

    return asyncio.run(main())


def test_two_workers_ship_prefix_pages_with_the_jax_workers_tokens():
    """A advertises the template; B, a fresh engine with empty caches,
    fetches the pages it lacks from A before it prefills (chunks that pass
    their outer digest land in its host tier), promotes them, prefills
    only the rest, and gives the tokens of a cold port engine and of a JAX
    ``TPUWorker`` for the same job."""
    url = f"memory://{_ns('ship')}"
    job = _job("cold-on-b", " item 99")

    async def main():
        a = await _warm_advertiser(url)
        b = _peer(url, "peer-b")
        await b.initialize()
        b.running = True
        store = b.engine.core.prefix_store
        assert len(store) == 0
        out = await b._process_job(job)
        st = b.engine.core.stats()
        res = (a.prefix_chunks_served, b.prefix_chunks_fetched, len(store), st, out,
               a._prefix_chains(), b.stats(), a._engine_stats())
        await _close(a, b)
        return res

    served, fetched, stored, st, out, chains, b_stats, a_stats = asyncio.run(main())
    cold_core = ship_core()
    cold = run(cold_core, [(job.id, job.prompt, 6)])[job.id]
    want = len(digests(job.prompt))
    assert fetched == stored == want == served and want == (len(job.prompt) - 1) // 8
    assert st["prefix_promotes"] == want and st["prefix_cache_hit_pages"] == want
    assert st["prefill_tokens"] == cold_core.stats()["prefill_tokens"] - 8 * want
    assert list(out.token_ids) == list(cold.token_ids) == _jax_worker_tokens(job)
    assert chains == thashing.text_prefix_chain(TEMPLATE + " item 0")
    assert b_stats["prefix_chunks_fetched"] == want and a_stats["prefix_chunks_served"] == want


@pytest.mark.parametrize("failure", ["timeout", "busy_cap", "busy_governor", "digest"])
def test_a_failed_fetch_prefills_locally(monkeypatch, failure):
    """A peer that never answers costs the fetch timeout and a negative-cache
    entry; one that answers busy (its serve cap for this requester reached,
    or its governor past the serve rung under a tiny budget) costs no
    wait and no cache entry; chunks that fail their outer digest are not
    ingested. Each time B prefills locally with a cold engine's tokens."""
    monkeypatch.setattr(tworker, "PREFIX_FETCH_TIMEOUT_S", 0.3)
    url = f"memory://{_ns(failure)}"
    job = _job("local", " item 7")
    gov = None

    async def main():
        nonlocal gov
        cap = dict(peer_serve_concurrency=1) if failure == "busy_cap" else {}
        a = await _warm_advertiser(url, **cap)
        if failure == "timeout":
            await a.broker.cancel(a._extra_tags.pop(), requeue=False)  # a ghost: no server
        elif failure == "busy_cap":
            a._peer_serving["peer-b"] = 1  # one export for B in flight already
        elif failure == "busy_governor":
            gov = host_mem.HostMemoryGovernor(1000)
            gov.register("held", lambda: 990)
            host_mem.set_governor(gov)
        elif failure == "digest":  # one digest damaged in transit
            publish = a.broker.broker.publish

            async def damaged(queue, body, **kw):
                if queue.endswith(".r"):
                    reply = json.loads(body)
                    reply["digests"][0] = "0" * 32
                    body = json.dumps(reply).encode("utf-8")
                await publish(queue, body, **kw)

            a.broker.broker.publish = damaged
        b = _peer(url, "peer-b")
        await b.initialize()
        b.running = True
        t0 = time.monotonic()
        out = await b._process_job(job)
        res = dict(wait=time.monotonic() - t0, fetched=b.prefix_chunks_fetched,
                   stored=len(b.engine.core.prefix_store), failures=b.kv_fetch_failures,
                   timeouts=b.prefix_fetch_timeouts, dead=sorted(b._dead_peers),
                   busy=a.kv_serve_busy_rejects, served=a.prefix_chunks_served,
                   tokens=list(out.token_ids))
        await _close(a, b)
        return res

    try:
        res = asyncio.run(main())
    finally:
        host_mem.set_governor(None)
    assert res["fetched"] == res["stored"] == 0 and res["failures"] == 1
    assert res["tokens"] == list(run(ship_core(), [(job.id, job.prompt, 6)])[job.id].token_ids)
    assert res["timeouts"] == (failure == "timeout")
    assert res["dead"] == (["peer-a"] if failure == "timeout" else [])
    assert res["busy"] == (failure.startswith("busy"))
    assert res["wait"] >= 0.3 if failure == "timeout" else res["wait"] < 3.0
    if failure == "busy_governor":
        assert gov.serve_refusals == 1 and gov.stats()["serve_refusals"] == 1
    if failure == "digest":
        assert res["served"] > 0


def test_prefix_queries_equal_the_jax_engine_after_the_same_requests():
    """``missing_prefix_digests`` of a port engine and of the JAX engine
    after the same requests and flushes, and through the ``AsyncEngine``
    wrappers."""
    a, b = TEMPLATE + " alpha?", "another long template " * 14
    port, ref = ship_core(), jax_ship_core()
    for core, cls in ((port, TParams), (ref, JParams)):
        run(core, [("a", a, 3)], cls)
        core.flush_prefix_to_host()
        run(core, [("a2", a, 3), ("b", b, 3)], cls)
    asked = digests(a) + digests(b) + digests(TEMPLATE + " beta? " + "q" * 40) + ["nothex", "00"]
    assert port.missing_prefix_digests(asked) == ref.missing_prefix_digests(asked)
    assert 0 < len(port.missing_prefix_digests(asked)) < len(asked) - 2
    eng = tengine.AsyncEngine(port)
    try:
        assert eng.missing_prefix_digests(asked) == ref.missing_prefix_digests(asked)
        chunks = eng.export_prefix_chunks(digests(a))
        assert len(chunks) == len(digests(a))
        assert ship_core().ingest_prefix_chunks(chunks) == len(chunks)
    finally:
        eng.shutdown()
