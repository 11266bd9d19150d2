"""The port's broker manager and queue policy against the reference's.

``llmq_tpu_torch/broker/manager.py`` and ``workers/base.py`` held against
``llmq_tpu/broker/manager.py`` and ``llmq_tpu/workers/base.py`` over
each package's own ``memory://`` core (ROADMAP.md queue 3 items 9 and
10): the queues a worker declares with their TTL and redelivery caps,
the dead letter of an unparseable payload, ``publish_job``'s deadline
stamping, fast-lane routing and admission shedding, the dead-letter
queue's readers, and the core's redelivery backoff; and every field of
``llmq_tpu/core/config.py::Config``, read by the port's ``Config`` with
the reference's variable, default and alias order (or, for the two
the engine reads, by the port's engine), or refused at a non-default
value with its ROADMAP.md item (queue 3 item 11). No engine is built:
the port's worker runs over a stub that has the engine's surface its
setup touches.
"""

import asyncio
import json
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

import llmq_tpu.core.config as jconfig
import llmq_tpu_torch.core.config as tconfig
from llmq_tpu.broker import memory as jmem
from llmq_tpu.broker.base import DeliveredMessage as JDelivered
from llmq_tpu.broker.manager import BrokerManager as JManager
from llmq_tpu.core.config import Config as JConfig
from llmq_tpu.core.models import Job as JJob
from llmq_tpu.core.models import WorkerHealth as JHealth
from llmq_tpu.obs import TRACE_FIELD
from llmq_tpu.utils import clock as jclock
from llmq_tpu.workers.dummy import DummyWorker
from llmq_tpu_torch.broker import memory as tmem
from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.engine.engine import EngineConfig, priority_settings
from llmq_tpu_torch.utils import clock as tclock
from llmq_tpu_torch.workers.torch_worker import TorchWorker

pytestmark = pytest.mark.unit

QUEUE = "mq"
POLICY_VARS = ("LLMQ_MAX_REDELIVERIES", "LLMQ_JOB_TTL_MINUTES", "LLMQ_PRIORITY_CLASSES",
               "LLMQ_WORKER_ROLE", "LLMQ_QUARANTINE_ATTEMPTS", "LLMQ_REDELIVERY_BACKOFF_S",
               "LLMQ_REDELIVERY_BACKOFF_MAX_S", "LLMQ_DEADLINE_MS", "LLMQ_JOB_TIMEOUT_S",
               "LLMQ_BREAKER_FAILURES", "LLMQ_BROKER_URL")


@pytest.fixture(autouse=True)
def _clean_policy_env(monkeypatch):
    for var in POLICY_VARS:
        monkeypatch.delenv(var, raising=False)


def _ns(tag: str) -> str:
    return f"{tag}-{uuid.uuid4().hex[:8]}"


class StubEngine:
    """The engine surface a worker touches outside its jobs: the slot
    count (prefetch), ``stats()`` (heartbeats), ``handoff()`` (drain)."""

    error = None

    def __init__(self, slots: int = 4) -> None:
        self.core = SimpleNamespace(cfg=SimpleNamespace(max_num_seqs=slots))

    def stats(self) -> dict:
        return {}

    def handoff(self, timeout: float = 120.0) -> list:
        return []


def _policies(core) -> dict:
    return {name: (q.ttl_ms, q.max_redeliveries) for name, q in core.queues.items()}


def _policies_by_role(core, worker_id: str) -> dict:
    """``_policies`` with the worker's id in a per-worker queue's name
    replaced by ``<id>`` (the two packages' workers have different ids)."""
    return {name.replace(worker_id, "<id>"): policy for name, policy in _policies(core).items()}


async def _reference_setup(ns: str) -> dict:
    from llmq_tpu.workers.tpu_worker import TPUWorker

    worker = DummyWorker(QUEUE, delay=0, config=JConfig(broker_url=f"memory://{ns}"))
    await worker.initialize()  # BaseWorker.initialize: setup_queue_infrastructure + .health
    # The engine worker's extra consumers (the control queue <q>.ctl.<id>
    # with the priority classes on), run over this worker.
    worker._serve_ctl = worker._serve_kv_fetch = None
    worker._prefix_enabled = lambda: False
    await TPUWorker._start_extra_consumers(worker)
    policies = _policies_by_role(jmem.get_namespace(ns), worker.worker_id)
    await worker.broker.disconnect()
    return policies


async def _port_setup(ns: str) -> dict:
    """The port worker's own setup: run until it consumes, then stop."""
    core = tmem.get_namespace(ns)
    worker = TorchWorker(QUEUE, StubEngine(), broker_url=f"memory://{ns}")
    task = asyncio.create_task(worker.run())
    deadline = time.monotonic() + 10
    while not (QUEUE in core.queues and core.queues[QUEUE].consumers):
        assert time.monotonic() < deadline and not task.done(), "the worker never consumed"
        await asyncio.sleep(0.01)
    policies = _policies_by_role(core, worker.worker_id)
    worker.request_shutdown()
    await asyncio.wait_for(task, timeout=10)
    return policies


SETUP_CASES = {
    "unset": {},
    "ttl-and-cap": {"LLMQ_MAX_REDELIVERIES": "7", "LLMQ_JOB_TTL_MINUTES": "5"},
    "priority-classes-off": {"LLMQ_PRIORITY_CLASSES": "0"},
    "role-prefill": {"LLMQ_WORKER_ROLE": "prefill"},
    "quarantine": {"LLMQ_QUARANTINE_ATTEMPTS": "2"},
}


@pytest.mark.parametrize("env", SETUP_CASES.values(), ids=list(SETUP_CASES))
def test_worker_declares_its_queues_as_the_reference(monkeypatch, env):
    """The same queues, each with the same (ttl_ms, max_redeliveries), as
    the reference's ``BaseWorker.initialize`` and its engine worker's
    extra consumers declare them (queue 3 item 9: the port declared every
    queue (None, 3))."""
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    ns = _ns("setup")
    try:
        want = asyncio.run(_reference_setup(ns))
        got = asyncio.run(_port_setup(ns))
    finally:
        jmem.reset_namespace(ns)
        tmem.reset_namespace(ns)
    assert got == want


def test_unparseable_payload_dead_letters_as_the_reference(monkeypatch):
    """The same garbage body (with headers of its own) gives the same
    dead letter on ``<q>.failed`` (body, id, headers but the worker id's
    value) and the same settle, ``reject(requeue=False)`` (queue 3 item
    10: the port wrote its own headers and acked)."""
    body = bytes(np.random.default_rng(11).integers(32, 127, 40, dtype=np.uint8)) + b"{"
    headers = {"x-origin": "upstream", "trace": "t-1"}
    ns = _ns("garbage")

    async def reference():
        worker = DummyWorker(QUEUE, delay=0, config=JConfig(broker_url=f"memory://{ns}"))
        await worker.initialize()
        settles = []

        async def record(verb, requeue):
            settles.append((verb, requeue))

        await worker._process_message(JDelivered(body, "bad-1", headers=dict(headers),
                                                 _settle=record))
        msg = await worker.broker.broker.get(QUEUE + ".failed")
        await msg.ack()
        await worker.broker.disconnect()
        return (msg.body, msg.message_id, msg.headers), settles, worker.worker_id

    async def port():
        core = tmem.get_namespace(ns)
        settles = []
        real = tmem.BrokerCore.settle

        def record(self, queue, message_id, verb, requeue):
            if queue == QUEUE:
                settles.append((verb, requeue))
            return real(self, queue, message_id, verb, requeue)

        monkeypatch.setattr(tmem.BrokerCore, "settle", record)
        core.publish(QUEUE, body, message_id="bad-1", headers=dict(headers))
        worker = TorchWorker(QUEUE, StubEngine(), broker_url=f"memory://{ns}")
        task = asyncio.create_task(worker.run())
        deadline = time.monotonic() + 10
        while not core.stats(QUEUE + ".failed").message_count:
            assert time.monotonic() < deadline and not task.done(), "nothing dead-lettered"
            await asyncio.sleep(0.01)
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=10)
        msg = core.get_one(QUEUE + ".failed")
        return (msg.body, msg.message_id, msg.headers), settles, worker.worker_id

    try:
        (jbody, jid, jheaders), jsettles, jwid = asyncio.run(reference())
        (tbody, tid, theaders), tsettles, twid = asyncio.run(port())
    finally:
        jmem.reset_namespace(ns)
        tmem.reset_namespace(ns)
    assert (tbody, tid) == (jbody, jid) == (body, "bad-1")
    assert jheaders["x-worker-id"] == jwid and theaders.get("x-worker-id") == twid
    assert {**theaders, "x-worker-id": None} == {**jheaders, "x-worker-id": None}
    assert tsettles == jsettles == [("reject", False)]


class _FrozenClock:
    def __init__(self, t: float) -> None:
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t


@pytest.fixture()
def frozen_clocks():
    clk = _FrozenClock(1_700_000_000.0)
    jclock.set_clock(clk)
    tclock.set_clock(clk)
    yield clk
    jclock.set_clock(jclock.Clock())
    tclock.set_clock(tclock.Clock())


def _heartbeat(worker_id: str, avg_ms: float, at: float) -> bytes:
    from datetime import datetime, timezone

    return JHealth(worker_id=worker_id, status="running", jobs_processed=10,
                   avg_duration_ms=avg_ms,
                   last_seen=datetime.fromtimestamp(at, tz=timezone.utc)).model_dump_json().encode()


def _submit_jobs():
    return [
        dict(id="plain", prompt="p"),
        dict(id="stamped", prompt="p", deadline_ms=60_000),
        dict(id="vip", prompt="p", priority="interactive", deadline_ms=60_000),
        dict(id="doomed", prompt="p", deadline_ms=500),
        dict(id="vip-tight", prompt="p", priority="interactive", deadline_ms=500),
        dict(id="default-deadline", prompt="p"),
    ]


async def _publish_all(manager_cls, cfg_cls, job_cls, core, ns, clk, deadline_ms):
    """Two fresh heartbeats (1 job/s each: 2 jobs/s), a batch backlog of 3
    and an empty fast lane; then each job published through the manager.
    Returns {queue: [(id, payload, headers)]} and the counters."""
    mgr = manager_cls(cfg_cls(broker_url=f"memory://{ns}", deadline_ms=deadline_ms))
    await mgr.connect()
    await mgr.setup_queue_infrastructure(QUEUE)
    for wid in ("w1", "w2"):
        core.publish(QUEUE + ".health", _heartbeat(wid, 1000.0, clk.t))
    for i in range(3):
        core.publish(QUEUE, b"backlog", message_id=f"b{i}")
    for fields in _submit_jobs():
        await mgr.publish_job(QUEUE, job_cls(**fields))
    out = {}
    for name in (QUEUE, QUEUE + ".interactive", QUEUE + ".failed"):
        q = core.queues[name]
        out[name] = [(m.message_id, json.loads(m.body), m.headers) for m in q.ready
                     if not m.message_id.startswith("b")]
    counters = (mgr.jobs_shed, mgr.jobs_shed_interactive, mgr.interactive_routed)
    await mgr.disconnect()
    return out, counters


@pytest.mark.parametrize("deadline_ms", [0, 250])
def test_publish_job_stamps_routes_and_sheds_as_the_reference(frozen_clocks, deadline_ms):
    """Deadline stamping (the job's budget, else ``LLMQ_DEADLINE_MS``),
    the ``<q>.interactive`` fast lane and admission shedding (depth /
    observed fleet rate against the budget, the lane's own depth for a
    fast-lane job) land each job on the same queue with the same payload
    and headers, the lifecycle trace (``TRACE_FIELD``: ``submitted`` or
    ``shed``, under the frozen clocks) included."""
    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.core.config import Config

    ns = _ns("publish")
    try:
        want, wc = asyncio.run(_publish_all(JManager, JConfig, JJob, jmem.get_namespace(ns), ns,
                                            frozen_clocks, deadline_ms))
        got, gc_ = asyncio.run(_publish_all(BrokerManager, Config, Job, tmem.get_namespace(ns),
                                             ns, frozen_clocks, deadline_ms))
    finally:
        jmem.reset_namespace(ns)
        tmem.reset_namespace(ns)
    assert all(TRACE_FIELD in payload for entries in got.values() for _, payload, _ in entries)
    assert got == want and gc_ == wc
    shed = {mid for mid, _, _ in want[QUEUE + ".failed"]}
    assert "doomed" in shed and "vip-tight" not in shed  # the lane is empty: 0 / 2 < 0.5 s
    assert ("default-deadline" in shed) == (deadline_ms == 250)


async def _dead_letter_queue(manager_cls, cfg_cls, core, ns):
    """Dead letters of three kinds, then the readers: the broker's cap
    (x-death-queue, x-delivery-count), a worker's (x-error, x-worker-id,
    x-failure-reason), a non-JSON body; ``get_failed_jobs`` twice (it
    must not consume), then ``requeue_failed`` with a limit and without."""
    mgr = manager_cls(cfg_cls(broker_url=f"memory://{ns}", max_redeliveries=1))
    await mgr.connect()
    await mgr.setup_queue_infrastructure(QUEUE)
    rng = np.random.default_rng(5)
    for i in range(3):
        await mgr.broker.publish(QUEUE, json.dumps({"id": f"cap{i}", "n": int(rng.integers(99))})
                                 .encode(), message_id=f"cap{i}", headers={"keep": i})
    for _ in range(2):  # two rejections each: past the cap of 1
        for _ in range(3):
            msg = await mgr.broker.get(QUEUE)
            await msg.reject(requeue=True)
    core.publish(QUEUE + ".failed", b'{"id": "w0"}', message_id="w0",
                 headers={"x-error": "boom", "x-worker-id": "w", "x-failure-reason": "timeout",
                          "x-delivery-count": 4, "app": "yes"})
    core.publish(QUEUE + ".failed", b"not json", message_id="raw")
    first = await mgr.get_failed_jobs(QUEUE, limit=10)
    again = await mgr.get_failed_jobs(QUEUE, limit=3)
    moved = [await mgr.requeue_failed(QUEUE, limit=2), await mgr.requeue_failed(QUEUE)]
    requeued = [(m.message_id, m.body, m.headers, m.delivery_count)
                for m in core.queues[QUEUE].ready]
    await mgr.disconnect()

    def rows(errors):
        return [(e.job_id, e.error_message, e.worker_id, e.redeliveries, e.failure_reason)
                for e in errors]

    return rows(first), rows(again), moved, requeued


def test_dead_letter_readers_as_the_reference():
    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.core.config import Config

    ns = _ns("dlq")
    try:
        want = asyncio.run(_dead_letter_queue(JManager, JConfig, jmem.get_namespace(ns), ns))
        got = asyncio.run(_dead_letter_queue(BrokerManager, Config, tmem.get_namespace(ns), ns))
    finally:
        jmem.reset_namespace(ns)
        tmem.reset_namespace(ns)
    assert got == want
    assert want[2] == [2, 3] and len(want[0]) == 5


async def _backoff_trace(mod, probes) -> list:
    """Reject one message three times; after each rejection, whether it is
    ready at each probe time (seconds after the reject)."""
    core = mod.BrokerCore()
    core.declare("bq", max_redeliveries=10)
    core.publish("bq", b"x", message_id="m")
    seen = []
    for _ in range(3):
        deadline = time.monotonic() + 5
        while (msg := core.get_one("bq")) is None:
            assert time.monotonic() < deadline, "the message never came back"
            await asyncio.sleep(0.005)
        await msg.reject(requeue=True)
        t0 = time.monotonic()
        row = []
        for at in probes:
            await asyncio.sleep(max(0.0, t0 + at - time.monotonic()))
            row.append(core.stats("bq").message_count_ready)
        seen.append(row)
    return seen


def test_redelivery_backoff_as_the_reference(monkeypatch):
    """``LLMQ_REDELIVERY_BACKOFF_S`` / ``_MAX_S``: a rejected message comes
    back after base x 2^(attempt-1) seconds, capped, in both cores (the
    port's tcp:// daemon runs the same core), and not before."""
    from llmq_tpu_torch.broker.tcp import BrokerServer

    monkeypatch.setenv("LLMQ_REDELIVERY_BACKOFF_S", "0.1")
    monkeypatch.setenv("LLMQ_REDELIVERY_BACKOFF_MAX_S", "0.2")
    probes = (0.05, 0.15, 0.3)  # attempt delays 0.1, 0.2, 0.2
    want = asyncio.run(_backoff_trace(jmem, probes))
    got = asyncio.run(_backoff_trace(tmem, probes))
    assert got == want == [[0, 1, 1], [0, 0, 1], [0, 0, 1]]
    assert BrokerServer("127.0.0.1", 0).core.redelivery_backoff_s == 0.1


#: every field of the reference's Config -> (its variable, a value other
#: than the default); the aliases the reference reads after the variable.
FIELD_ENV = {
    "broker_url": ("LLMQ_BROKER_URL", "tcp://10.0.0.9:5999/"),
    "queue_prefetch": ("LLMQ_QUEUE_PREFETCH", "37"),
    "reconnect_base_delay_s": ("LLMQ_RECONNECT_BASE_S", "0.25"),
    "reconnect_max_delay_s": ("LLMQ_RECONNECT_MAX_S", "12.5"),
    "outbox_limit": ("LLMQ_OUTBOX_LIMIT", "77"),
    "hbm_utilization": ("TPU_HBM_UTILIZATION", "0.6"),
    "max_num_seqs": ("LLMQ_MAX_NUM_SEQS", "24"),
    "max_model_len": ("LLMQ_MAX_MODEL_LEN", "3000"),
    "max_tokens": ("LLMQ_MAX_TOKENS", "99"),
    "prefill_chunk_size": ("LLMQ_PREFILL_CHUNK", "64"),
    "kv_dtype": ("LLMQ_KV_DTYPE", "fp8"),
    "enable_prefix_caching": ("LLMQ_PREFIX_CACHING", "yes"),
    "prefix_affinity": ("LLMQ_PREFIX_AFFINITY", "1"),
    "decode_block": ("LLMQ_DECODE_BLOCK", "4"),
    "spec_tokens": ("LLMQ_SPEC_TOKENS", "2"),
    "tp_overlap": ("LLMQ_TP_OVERLAP", "ON"),
    "mixed_step": ("LLMQ_MIXED_STEP", "on"),
    "worker_role": ("LLMQ_WORKER_ROLE", "Decode"),
    "role_dwell_s": ("LLMQ_ROLE_DWELL_S", "5"),
    "role_switch_hi": ("LLMQ_ROLE_SWITCH_HI", "3.5"),
    "role_switch_lo": ("LLMQ_ROLE_SWITCH_LO", "0.25"),
    "role_check_interval_s": ("LLMQ_ROLE_CHECK_INTERVAL_S", "1"),
    "handoff_timeout_s": ("LLMQ_HANDOFF_TIMEOUT_S", "4"),
    "result_digest": ("LLMQ_RESULT_DIGEST", "on"),
    "priority_classes": ("LLMQ_PRIORITY_CLASSES", "off"),
    "priority_preempt": ("LLMQ_PRIORITY_PREEMPT", "no"),
    "interactive_decode_block": ("LLMQ_INTERACTIVE_DECODE_BLOCK", "2"),
    "serve_port": ("LLMQ_SERVE_PORT", "9100"),
    "job_ttl_minutes": ("LLMQ_JOB_TTL_MINUTES", "5"),
    "max_redeliveries": ("LLMQ_MAX_REDELIVERIES", "7"),
    "redelivery_backoff_s": ("LLMQ_REDELIVERY_BACKOFF_S", "0.5"),
    "redelivery_backoff_max_s": ("LLMQ_REDELIVERY_BACKOFF_MAX_S", "8"),
    "deadline_ms": ("LLMQ_DEADLINE_MS", "1500"),
    "host_mem_gb": ("LLMQ_HOST_MEM_GB", "1.5"),
    "quarantine_attempts": ("LLMQ_QUARANTINE_ATTEMPTS", "2"),
    "peer_serve_concurrency": ("LLMQ_PEER_SERVE_CONCURRENCY", "5"),
    "breaker_failures": ("LLMQ_BREAKER_FAILURES", "4"),
    "job_timeout_s": ("LLMQ_JOB_TIMEOUT_S", "2.5"),
    "drain_timeout_s": ("LLMQ_DRAIN_TIMEOUT_S", "9"),
    "chunk_size": ("LLMQ_CHUNK_SIZE", "500"),
    "log_level": ("LLMQ_LOG_LEVEL", "DEBUG"),
}
ALIASES = {
    "broker_url": ("BROKER_URL", "RABBITMQ_URL"),
    "queue_prefetch": ("VLLM_QUEUE_PREFETCH",),
    "hbm_utilization": ("VLLM_GPU_MEMORY_UTILIZATION",),
    "max_num_seqs": ("VLLM_MAX_NUM_SEQS",),
    "max_model_len": ("VLLM_MAX_MODEL_LEN",),
    "max_tokens": ("VLLM_MAX_TOKENS",),
    "kv_dtype": ("VLLM_KV_CACHE_DTYPE",),
}
ALL_VARS = sorted({v for v, _ in FIELD_ENV.values()} | {a for al in ALIASES.values() for a in al})
#: the reference's fields whose variables the engine reads over its own
#: EngineConfig, as the reference's engine does -> their place in
#: ``priority_settings``; the port's Config has no second parser for them
ENGINE_READ = {"priority_preempt": 1, "interactive_decode_block": 2}


def _port_value(cfg, name):
    if name in ENGINE_READ:
        return priority_settings(EngineConfig())[ENGINE_READ[name]]
    return getattr(cfg, name, "<no such field>")


def test_every_reference_config_field_is_read_or_refused(monkeypatch):
    """Walk the reference's fields: each is read by the port with the
    reference's variable, default and alias order (the last refused one,
    ``serve_port``, is read since the gateway was ported). The fields in
    ``ENGINE_READ`` are read by the port's engine alone."""
    assert set(FIELD_ENV) == set(jconfig.Config.model_fields), "a reference field is not walked"
    assert not set(ENGINE_READ) & set(tconfig.Config.model_fields), "two readers of one variable"
    for var in ALL_VARS:
        monkeypatch.delenv(var, raising=False)
    ref, port = jconfig.get_config(), tconfig.get_config()
    for name in FIELD_ENV:
        assert _port_value(port, name) == getattr(ref, name), f"{name}: default differs"
    assert port.job_ttl_ms == ref.job_ttl_ms
    for name, (var, value) in FIELD_ENV.items():
        monkeypatch.setenv(var, value)
        ref, port = jconfig.Config(), tconfig.Config()
        assert getattr(ref, name) != jconfig.Config.model_fields[name].get_default(
            call_default_factory=False), f"{name}: {value!r} is its default"
        assert _port_value(port, name) == getattr(ref, name), f"{name} is not read from {var}"
        for alias in ALIASES.get(name, ()):  # an alias is read only after the variable
            monkeypatch.setenv(alias, value if name == "broker_url" else "3")
            assert getattr(tconfig.Config(), name) == getattr(jconfig.Config(), name)
        monkeypatch.delenv(var)
        for alias in ALIASES.get(name, ()):
            assert getattr(tconfig.Config(), name) == getattr(jconfig.Config(), name), alias
            monkeypatch.delenv(alias)
    # The fields once refused (M6's second part, M16's serve port) are walked.
    ported = {"prefix_affinity", "role_dwell_s", "role_switch_hi", "role_switch_lo",
              "role_check_interval_s", "handoff_timeout_s", "peer_serve_concurrency",
              "serve_port"}
    assert ported <= set(FIELD_ENV)
