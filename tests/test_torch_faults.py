"""The port's fault planes (M12) through its engine and worker on the CPU,
each leg held to a fault-free run of the same port engine (other tests tie
that run to the JAX engine):

- a ``DeviceFaultInjector`` ``hang`` (the watchdog trips), ``xla_error``
  and ``oom`` with the ladder pre-exhausted each cost exactly one in-process
  rebuild (the first core's ``num_pages``) through a ``TorchWorker`` over
  ``memory://``: one result per job, token-identical, and the traces carry
  ``device_fault`` -> ``engine_rebuilt``;
- a first ``oom`` is absorbed by the ladder (``shrink_runahead``), no
  rebuild; the ladder's order driven directly;
- ``logit_guard="on"`` gives the tokens of guard off on the default path,
  chunked prefill with the prefix cache, decode blocks with speculation and
  mixed steps;
- a transient NaN flip of the logit projection costs one rebuild with
  identical results; a sticky one quarantines its jobs as
  ``numerical_fault``;
- ``audit_weights`` names a finite weight flip and ``integrity_status``
  reads ``suspect``; the idle sweep contains it with a rebuild; the canary
  passes clean and fails after a flip;
- the heartbeat carries ``last_dispatch_ok_age_s`` / ``integrity`` only
  with the features on;
- a rebuild that fails (a sticky CUDA error) quarantines or requeues the
  jobs with the fault's class in ``x-failure-reason`` and stops the worker
  (ROADMAP.md queue 3: the port's departure);
- the ``LLMQ_*`` variables pin over the fields with the reference's
  messages.
"""

import asyncio
import json
import time

import pytest
import torch

from llmq_tpu_torch.broker.chaos import BitFlipInjector, DeviceFaultInjector
from llmq_tpu_torch.broker.memory import reset_namespace
from llmq_tpu_torch.cli.worker import build_engine
from llmq_tpu_torch.core.config import Config
from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine.sampling import SamplingParams
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models.presets import get_preset
from llmq_tpu_torch.models.transformer import init_params
from llmq_tpu_torch.obs.trace import trace_from_payload
from llmq_tpu_torch.workers.torch_worker import TorchWorker

from test_torch_worker import _drain, _submit

pytestmark = pytest.mark.unit

QUEUE = "jobs"
ENGINE = dict(device="cpu", dtype="float32", max_num_seqs=4, max_model_len=64)
FAULT_VARS = ("LLMQ_WATCHDOG_MULT", "LLMQ_WATCHDOG_MIN_S", "LLMQ_LOGIT_GUARD",
              "LLMQ_GUARD_LOGIT_MAX", "LLMQ_GUARD_ENTROPY_MIN", "LLMQ_WEIGHT_AUDIT_EVERY",
              "LLMQ_CANARY_EVERY", "LLMQ_ACT_STATS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in FAULT_VARS:
        monkeypatch.delenv(name, raising=False)


def _jobs(n: int = 4):
    return [Job(id=f"f{i}", prompt=f"fault job {i} " + "ab " * (i + 1), temperature=0.0,
                max_tokens=12, ignore_eos=True) for i in range(n)]


def _params(job: Job) -> SamplingParams:
    return SamplingParams(temperature=0.0, max_tokens=job.max_tokens, ignore_eos=True)


@pytest.fixture(scope="module")
def baseline():
    """Each job's token ids from a fault-free engine of the same weights."""
    engine = build_engine("preset://tiny", **ENGINE)
    try:
        return {j.id: engine.generate_sync(rid=j.id, prompt=j.prompt, params=_params(j),
                                           timeout=60).token_ids for j in _jobs()}
    finally:
        engine.shutdown()


def _serve(ns: str, engine, jobs, **config) -> tuple:
    """The jobs through a ``TorchWorker`` on ``engine`` over ``memory://ns``
    until each settled; returns (worker, results, quarantine entries)."""
    url = f"memory://{ns}"
    reset_namespace(ns)
    asyncio.run(_submit([j.model_dump_json().encode() for j in jobs], url))
    worker = TorchWorker(QUEUE, engine, max_jobs=len(jobs), config=Config(
        broker_url=url, result_digest=True, max_redeliveries=1000, **config))
    try:
        asyncio.run(worker.run())
    finally:
        engine.shutdown()
    results = [json.loads(b) for b in asyncio.run(_drain(QUEUE + ".results", url))]
    quarantine = asyncio.run(_quarantined(url))
    return worker, results, quarantine


async def _quarantined(url: str) -> list:
    from llmq_tpu_torch.broker.base import make_broker

    broker = make_broker(url)
    await broker.connect()
    out = []
    while (msg := await broker.get(QUEUE + ".quarantine")) is not None:
        out.append((json.loads(msg.body)["id"], dict(msg.headers or {})))
        await msg.ack()
    await broker.close()
    return out


def _check_identical(results, baseline, n_jobs: int = 4) -> None:
    ids = [r["id"] for r in results]
    assert sorted(ids) == sorted(set(ids)) == sorted(baseline)[:n_jobs], ids
    for r in results:
        assert r["token_ids"] == baseline[r["id"]], r["id"]


def _fault_traced(results) -> int:
    """Results whose trace has ``device_fault`` before ``engine_rebuilt``."""
    n = 0
    for r in results:
        names = [e["name"] for e in (trace_from_payload(r) or {}).get("events", [])]
        if "device_fault" in names:
            assert "engine_rebuilt" in names and \
                names.index("device_fault") < names.index("engine_rebuilt"), names
            n += 1
    return n


@pytest.mark.parametrize("mode,seed", [("hang", 21), ("xla_error", 22), ("oom", 23)])
def test_device_fault_costs_one_rebuild_and_identical_results(mode, seed, baseline,
                                                              monkeypatch):
    if mode == "hang":
        # The floor clears a CPU dispatch with room; the hang clears the floor.
        monkeypatch.setenv("LLMQ_WATCHDOG_MULT", "5.0")
        monkeypatch.setenv("LLMQ_WATCHDOG_MIN_S", "1.5")
    engine = build_engine("preset://tiny", **ENGINE)
    pages = engine.core.scheduler.config.num_pages
    injector = DeviceFaultInjector("decode", mode, seed=seed, after_range=(2, 4), hang_s=3.0)
    engine.core.on_dispatch = injector
    if mode == "oom":
        engine.core._oom_rung = 3  # the ladder is dry: the fault must rebuild
    worker, results, quarantine = _serve(f"faults-{mode}", engine, _jobs())
    assert injector.fired and quarantine == [] and worker.error is None
    assert engine.engine_rebuilds == 1
    assert engine.last_fault_reason == {"hang": "hung_dispatch", "xla_error":
                                        "xla_runtime_error", "oom": "hbm_oom"}[mode]
    assert engine.core.scheduler.config.num_pages == pages and engine.core.on_dispatch is None
    assert engine.last_rebuild is not None and min(engine.last_rebuild.values()) >= 0
    if mode == "hang":
        assert engine.watchdog_trips == 1 and engine.stats()["watchdog_trips"] == 1
    _check_identical(results, baseline)
    assert _fault_traced(results) >= 1
    assert worker._engine_stats()["engine_rebuilds"] == 1


def test_first_oom_is_absorbed_by_the_ladder_in_order(baseline):
    engine = build_engine("preset://tiny", **ENGINE)
    injector = DeviceFaultInjector("decode", "oom", seed=31, after_range=(2, 4))
    engine.core.on_dispatch = injector
    worker, results, _ = _serve("faults-ladder", engine, _jobs())
    stats = engine.stats()
    assert injector.fired and engine.engine_rebuilds == 0
    assert (stats["hbm_oom_events"], stats["oom_degradations"]) == (1, ["shrink_runahead"])
    assert engine.core.cfg.runahead == tengine.EngineConfig().runahead // 2
    _check_identical(results, baseline)
    # The ladder's order with the pipeline live and no prefix tier.
    core = build_engine("preset://tiny", **ENGINE).core
    for j in _jobs():
        core.add_request(j.id, prompt=j.prompt, params=_params(j))
    for _ in range(4):
        core.step()
    assert [core.degrade_for_oom() for _ in range(3)] == ["shrink_runahead", "preempt_swap",
                                                          None]


def _tiny_core(params, **fields):
    cfg = tengine.EngineConfig(max_num_seqs=4, max_model_len=64, **fields)
    return tengine.EngineCore(get_preset("tiny"), params, ByteTokenizer(), device="cpu",
                              engine_config=cfg)


def _run(core, jobs) -> dict:
    for j in jobs:
        core.add_request(j.id, prompt=j.prompt, params=_params(j))
    outs = {}
    while core.has_work:
        outs.update({o.rid: o.token_ids for o in core.step()})
    return outs


@pytest.fixture(scope="module")
def tiny_params():
    return init_params(get_preset("tiny"), torch.Generator().manual_seed(0), torch.float32)


@pytest.mark.parametrize("fields", [
    {}, dict(prefill_chunk_size=16, enable_prefix_caching=True),
    dict(decode_block=2, spec_tokens=2), dict(mixed_step="on", prefill_chunk_size=16),
], ids=["default", "chunked", "spec", "mixed"])
def test_logit_guard_on_gives_the_tokens_of_guard_off(fields, tiny_params):
    jobs = [Job(id=f"g{i}", prompt="shared head of the prompt " + "xy " * (3 * i + 1),
                max_tokens=10) for i in range(4)]
    off = _run(_tiny_core(tiny_params, **fields), jobs)
    core = _tiny_core(tiny_params, logit_guard="on", guard_logit_max=1e6,
                      guard_entropy_min=1e-6, **fields)
    assert _run(core, jobs) == off
    stats = core.stats()
    assert core.guard_trips == 0 and stats["integrity"] == "ok" and "guard_trips" not in stats


def test_transient_nan_flip_costs_one_rebuild(baseline, monkeypatch):
    monkeypatch.setenv("LLMQ_LOGIT_GUARD", "on")
    engine = build_engine("preset://tiny", **ENGINE)
    injector = BitFlipInjector("logit", mode="nan", seed=41, after_range=(2, 4)).bind(engine.core)
    worker, results, quarantine = _serve("faults-transient", engine, _jobs())
    assert injector.fired == 1 and quarantine == []
    assert (engine.engine_rebuilds, engine.last_fault_reason) == (1, "numerical_fault")
    assert engine.core.guard_trips == 0 and engine._numerical_probation == {}
    _check_identical(results, baseline)
    assert _fault_traced(results) >= 1


def test_sticky_flip_quarantines_its_jobs_as_numerical_fault(monkeypatch):
    monkeypatch.setenv("LLMQ_LOGIT_GUARD", "on")
    engine = build_engine("preset://tiny", **ENGINE)
    injector = BitFlipInjector("logit", mode="nan", seed=43, after_range=(1, 2), sticky=True)
    injector.bind(engine.core)
    jobs = _jobs(2)
    url = "memory://faults-sticky"
    reset_namespace("faults-sticky")
    asyncio.run(_submit([j.model_dump_json().encode() for j in jobs], url))
    worker = TorchWorker(QUEUE, engine, max_jobs=len(jobs), config=Config(
        broker_url=url, max_redeliveries=1000, quarantine_attempts=2))
    rebuild = engine.rebuild_core

    def rebuild_with_injector():
        core = rebuild()
        injector.bind(core)  # re-armed: the rebuilt core corrupts again
        return core

    engine.rebuild_core = rebuild_with_injector
    try:
        asyncio.run(worker.run())
    finally:
        engine.shutdown()
    quarantine = asyncio.run(_quarantined(url))
    assert sorted(mid for mid, _ in quarantine) == [j.id for j in jobs]
    assert {h["x-failure-reason"] for _, h in quarantine} == {"numerical_fault"}
    assert worker.jobs_quarantined == len(jobs) and worker.error is None
    assert injector.fired >= 2 and engine.engine_rebuilds >= 2
    assert asyncio.run(_drain(QUEUE + ".results", url)) == []
    assert asyncio.run(_drain(QUEUE, url)) == []


def _fresh(params) -> dict:
    """A copy of a parameter tree (a flip must not reach the shared one)."""
    return {k: _fresh(v) if isinstance(v, dict) else v.clone() for k, v in params.items()}


def test_weight_audit_names_a_finite_flip_and_the_idle_sweep_contains_it(tiny_params):
    core = _tiny_core(_fresh(tiny_params), weight_audit_every=600.0)
    assert core.audit_weights() == [] and core.integrity_status() == "ok"
    injector = BitFlipInjector("weight", mode="flip", seed=8, after_range=(1, 2)).bind(core)
    _run(core, _jobs(2))
    assert injector.fired == 1
    assert core.audit_weights() == injector.corrupted
    assert core.kv_spot_check() == [] and core.integrity_status() == "suspect"
    stats = core.stats()
    assert (stats["weight_audits"], stats["integrity"]) == (2, "suspect")
    assert stats["last_audit_mismatch"] == injector.corrupted

    # The idle sweep of a running engine: the audit comes due, finds the
    # flip, and the numerical containment rebuilds with pristine weights.
    made = []

    def make():
        made.append(_tiny_core(_fresh(tiny_params), weight_audit_every=0.05))
        return made[-1]

    engine = tengine.AsyncEngine(make())
    engine.rebuild_core = make
    try:
        BitFlipInjector("weight", mode="flip", seed=8, after_range=(1, 1)).bind(
            engine.core)("decode_block")
        deadline = time.monotonic() + 30
        while engine.engine_rebuilds == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        engine.shutdown()
    assert engine.engine_rebuilds == 1 and engine.last_fault_reason == "numerical_fault"
    assert made[0].weight_audit_mismatches == 1 and engine.core.integrity_status() == "ok"


def test_canary_passes_clean_and_fails_after_a_flip(tiny_params):
    core = _tiny_core(_fresh(tiny_params), canary_every=600.0)
    assert len(core._canary_golden) == 8 and core.run_canary()
    injector = BitFlipInjector("logit", mode="nan", seed=9, after_range=(1, 1)).bind(core)
    assert not core.run_canary() and injector.fired == 1
    assert (core.canary_runs, core.canary_failures, core.integrity_status()) == (2, 1, "suspect")
    assert not core.has_work


def _heartbeat(engine) -> dict:
    """One heartbeat of a worker on ``engine``, as published (raw JSON)."""
    url = "memory://faults-beat"
    reset_namespace("faults-beat")
    worker = TorchWorker(QUEUE, engine, config=Config(broker_url=url))

    async def beat() -> dict:
        await worker.initialize()
        await worker._publish_heartbeat()
        msg = await worker.broker.broker.get(QUEUE + ".health")
        await worker.broker.disconnect()
        return json.loads(msg.body)

    try:
        return asyncio.run(beat())
    finally:
        engine.shutdown()


def test_heartbeat_carries_the_watchdog_and_integrity_only_when_on(monkeypatch):
    beat = _heartbeat(build_engine("preset://tiny", **ENGINE))
    assert "last_dispatch_ok_age_s" not in beat and "integrity" not in beat
    monkeypatch.setenv("LLMQ_WATCHDOG_MULT", "4")
    monkeypatch.setenv("LLMQ_LOGIT_GUARD", "on")
    engine = build_engine("preset://tiny", **ENGINE)
    engine.core.stop_watchdog()
    beat = _heartbeat(engine)
    assert isinstance(beat["last_dispatch_ok_age_s"], float) and beat["integrity"] == "ok"
    assert beat["engine_stats"]["watchdog_trips"] == 0


def test_failed_rebuild_quarantines_with_the_class_and_stops_the_worker():
    """The departure (ROADMAP.md queue 3): a CUDA error is sticky, so the
    rebuild fails too; the jobs settle with ``xla_runtime_error`` (here
    quarantined at their first attempt) and the worker stops."""
    engine = build_engine("preset://tiny", **ENGINE)

    def sticky(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    engine.core.on_dispatch = lambda kind: sticky()
    engine.core_factory = sticky
    jobs = _jobs(2)
    url = "memory://faults-sticky-cuda"
    reset_namespace("faults-sticky-cuda")
    asyncio.run(_submit([j.model_dump_json().encode() for j in jobs], url))
    worker = TorchWorker(QUEUE, engine, max_jobs=len(jobs), config=Config(
        broker_url=url, quarantine_attempts=1))
    try:
        with pytest.raises(RuntimeError, match="engine failed") as info:
            asyncio.run(worker.run())
    finally:
        engine.shutdown()
    assert "illegal memory access" in str(info.value.__cause__)
    quarantine = asyncio.run(_quarantined(url))
    assert quarantine, "no job reached the engine"
    assert {h["x-failure-reason"] for _, h in quarantine} == {"xla_runtime_error"}
    assert engine.engine_rebuilds == 0 and engine.last_fault_reason == "xla_runtime_error"
    left = [json.loads(b)["id"] for b in asyncio.run(_drain(QUEUE, url))]
    assert sorted(left + [mid for mid, _ in quarantine]) == [j.id for j in jobs]


def test_fault_plane_variables_pin_over_the_fields(monkeypatch, tiny_params):
    for name, value in (("LLMQ_WATCHDOG_MULT", "3"), ("LLMQ_WATCHDOG_MIN_S", "7"),
                        ("LLMQ_LOGIT_GUARD", "on"), ("LLMQ_GUARD_LOGIT_MAX", "50"),
                        ("LLMQ_GUARD_ENTROPY_MIN", "0.1"), ("LLMQ_WEIGHT_AUDIT_EVERY", "100"),
                        ("LLMQ_CANARY_EVERY", "200")):
        monkeypatch.setenv(name, value)
    core = _tiny_core(tiny_params)
    core.stop_watchdog()
    assert (core.watchdog.mult, core.watchdog.min_s, core.logit_guard, core.guard_logit_max,
            core.guard_entropy_min, core.weight_audit_every, core.canary_every) == (
        3.0, 7.0, "on", 50.0, 0.1, 100.0, 200.0)
    assert core._weight_baseline and len(core._canary_golden) == 8
    monkeypatch.setenv("LLMQ_LOGIT_GUARD", "maybe")  # not on|off: the field stands
    monkeypatch.setenv("LLMQ_WEIGHT_AUDIT_EVERY", "0")
    monkeypatch.setenv("LLMQ_CANARY_EVERY", "0")
    monkeypatch.setenv("LLMQ_WATCHDOG_MULT", "0")
    assert _tiny_core(tiny_params).logit_guard == "off"
    for name in ("LLMQ_WATCHDOG_MULT", "LLMQ_GUARD_ENTROPY_MIN", "LLMQ_CANARY_EVERY"):
        monkeypatch.setenv(name, "often")
        with pytest.raises(ValueError, match=f"^{name}='often' is not a number$"):
            _tiny_core(tiny_params)
        monkeypatch.setenv(name, "0")


def test_fault_events_survive_concurrent_records_and_pops(tiny_params):
    """The engine thread records fault events while the workers' event loop
    pops them: under a short switch interval, with more threads than
    cores, every recorded event is popped exactly once."""
    import sys
    import threading

    engine = tengine.AsyncEngine(_tiny_core(tiny_params))
    rids = [f"r{i}" for i in range(8)]
    popped, n_writers, per_writer = [], 6, 300
    done = threading.Event()

    def write(w: int) -> None:
        for k in range(per_writer):
            engine._record_fault_event([rids[(w + k) % len(rids)]], "device_fault", n=k)

    def pop() -> None:
        while not done.is_set():
            for rid in rids:
                popped.extend(engine.pop_fault_events(rid))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writers = [threading.Thread(target=write, args=(w,)) for w in range(n_writers)]
        poppers = [threading.Thread(target=pop) for _ in range(3)]
        for t in writers + poppers:
            t.start()
        for t in writers:
            t.join(30)
        done.set()
        for t in poppers:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
        engine.shutdown()
    assert not any(t.is_alive() for t in writers + poppers)
    for rid in rids:
        popped.extend(engine.pop_fault_events(rid))
    assert len(popped) == n_writers * per_writer
