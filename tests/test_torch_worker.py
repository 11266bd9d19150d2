"""The port's worker over ``memory://``: jobs in, results out.

Drives ``run_torch_worker`` on the CPU with the tiny preset and checks
ids, ``usage.completion_tokens``, extra-field passthrough, and that each
result's text equals ``generate_sync`` of an engine with the same seeded
weights. The worker's resolved ``EngineConfig`` is held against the JAX
worker's (``llmq_tpu/workers/tpu_worker.py::_build_core``) for the same
arguments and environment.
"""

import asyncio
import json

import pytest
import torch

from llmq_tpu_torch.broker.base import make_broker
from llmq_tpu_torch.broker.memory import reset_namespace
from llmq_tpu_torch.cli.worker import build_engine, engine_config, run_torch_worker
from llmq_tpu_torch.core.config import Config, get_config
from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.engine.sampling import SamplingParams
from llmq_tpu_torch.models.presets import get_preset
from llmq_tpu_torch.workers.torch_worker import TorchWorker, worker_role

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
    """A device fault the engine cannot contain stops the worker: a kernel
    launch error whose in-process rebuild fails too (a CUDA error is
    sticky: every later call in the process fails). ``run`` raises with
    the engine's exception as the cause, every job goes back to the queue
    once with the fault's class as its failure reason, and nothing is
    published or dead-lettered. (A fault the rebuild contains does not
    stop it: ``tests/test_torch_faults.py``.)"""
    url = "memory://torch-worker-fail"
    reset_namespace(url.split("://")[1])
    jobs = [Job(id=f"f{i}", prompt=f"job {i}", temperature=0.0, max_tokens=4) for i in range(3)]
    asyncio.run(_submit([j.model_dump_json().encode() for j in jobs], url))
    engine = build_engine("preset://tiny", **ENGINE)

    def failing_step(*args, **kwargs):
        raise RuntimeError("paged_decode kernel launch failed: CUDA error 700")

    engine.core.step = failing_step
    engine.core_factory = failing_step  # the rebuild meets the same sticky error
    worker = TorchWorker(QUEUE, engine, broker_url=url, max_jobs=len(jobs))
    try:
        with pytest.raises(RuntimeError, match="engine failed") as info:
            asyncio.run(worker.run())
    finally:
        engine.shutdown()
    assert "CUDA error 700" in str(info.value.__cause__)
    assert worker.jobs_processed == 0 and engine.engine_rebuilds == 0
    assert {worker._failure_reasons.get(j.id) for j in jobs} == {"xla_runtime_error"}
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
    assert (resolve_pool_dtype(dtype) == "bfloat16"
            and resolve_pool_dtype(dtype, "fp8") == "float8_e5m2")
    monkeypatch.setenv("LLMQ_KV_DTYPE", "f32")
    assert resolve_pool_dtype(dtype) == "float32"
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


# Every variable either worker's engine config reads (core/config.py), and
# the worker's role.
ENGINE_VARS = (
    "LLMQ_MAX_NUM_SEQS", "VLLM_MAX_NUM_SEQS", "LLMQ_MAX_MODEL_LEN", "VLLM_MAX_MODEL_LEN",
    "LLMQ_PREFILL_CHUNK", "LLMQ_PREFIX_CACHING", "LLMQ_KV_DTYPE", "VLLM_KV_CACHE_DTYPE",
    "TPU_HBM_UTILIZATION", "VLLM_GPU_MEMORY_UTILIZATION", "LLMQ_DECODE_BLOCK",
    "LLMQ_SPEC_TOKENS", "LLMQ_TP_OVERLAP", "LLMQ_MIXED_STEP", "LLMQ_PREFIX_HOST_GB",
    "LLMQ_PREEMPT_MODE", "LLMQ_PRIORITY_CLASSES", "LLMQ_PRIORITY_PREEMPT",
    "LLMQ_INTERACTIVE_DECODE_BLOCK", "LLMQ_HOST_MEM_GB", "LLMQ_DRAIN_TIMEOUT_S",
    "LLMQ_WORKER_ROLE",
)
COMPARED = ("max_model_len", "max_num_seqs", "kv_dtype", "prefill_chunk_size",
            "enable_prefix_caching", "hbm_utilization", "decode_block", "spec_tokens",
            "mixed_step", "interactive_decode_block")


def _jax_worker_engine_config(monkeypatch, model: str, **flags):
    """The ``EngineConfig`` the JAX worker's ``_build_core`` hands its
    engine, captured without building the engine or its weights."""
    import llmq_tpu.engine.engine as jax_engine
    import llmq_tpu.models.transformer as jax_transformer
    from llmq_tpu.workers.tpu_worker import TPUWorker

    captured = {}

    def capture(model_config, params, tokenizer, **kw):
        captured["cfg"] = kw["engine_config"]

    monkeypatch.setattr(jax_engine, "EngineCore", capture)
    monkeypatch.setattr(jax_transformer, "init_params", lambda *a, **k: None)
    TPUWorker("config-parity", model=model, tensor_parallel=1, **flags)._build_core()
    return captured["cfg"]


def _fields(cfg) -> dict:
    import numpy as np

    out = {name: getattr(cfg, name) for name in COMPARED}
    kv = out["kv_dtype"]
    out["kv_dtype"] = (str(kv).replace("torch.", "") if isinstance(kv, torch.dtype)
                       else np.dtype(kv).name)
    return out


@pytest.mark.parametrize("env,flags", [
    ({}, {}),  # ROADMAP queue 3 item 3: 8,192, clamped to the model
    ({}, {"dtype": "float32"}),
    ({"LLMQ_MAX_NUM_SEQS": "8"}, {}),
    ({"VLLM_MAX_NUM_SEQS": "12"}, {}),
    ({"LLMQ_MAX_MODEL_LEN": "1000"}, {}),
    ({"VLLM_MAX_MODEL_LEN": "200000"}, {}),  # past max_position_embeddings: clamped
    ({"LLMQ_PREFILL_CHUNK": "64"}, {}),
    ({"LLMQ_PREFIX_CACHING": "1"}, {"prefill_chunk_size": 32}),  # needs a chunk in both
    ({"LLMQ_KV_DTYPE": "fp8"}, {}),
    ({"VLLM_KV_CACHE_DTYPE": "fp8_e5m2"}, {}),  # queue 3 item 4
    ({"TPU_HBM_UTILIZATION": "0.5"}, {}),
    ({"VLLM_GPU_MEMORY_UTILIZATION": "0.7"}, {}),
    ({"LLMQ_MAX_MODEL_LEN": "1000"}, {"max_model_len": 300}),  # a flag over a variable
    ({"VLLM_MAX_NUM_SEQS": "12", "LLMQ_MAX_NUM_SEQS": "6"}, {"max_num_seqs": 3}),
    ({"VLLM_KV_CACHE_DTYPE": "fp8"}, {"kv_dtype": "bf16"}),
    ({"LLMQ_PREFILL_CHUNK": "64"}, {"prefill_chunk_size": 32}),
    ({}, {"max_model_len": 1_000_000}),  # a flag is clamped too
])
def test_worker_engine_config_matches_the_jax_worker(monkeypatch, env, flags):
    """Both workers resolve the same EngineConfig fields from the same
    arguments and environment (ROADMAP.md queue 3 items 3 and 4)."""
    for var in ENGINE_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    model = "preset://qwen2.5-0.5b"  # max_position_embeddings 32,768
    want = _fields(_jax_worker_engine_config(monkeypatch, model, **flags))
    got = _fields(engine_config(get_preset(model.split("://")[1]), **flags))
    assert got == want


def _start_worker_engine():
    """What ``run_torch_worker`` does before it serves: check the role, then
    build the engine (which refuses the settings of unported features)."""
    worker_role(get_config())
    return build_engine("preset://tiny", **ENGINE)


#: an unported feature's variable -> its "off" (default) value
UNPORTED_OFF = {"LLMQ_TP_OVERLAP": "off", "LLMQ_WORKER_ROLE": "unified",
                "LLMQ_PREFIX_AFFINITY": "0", "LLMQ_ROLE_DWELL_S": "60",
                "LLMQ_ROLE_SWITCH_HI": "2.0", "LLMQ_ROLE_SWITCH_LO": "0.5",
                "LLMQ_ROLE_CHECK_INTERVAL_S": "5", "LLMQ_HANDOFF_TIMEOUT_S": "2",
                "LLMQ_PEER_SERVE_CONCURRENCY": "2", "LLMQ_SERVE_PORT": "8100"}


#: the variables once refused here (M6's second part, M16's serve port) -> their Config field
PORTED_M6 = {"LLMQ_WORKER_ROLE": "worker_role", "LLMQ_PREFIX_AFFINITY": "prefix_affinity",
             "LLMQ_ROLE_DWELL_S": "role_dwell_s", "LLMQ_ROLE_SWITCH_HI": "role_switch_hi",
             "LLMQ_ROLE_SWITCH_LO": "role_switch_lo",
             "LLMQ_ROLE_CHECK_INTERVAL_S": "role_check_interval_s",
             "LLMQ_HANDOFF_TIMEOUT_S": "handoff_timeout_s",
             "LLMQ_PEER_SERVE_CONCURRENCY": "peer_serve_concurrency",
             # M16's: read for the gateway (``serve``), which no worker runs
             "LLMQ_SERVE_PORT": "serve_port"}


@pytest.mark.parametrize("var,value,item", [
    ("LLMQ_TP_OVERLAP", "on", "M13"),
    ("LLMQ_WORKER_ROLE", "auto", "M6"),
    ("LLMQ_PREFIX_AFFINITY", "1", "M6"),
    ("LLMQ_ROLE_DWELL_S", "10", "M6"),
    ("LLMQ_ROLE_SWITCH_HI", "3", "M6"),
    ("LLMQ_ROLE_SWITCH_LO", "0.2", "M6"),
    ("LLMQ_ROLE_CHECK_INTERVAL_S", "1", "M6"),
    ("LLMQ_HANDOFF_TIMEOUT_S", "5", "M6"),
    ("LLMQ_PEER_SERVE_CONCURRENCY", "4", "M6"),
    ("LLMQ_SERVE_PORT", "9000", "M16"),
])
def test_worker_refuses_unported_env_features(monkeypatch, var, value, item):
    """A variable that turns on a feature the port lacks is refused with
    its ROADMAP.md item, never ignored; set to its "off" value it is not.
    (``LLMQ_PREFIX_HOST_GB``, once refused here, is ported: M11b. The M6
    variables, once refused here, are ported with M6's second part, and
    ``LLMQ_SERVE_PORT`` with M16's gateway: the worker starts with each set,
    read as the reference's ``Config`` reads it.)"""
    for name in ENGINE_VARS + tuple(UNPORTED_OFF):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(var, value)
    if item in ("M6", "M16"):
        from llmq_tpu.core.config import Config as JConfig

        field = PORTED_M6[var]
        assert getattr(get_config(), field) == getattr(JConfig(), field)
        _start_worker_engine().shutdown()
    else:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
            _start_worker_engine()
    monkeypatch.setenv(var, UNPORTED_OFF[var])
    _start_worker_engine().shutdown()


@pytest.mark.parametrize("var,value", [("LLMQ_CHUNK_SIZE", "50")])
def test_worker_ignores_client_only_variables(monkeypatch, var, value):
    """A variable that only the client reads (submit's chunk size) changes
    nothing a worker does in either package, so a worker sharing the
    client's ``.env`` starts as the reference's does."""
    for name in ENGINE_VARS + tuple(UNPORTED_OFF):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(var, value)
    _start_worker_engine().shutdown()


@pytest.mark.parametrize("env,flags", [
    ({"LLMQ_DECODE_BLOCK": "4"}, {}),
    ({"LLMQ_SPEC_TOKENS": "2"}, {"decode_block": 2}),
    ({"LLMQ_MIXED_STEP": "on", "LLMQ_PREFILL_CHUNK": "32"}, {}),
])
def test_worker_resolves_fused_modes_as_the_jax_worker(monkeypatch, env, flags):
    """The fused dispatch modes (M10, once refused here) turned on by their
    variables, and a flag over a variable, resolve to the JAX worker's
    EngineConfig (interactive_decode_block stays 0 in both: no variable of
    the worker sets it), and the engine builds and reports them."""
    for name in ENGINE_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    model = "preset://qwen2.5-0.5b"
    want = _fields(_jax_worker_engine_config(monkeypatch, model, **flags))
    assert _fields(engine_config(get_preset(model.split("://")[1]), **flags)) == want
    engine = build_engine("preset://tiny", **ENGINE, **flags)
    try:
        st = engine.core.stats()
        for name in ("decode_block", "spec_tokens", "mixed_step"):
            assert st[name] == want[name], name
        assert engine.core.interactive_decode_block == 0
    finally:
        engine.shutdown()


@pytest.mark.parametrize("env", [
    {"LLMQ_PREEMPT_MODE": "swap"},
    {"LLMQ_PRIORITY_CLASSES": "0", "LLMQ_DECODE_BLOCK": "4", "LLMQ_INTERACTIVE_DECODE_BLOCK": "2"},
    {"LLMQ_PRIORITY_PREEMPT": "off"},
    {"LLMQ_DECODE_BLOCK": "4", "LLMQ_INTERACTIVE_DECODE_BLOCK": "2"},
    {"LLMQ_HOST_MEM_GB": "1.5", "LLMQ_DRAIN_TIMEOUT_S": "5"},
    {"LLMQ_WORKER_ROLE": "prefill"},
    {"LLMQ_WORKER_ROLE": "DECODE", "LLMQ_PRIORITY_CLASSES": "no"},
    {"LLMQ_PREFIX_HOST_GB": "0.25", "LLMQ_PREFIX_CACHING": "1", "LLMQ_PREFILL_CHUNK": "32"},
])
def test_worker_resolves_the_request_state_variables_as_the_jax_worker(monkeypatch, env):
    """The request-state plane's variables (M11) resolve as in the JAX
    worker: the engine's swap mode, priority classes, priority preemption
    and small interactive block (each variable over its field, JAX
    ``engine.py`` :737-774, resolved by an engine built on the worker's
    ``EngineConfig``), the host-memory budget and the drain timeout; and
    those of the prefix-KV plane (M11b): the worker's role and fast lane
    (``Config.worker_role`` / ``priority_classes``) and the engine's host
    prefix tier (``LLMQ_PREFIX_HOST_GB``, JAX ``engine.py`` :775-811)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import llmq_tpu.engine.engine as jax_engine
    import llmq_tpu.utils.host_mem as jax_host_mem
    from llmq_tpu.core.config import Config as JaxConfig
    from llmq_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
    from llmq_tpu.models.config import ModelConfig as JaxModelConfig
    from llmq_tpu.parallel import make_mesh
    from llmq_tpu_torch.utils import host_mem

    from test_torch_model import numpy_params

    for name in ENGINE_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    real_core = jax_engine.EngineCore
    model = "preset://qwen2.5-0.5b"
    want_cfg = _jax_worker_engine_config(monkeypatch, model)
    assert _fields(engine_config(get_preset(model.split("://")[1]))) == _fields(want_cfg)
    small = dict(max_num_seqs=4, max_model_len=64, num_pages=16, kv_dtype=jnp.float32)
    jcfg = JaxModelConfig.tiny()
    jcore = real_core(jcfg, jax.tree.map(jnp.asarray, numpy_params(jcfg, 0)), JaxByteTokenizer(),
                      mesh=make_mesh(tensor_parallel=1),
                      engine_config=dataclasses.replace(want_cfg, **small))
    engine = build_engine("preset://tiny", **ENGINE)
    resolved = ("preempt_mode", "priority_classes", "priority_preempt",
                "interactive_decode_block", "prefix_host_gb")
    try:
        assert {k: getattr(engine.core, k) for k in resolved} == \
            {k: getattr(jcore, k) for k in resolved}
        budgets = [None if c.prefix_store is None else c.prefix_store.budget_bytes
                   for c in (engine.core, jcore)]
        assert budgets[0] == budgets[1]
        worker = TorchWorker("q", engine, broker_url="memory://resolve")
        assert worker.drain_timeout_s == JaxConfig().drain_timeout_s
        jax_cfg = JaxConfig()
        assert (worker.role, worker.priority_classes) == \
            (jax_cfg.worker_role, jax_cfg.priority_classes)
        assert (Config().worker_role, Config().priority_classes) == \
            (jax_cfg.worker_role, jax_cfg.priority_classes)
        host_mem.set_governor(None)
        jax_host_mem.set_governor(None)
        assert host_mem.get_governor().budget_bytes == \
            jax_host_mem.get_governor().budget_bytes
    finally:
        engine.shutdown()
        host_mem.set_governor(None)
        jax_host_mem.set_governor(None)
