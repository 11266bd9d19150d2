"""The port's request-state plane against the JAX package's (M11).

Codec: for f32, bf16 and e5m2 KV the port's ``RequestSnapshot.to_bytes``
equals ``llmq_tpu.engine.snapshot``'s byte for byte and each side decodes
the other's; damaged blobs raise the port's errors; ``repack_pages`` and
``pages_for`` equal JAX's; and without ``ml_dtypes`` the port still
round-trips bf16 and e5m2 snapshots (it carries KV pages as raw bits).

Engines: one JAX ``EngineCore`` (f32, tiny, a pool tight enough to
preempt, ``preempt_mode="swap"``; compiled once for the module) and port
engines over the same numpy-made weights. A snapshot the JAX engine
extracts mid-decode continues on the port with the uninterrupted run's
greedy tokens, and the reverse, also across page sizes; swap preemption,
interactive (priority) preemption and deadlines give the JAX engine's
tokens and counters. ``admit_max_wait_s`` is set out of reach so
admission does not depend on the clock, and the counters are comparable.
``AsyncEngine.handoff`` / ``resume`` and the token callbacks, and the
worker's drain-with-handoff over ``memory://`` (held against a kill-free
``TPUWorker`` run on the same JAX engine) complete the plane.
"""

import asyncio
import base64
import dataclasses
import json
import subprocess
import sys
import time
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llmq_tpu.engine import engine as jengine
from llmq_tpu.engine import snapshot as jsnap
from llmq_tpu.engine.sampling import SamplingParams as JParams
from llmq_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.parallel import make_mesh
from llmq_tpu_torch.broker.base import make_broker
from llmq_tpu_torch.core.models import Job
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine import snapshot as tsnap
from llmq_tpu_torch.engine.sampling import SamplingParams as TParams
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.workers.resume import RESUME_FIELD
from llmq_tpu_torch.workers.torch_worker import TorchWorker

from test_torch_model import numpy_params

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]

# --- the codec ---------------------------------------------------------------------

#: stored dtype name -> (torch dtype, ml_dtypes / numpy dtype JAX holds it in)
KV = {"float32": (torch.float32, np.float32), "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
      "float8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2)}
SIG = dict(num_layers=2, num_kv_heads=2, head_dim=16)


def _raw_pages(name: str, seed: int = 0) -> np.ndarray:
    """[L, n, page, H, D] pages of ``name`` as the port carries them (raw bits)."""
    f = np.random.default_rng(seed).standard_normal((2, 3, 8, 2, 16)).astype(np.float32)
    t = torch.from_numpy(f).to(KV[name][0])
    if name == "float32":
        return t.numpy()
    raw = t.view(torch.int16 if name == "bfloat16" else torch.uint8).numpy()
    return raw.view(np.uint16) if name == "bfloat16" else raw


def _snapshots(name: str):
    """The same request state as a port and a JAX snapshot."""
    k, v = _raw_pages(name, 0), _raw_pages(name, 1)
    common = dict(rid="req-7", page_size=8, prompt_ids=[5, 6, 7, 8], output_ids=[9, 10],
                  key_data=np.array([0, 12345], np.uint32), epoch=2, preempt_count=1,
                  detok_len=1, detok_text="é", kv_valid=20)
    kw = dict(temperature=0.7, top_k=3, stop=("\n",), stop_token_ids=(4,), seed=11,
              max_tokens=40)
    port = tsnap.RequestSnapshot(model_sig={**SIG, "kv_dtype": name}, params=TParams(**kw),
                                 kv_k=k, kv_v=v, kv_dtype=name, **common)
    as_jax = (lambda a: a) if name == "float32" else (lambda a: a.view(KV[name][1]))
    ref = jsnap.RequestSnapshot(model_sig={**SIG, "kv_dtype": name}, params=JParams(**kw),
                                kv_k=as_jax(k), kv_v=as_jax(v), **common)
    return port, ref


@pytest.mark.parametrize("name", list(KV))
def test_snapshot_bytes_equal_the_jax_codec_and_cross_decode(name):
    port, ref = _snapshots(name)
    blob = port.to_bytes()
    assert blob == ref.to_bytes()
    back = tsnap.RequestSnapshot.from_bytes(ref.to_bytes())
    assert back.kv_dtype == name and back.kv_k.dtype == port.kv_k.dtype
    assert np.array_equal(back.kv_k, port.kv_k) and np.array_equal(back.kv_v, port.kv_v)
    assert back.to_bytes() == blob  # the round trip is the identity
    theirs = jsnap.RequestSnapshot.from_bytes(blob)
    assert theirs.kv_k.dtype == np.dtype(KV[name][1])
    assert np.array_equal(theirs.kv_k.view(port.kv_k.dtype), port.kv_k)
    assert theirs.params == ref.params and theirs.output_ids == [9, 10]
    # The wire forms: b64 and the binary frame, each sniffed by either side.
    assert jsnap.snapshot_from_b64(tsnap.snapshot_to_b64(port)).to_bytes() == blob
    frame = tsnap.WIRE_MAGIC + tsnap._LEN_STRUCT.pack(len(blob)) + blob
    assert tsnap.snapshot_from_wire(frame).to_bytes() == blob
    assert jsnap.snapshot_from_wire(frame).to_bytes() == blob


def test_damaged_snapshots_raise_the_ports_errors():
    blob = _snapshots("bfloat16")[0].to_bytes()
    bad = bytearray(blob)
    bad[-5] ^= 0xFF
    with pytest.raises(tsnap.SnapshotIntegrityError):
        tsnap.RequestSnapshot.from_bytes(bytes(bad))
    with pytest.raises(tsnap.SnapshotIntegrityError):
        tsnap.RequestSnapshot.from_bytes(blob[: len(blob) // 2])
    with pytest.raises(tsnap.SnapshotIntegrityError):
        tsnap.RequestSnapshot.from_bytes(blob[:10])
    with pytest.raises(tsnap.SnapshotError, match="magic"):
        tsnap.RequestSnapshot.from_bytes(b"NOTASNAP" + blob[8:])
    future = bytearray(blob)
    future[len(tsnap.MAGIC)] = 0xFF  # version u16 LE, low byte
    with pytest.raises(tsnap.SnapshotVersionError):
        tsnap.RequestSnapshot.from_bytes(bytes(future))
    with pytest.raises(tsnap.SnapshotError):
        tsnap.snapshot_from_b64("!!not base64!!")
    # the binary wire frame: a short length field or body is caught
    frame = tsnap.WIRE_MAGIC + tsnap._LEN_STRUCT.pack(len(blob)) + blob
    for cut in (frame[: len(tsnap.WIRE_MAGIC) + 2], frame[:-1]):
        with pytest.raises(tsnap.SnapshotIntegrityError, match="wire frame"):
            tsnap.snapshot_from_wire(cut)


def test_repack_pages_and_pages_for_equal_the_jax_functions():
    kv = _raw_pages("bfloat16")  # [2, 3, 8, 2, 16]
    for valid, page, n in ((20, 4, 5), (17, 16, 2), (24, 8, 3), (1, 32, 1)):
        assert np.array_equal(tsnap.repack_pages(kv, valid, page, n),
                              jsnap.repack_pages(kv, valid, page, n))
    for valid, page in ((0, 8), (1, 8), (8, 8), (9, 8), (100, 32)):
        assert tsnap.pages_for(valid, page) == jsnap.pages_for(valid, page)
    with pytest.raises(tsnap.SnapshotCompatError):
        tsnap.repack_pages(kv, 20, 4, 4)


def test_port_codec_needs_no_ml_dtypes():
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch\n"
        "from llmq_tpu_torch.engine import snapshot as s\n"
        "from llmq_tpu_torch.engine.sampling import SamplingParams\n"
        "for name, t, raw in (('bfloat16', torch.bfloat16, torch.int16),\n"
        "                     ('float8_e5m2', torch.float8_e5m2, torch.uint8)):\n"
        "    pool = torch.randn(2, 5, 4, 2, 8).to(t)\n"
        "    kv = s.pages_to_host(pool, torch.tensor([3, 1]))\n"
        "    snap = s.RequestSnapshot(rid='r', model_sig={'kv_dtype': name}, page_size=4,\n"
        "        prompt_ids=[1, 2], output_ids=[3], params=SamplingParams(),\n"
        "        key_data=np.zeros(2, np.uint32), epoch=0, preempt_count=0, detok_len=0,\n"
        "        detok_text='', kv_valid=7, kv_k=kv, kv_v=kv, kv_dtype=name)\n"
        "    back = s.RequestSnapshot.from_bytes(snap.to_bytes())\n"
        "    out = torch.zeros_like(pool)\n"
        "    s.pages_from_host(out, torch.tensor([3, 1]), back.kv_k)\n"
        "    assert back.kv_dtype == name\n"
        "    assert torch.equal(out.view(raw)[:, [3, 1]], pool.view(raw)[:, [3, 1]])\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stdout + proc.stderr


# --- engines: the port against the JAX engine --------------------------------------

JCFG = JConfig.tiny(vocab_size=304)
TCFG = TConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
TREE = numpy_params(JCFG, 0)
# 3 slots over 10 usable pages of 8: three ~30-token requests must preempt.
TIGHT = dict(max_num_seqs=3, max_model_len=96, page_size=8, num_pages=11, kv_dtype="f32",
             min_prefill_bucket=32, admit_max_wait_s=1e9)
PROMPT = "the quick brown snapshot"


@pytest.fixture(scope="module")
def jcore():
    return jengine.EngineCore(
        JCFG, jax.tree.map(jnp.asarray, TREE), JByteTokenizer(),
        mesh=make_mesh(tensor_parallel=1),
        engine_config=jengine.EngineConfig(**{**TIGHT, "preempt_mode": "swap"}),
    )


def _tcore(**overrides):
    return tengine.EngineCore(TCFG, params_from_numpy(TREE), ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(**{**TIGHT, **overrides}))


def _greedy(cls, n, **kw):
    return cls(**{"temperature": 0.0, "max_tokens": n, "ignore_eos": True, **kw})


def _run(core, requests=(), cls=TParams):
    for rid, prompt, n in requests:
        core.add_request(rid, prompt=prompt, params=_greedy(cls, n))
    outs = {}
    for _ in range(2000):
        for out in core.step():
            outs[out.rid] = out
        if not core.has_work:
            break
    assert not core.has_work, "engine stalled"
    return outs


def _step_until(core, rid, n_tokens):
    for _ in range(500):
        seq = core.scheduler.running.get(rid)
        if seq is not None and len(seq.output_ids) >= n_tokens:
            return
        core.step()
    raise AssertionError(f"{rid} never reached {n_tokens} tokens")


def _counters(core):
    return {k: getattr(core, k) for k in ("swap_preempts", "kv_restores", "priority_preemptions",
                                          "deadline_expirations")}


@pytest.fixture(scope="module")
def baseline(jcore):
    """The uninterrupted JAX run of PROMPT, 24 greedy tokens."""
    return _run(jcore, [("base", PROMPT, 24)], JParams)["base"]


def test_jax_snapshot_continues_on_the_port(jcore, baseline):
    """The JAX engine extracts mid-decode; the port inserts the wire bytes
    and continues greedy-identically, at the same page size and at half
    of it (``repack_pages``)."""
    jcore.add_request("x0", prompt=PROMPT, params=_greedy(JParams, 24))
    _step_until(jcore, "x0", 6)
    blob = jcore.extract_request("x0").to_bytes()
    for page, pages in ((8, 11), (4, 22)):
        t = _tcore(page_size=page, num_pages=pages)
        t.insert_request(tsnap.RequestSnapshot.from_bytes(blob))
        out = _run(t)["x0"]
        assert out.token_ids == baseline.token_ids, page
        assert out.text == baseline.text and out.finish_reason == baseline.finish_reason
        assert t.kv_restores == 1 and t.snapshots_inserted == 1
        assert t.prefill_tokens == 0  # restored, not prefilled


def test_port_snapshot_continues_on_the_jax_engine(jcore, baseline):
    """The reverse: the port extracts (at page 8 and at page 4), the JAX
    engine inserts and continues greedy-identically."""
    for page, pages in ((8, 11), (4, 22)):
        t = _tcore(page_size=page, num_pages=pages)
        t.add_request("y0", prompt=PROMPT, params=_greedy(TParams, 24))
        _step_until(t, "y0", 7)
        snap = t.extract_request("y0")
        assert t.snapshots_extracted == 1 and "y0" not in t.scheduler.running
        assert snap.kv_valid == len(snap.prompt_ids) + len(snap.output_ids) - 1
        restores = jcore.kv_restores
        jcore.insert_request(jsnap.RequestSnapshot.from_bytes(snap.to_bytes()))
        out = _run(jcore, cls=JParams)["y0"]
        assert out.token_ids == baseline.token_ids, page
        assert jcore.kv_restores == restores + 1


def test_insert_refuses_what_the_jax_engine_refuses(jcore):
    t = _tcore()
    t.add_request("z0", prompt=PROMPT, params=_greedy(TParams, 12))
    _step_until(t, "z0", 3)
    snap = t.extract_request("z0")
    with pytest.raises(tsnap.SnapshotCompatError):  # another KV dtype
        _tcore(kv_dtype="bf16").insert_request(snap)
    bad = dataclasses.replace(snap, key_data=snap.key_data ^ np.uint32(1))
    with pytest.raises(tsnap.SnapshotCompatError):
        _tcore().insert_request(bad)
    with pytest.raises(jsnap.SnapshotCompatError):
        jcore.insert_request(jsnap.RequestSnapshot.from_bytes(bad.to_bytes()))
    dst = _tcore()
    dst.insert_request(snap)
    with pytest.raises(ValueError, match="already in flight"):
        dst.insert_request(snap)


SWAP_REQS = [(f"s{i}", "hello request %d " % i + "ab" * (4 * i), 30) for i in range(3)]


def test_swap_preemption_matches_the_jax_engine(jcore):
    """On the tight pool swap preemption gives the JAX engine's tokens and
    counters, and recompute's tokens with fewer prefill tokens."""
    before = _counters(jcore)
    jout = _run(jcore, SWAP_REQS, JParams)
    jdelta = {k: v - before[k] for k, v in _counters(jcore).items()}
    swap = _tcore(preempt_mode="swap")
    sout = _run(swap, SWAP_REQS)
    rec = _tcore()
    rout = _run(rec, SWAP_REQS)
    for rid, _, _ in SWAP_REQS:
        assert sout[rid].token_ids == jout[rid].token_ids == rout[rid].token_ids, rid
    assert rec.scheduler.preemptions > 0 and rec.kv_restores == 0
    assert swap.swap_preempts > 0 and swap.kv_restores > 0
    assert (swap.swap_preempts, swap.kv_restores) == (jdelta["swap_preempts"],
                                                      jdelta["kv_restores"])
    assert swap.prefill_tokens < rec.prefill_tokens
    st = swap.stats()
    assert st["preempt_mode"] == "swap" and st["swap_preempts"] == swap.swap_preempts


def _co_scheduled(core, cls, priority):
    """4 short batch requests on 3 slots (the pool holds them all), one
    interactive request after 3 steps, when every slot is taken (the
    port's twin of ``tests/test_priority.py::TestEnginePriority``)."""
    for i in range(4):
        core.add_request(f"b{i}", prompt=f"b{i}", params=_greedy(cls, 8))
    outs, steps, added = {}, 0, False
    while core.has_work or not added:
        if steps == 3:
            core.add_request("i0", prompt="i0", params=_greedy(cls, 6), priority=priority)
            added = True
        for out in core.step():
            outs[out.rid] = out
        steps += 1
        assert steps < 2000
    return outs


def test_interactive_preemption_keeps_greedy_tokens_as_jax(jcore):
    before = _counters(jcore)
    jout = _co_scheduled(jcore, JParams, "interactive")
    jdelta = {k: v - before[k] for k, v in _counters(jcore).items()}
    golden = _co_scheduled(_tcore(preempt_mode="swap"), TParams, "batch")
    t = _tcore(preempt_mode="swap")
    tout = _co_scheduled(t, TParams, "interactive")
    assert set(tout) == set(jout) == set(golden)
    for rid in golden:
        assert tout[rid].token_ids == jout[rid].token_ids == golden[rid].token_ids, rid
    assert t.priority_preemptions == jdelta["priority_preemptions"] == 1
    assert t.swap_preempts == jdelta["swap_preempts"]
    st = t.stats()
    assert st["priority_preemptions"] == 1 and st["finished_interactive"] == 1
    assert st["finished_batch"] == 4 and st["tokens_interactive"] == 6
    # With the classes off the class is ignored: FIFO, no preemption, no keys.
    off = _tcore(priority_classes=False)
    assert {r: o.token_ids for r, o in _co_scheduled(off, TParams, "interactive").items()} == \
        {r: o.token_ids for r, o in golden.items()}
    assert off.priority_preemptions == 0 and "priority_preemptions" not in off.stats()
    with pytest.raises(ValueError, match="priority"):
        t.add_request("bad", prompt="x", priority="urgent")


def test_interactive_decode_block_dispatches_the_small_block():
    """With an interactive row resident the engine dispatches K = 1
    blocks, else K = 4; tokens equal decode_block 1's."""
    ks = []
    core = _tcore(max_num_seqs=4, num_pages=40, decode_block=4, interactive_decode_block=1)
    block = core._dispatch_block

    def spy(kind, seg=None, mode=None, K=None):
        ks.append(K)
        return block(kind, seg, mode, K)

    core._dispatch_block = spy
    got = _co_scheduled(core, TParams, "interactive")
    want = _co_scheduled(_tcore(max_num_seqs=4, num_pages=40), TParams, "batch")
    assert {r: o.token_ids for r, o in got.items()} == {r: o.token_ids for r, o in want.items()}
    assert 1 in ks and 4 in ks
    assert core.stats()["interactive_decode_block"] == 1


def test_deadlines_expire_waiting_and_running_rows_as_jax(jcore):
    outs = {}
    for core, cls in ((jcore, JParams), (_tcore(), TParams)):
        before = core.deadline_expirations
        core.add_request("late", prompt="past", params=_greedy(cls, 8),
                         deadline_at=time.time() - 1)
        core.add_request("run", prompt=PROMPT, params=_greedy(cls, 30),
                         deadline_at=time.time() + 3600)
        got = {}
        for _ in range(500):
            seq = core.scheduler.running.get("run")
            if seq is not None and len(seq.output_ids) >= 4:
                seq.deadline_at = time.time() - 1  # it lapses mid-decode
            got.update({o.rid: o for o in core.step()})
            if not core.has_work:
                break
        assert core.deadline_expirations - before == 2
        outs[cls] = {rid: (o.finish_reason, o.completion_tokens) for rid, o in got.items()}
    assert outs[TParams] == outs[JParams]
    assert outs[TParams]["late"] == ("deadline_exceeded", 0)
    assert outs[TParams]["run"][0] == "deadline_exceeded" and outs[TParams]["run"][1] >= 4


# --- AsyncEngine --------------------------------------------------------------------


def _hold_until_handoff(engine, deadline_s: float = 30.0) -> None:
    """Pause the engine thread (inside a token callback) until a handoff
    is requested, so the request is surely mid-decode when it lands."""
    deadline = time.monotonic() + deadline_s
    while not engine._handoff_requested and time.monotonic() < deadline:
        time.sleep(0.001)


def test_async_handoff_resumes_on_a_second_engine_with_token_callbacks(baseline):
    async def main():
        eng1 = tengine.AsyncEngine(_tcore())
        try:
            seen1 = []

            def on_token(tok, n):
                seen1.append((tok, n))
                if n == 3:
                    _hold_until_handoff(eng1)

            eng1.set_token_callback("h0", on_token)
            task = asyncio.ensure_future(
                eng1.generate(rid="h0", prompt=PROMPT, params=_greedy(TParams, 24)))
            for _ in range(30000):
                if len(seen1) >= 3:
                    break
                await asyncio.sleep(0.001)
            handoffs = await asyncio.get_running_loop().run_in_executor(None, eng1.handoff)
            out = await task
            with pytest.raises(RuntimeError, match="draining"):
                await eng1.generate(rid="late", prompt="x")
        finally:
            eng1.shutdown()
        assert isinstance(out, tengine.HandoffOutput) and [h.rid for h in handoffs] == ["h0"]
        assert out.snapshot is not None and out.emitted == len(out.snapshot.output_ids) < 24
        eng2 = tengine.AsyncEngine(_tcore())
        try:
            seen2 = []
            eng2.set_token_callback("h0", lambda tok, n: seen2.append((tok, n)))
            resumed = await eng2.resume(rid="h0", snapshot=out.snapshot)
            assert eng2.call_on_engine(lambda: eng2.core.kv_restores) == 1
        finally:
            eng2.shutdown()
        return out, resumed, seen1, seen2

    out, resumed, seen1, seen2 = asyncio.run(main())
    assert resumed.token_ids == baseline.token_ids and resumed.text == baseline.text
    # Each surviving token once, by its 1-based place in the output.
    full = [(t, i + 1) for i, t in enumerate(baseline.token_ids)]
    assert seen1 == full[: out.emitted] and seen2 == full[out.emitted:]


def test_token_callbacks_skip_a_popped_stop_token(baseline):
    stop = baseline.token_ids[5]
    cut = baseline.token_ids.index(stop)
    eng = tengine.AsyncEngine(_tcore())
    try:
        seen = []
        eng.set_token_callback("c", lambda tok, n: seen.append((tok, n)))
        out = eng.generate_sync(rid="c", prompt=PROMPT, timeout=60,
                                params=_greedy(TParams, 24, stop_token_ids=(stop,)))
    finally:
        eng.shutdown()
    assert out.finish_reason == "stop" and out.token_ids == baseline.token_ids[:cut]
    assert seen == [(t, i + 1) for i, t in enumerate(out.token_ids)]


# --- the worker's drain-with-handoff over memory:// ---------------------------------

QUEUE = "snap-jobs"


def _jobs():
    return [Job(id=f"w{i}", prompt=f"worker job {i} " + "xy" * i, temperature=0.0,
                max_tokens=30, ignore_eos=True, row=i) for i in range(4)]


async def _publish(url, bodies):
    broker = make_broker(url)
    await broker.connect()
    for body in bodies:
        await broker.publish(QUEUE, body)
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


@pytest.fixture(scope="module")
def reference_results(jcore):
    """The jobs served kill-free by a ``TPUWorker`` over the JAX engine."""
    from llmq_tpu.broker.base import make_broker as jmake_broker
    from llmq_tpu.core.config import Config as JWorkerConfig
    from llmq_tpu.workers.tpu_worker import TPUWorker

    url = f"memory://snap-ref-{uuid.uuid4().hex[:8]}"

    async def main():
        broker = jmake_broker(url)
        await broker.connect()
        for job in _jobs():
            await broker.publish(QUEUE, job.model_dump_json().encode(), message_id=job.id)
        worker = TPUWorker(QUEUE, model="preset://tiny", config=JWorkerConfig(broker_url=url),
                           engine_factory=lambda w: jengine.AsyncEngine(jcore))
        task = asyncio.create_task(worker.run())
        out = {}
        while len(out) < len(_jobs()):
            msg = await broker.get(QUEUE + ".results")
            if msg is None:
                await asyncio.sleep(0.02)
                continue
            r = json.loads(msg.body)
            out[r["id"]] = r
            await msg.ack()
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=60)
        await broker.close()
        return out

    return asyncio.run(main())


def test_worker_shutdown_hands_jobs_to_a_second_worker(reference_results):
    """``request_shutdown`` mid-decode: the first port worker republishes
    its in-flight jobs with their snapshots under ``RESUME_FIELD``; a
    second port worker resumes them; every job has one result, its text
    and usage the kill-free ``TPUWorker`` run's."""
    url = f"memory://snap-port-{uuid.uuid4().hex[:8]}"

    async def main():
        await _publish(url, [j.model_dump_json().encode() for j in _jobs()])
        first = TorchWorker(QUEUE, tengine.AsyncEngine(_tcore()), broker_url=url,
                            concurrency=8)
        loop = asyncio.get_running_loop()

        def stop_at(tok, n):  # mid-decode of w0: shut the first worker down
            if n == 4:
                loop.call_soon_threadsafe(first.request_shutdown)
                _hold_until_handoff(first.engine)

        first.engine.set_token_callback("w0", stop_at)
        await asyncio.wait_for(first.run(), timeout=60)
        first.engine.shutdown()
        held = []
        broker = make_broker(url)
        await broker.connect()
        while (msg := await broker.get(QUEUE)) is not None:
            held.append(msg)
        queued = [json.loads(msg.body) for msg in held]
        for msg in held:  # back for the second worker
            await msg.reject(requeue=True)
        second = TorchWorker(QUEUE, tengine.AsyncEngine(_tcore()), broker_url=url,
                             concurrency=8)
        task = asyncio.create_task(second.run())
        results = await _results(broker, len(_jobs()))
        second.request_shutdown()
        await asyncio.wait_for(task, timeout=60)
        second.engine.shutdown()
        await broker.close()
        return first, second, queued, results

    first, second, queued, results = asyncio.run(main())
    assert first.jobs_handed_off >= 1 and second.jobs_resumed >= 1
    carried = [q for q in queued if RESUME_FIELD in q]
    assert len(carried) == first.jobs_handed_off
    assert all(set(q[RESUME_FIELD]) == {"snapshot", "offset"} for q in carried)
    assert any(q[RESUME_FIELD]["offset"] > 0 for q in carried)
    assert sorted(results) == sorted(reference_results)
    for rid, ref in reference_results.items():
        got = results[rid]
        assert (got["result"], got["usage"]) == (ref["result"], ref["usage"]), rid
        assert got["row"] == ref["row"] and RESUME_FIELD not in got
    assert any(r.get("resume_offset", 0) > 0 for r in results.values())


def test_worker_reruns_a_job_whose_snapshot_does_not_fit():
    """A resume snapshot of another KV dtype, or one that does not decode,
    re-runs the job from its prompt (the reference's semantics)."""
    src = _tcore()
    src.add_request("m0", prompt=PROMPT, params=_greedy(TParams, 20))
    _step_until(src, "m0", 5)
    snap = src.extract_request("m0")  # an f32 pool's pages
    want = _run(_tcore(kv_dtype="bf16"), [("plain", PROMPT, 20)])["plain"]
    url = f"memory://snap-rerun-{uuid.uuid4().hex[:8]}"
    jobs = []
    for rid, blob in (("m0", tsnap.snapshot_to_b64(snap)),
                      ("m1", base64.b64encode(b"LLMQSNAP garbage").decode())):
        job = json.loads(Job(id=rid, prompt=PROMPT, temperature=0.0, max_tokens=20,
                             ignore_eos=True).model_dump_json())
        job[RESUME_FIELD] = {"snapshot": blob, "offset": 5}
        jobs.append(json.dumps(job).encode())

    async def main():
        await _publish(url, jobs)
        worker = TorchWorker(QUEUE, tengine.AsyncEngine(_tcore(kv_dtype="bf16")),
                             broker_url=url, max_jobs=2)
        await asyncio.wait_for(worker.run(), timeout=60)
        worker.engine.shutdown()
        broker = make_broker(url)
        await broker.connect()
        results = await _results(broker, 2)
        await broker.close()
        return worker, results

    worker, results = asyncio.run(main())
    assert worker.jobs_resumed == 0 and worker.jobs_processed == 2
    for rid in ("m0", "m1"):
        assert results[rid]["result"] == want.text and results[rid]["resume_offset"] == 5


def test_interactive_job_with_a_resume_snapshot_resumes(baseline):
    """ROADMAP.md queue 3 item 7: the JAX worker hands ``priority`` to
    ``AsyncEngine.resume``, which takes none; the port resumes such a job
    (as batch: a snapshot carries no class) to the uninterrupted text."""
    import inspect

    assert "priority" not in inspect.signature(jengine.AsyncEngine.resume).parameters
    src = _tcore()
    src.add_request("v0", prompt=PROMPT, params=_greedy(TParams, 24))
    _step_until(src, "v0", 5)
    snap = src.extract_request("v0")
    job = json.loads(Job(id="v0", prompt=PROMPT, temperature=0.0, max_tokens=24,
                         ignore_eos=True, priority="interactive").model_dump_json())
    job[RESUME_FIELD] = {"snapshot": tsnap.snapshot_to_b64(snap),
                         "offset": len(snap.output_ids)}
    url = f"memory://snap-vip-{uuid.uuid4().hex[:8]}"

    async def main():
        await _publish(url, [json.dumps(job).encode()])
        worker = TorchWorker(QUEUE, tengine.AsyncEngine(_tcore()), broker_url=url, max_jobs=1)
        await asyncio.wait_for(worker.run(), timeout=60)
        worker.engine.shutdown()
        broker = make_broker(url)
        await broker.connect()
        results = await _results(broker, 1)
        await broker.close()
        return worker, results["v0"]

    worker, result = asyncio.run(main())
    assert worker.jobs_resumed == 1 and result["resume_offset"] == len(snap.output_ids)
    assert result["result"] == baseline.text


def test_worker_dead_letters_a_lapsed_deadline_before_the_engine():
    """A job whose ``deadline_at`` has passed is filed on ``<queue>.failed``
    as ``deadline_exceeded`` before any engine work (``base.py:541``); one
    with a deadline ahead is served."""
    url = f"memory://snap-deadline-{uuid.uuid4().hex[:8]}"
    late = Job(id="late", prompt=PROMPT, temperature=0.0, max_tokens=4, ignore_eos=True,
               deadline_at=time.time() - 5)
    ok = Job(id="ok", prompt=PROMPT, temperature=0.0, max_tokens=4, ignore_eos=True,
             deadline_at=time.time() + 3600)

    async def main():
        await _publish(url, [late.model_dump_json().encode(), ok.model_dump_json().encode()])
        worker = TorchWorker(QUEUE, tengine.AsyncEngine(_tcore()), broker_url=url, max_jobs=2)
        await asyncio.wait_for(worker.run(), timeout=60)
        worker.engine.shutdown()
        broker = make_broker(url)
        await broker.connect()
        results = await _results(broker, 1)
        failed = await broker.get(QUEUE + ".failed")
        await failed.ack()
        await broker.close()
        return worker, results, failed

    worker, results, failed = asyncio.run(main())
    assert list(results) == ["ok"] and worker.jobs_deadline_exceeded == 1
    assert json.loads(failed.body)["id"] == "late"
    assert failed.headers["x-failure-reason"] == "deadline_exceeded"
    assert worker.engine.core.stats()["prompt_tokens"] == len(PROMPT)  # "ok" alone
