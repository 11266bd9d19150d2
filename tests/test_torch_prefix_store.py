"""The port's prefix-KV plane against the JAX package's (M11b).

Store: the byte-budgeted LRU of ``engine/prefix_store.py`` behaves as
``llmq_tpu.engine.prefix_store``'s (budget, oversize, contiguous chain
match, invalidation, hot chains) and takes the governor's evictions from
another thread. Codec: for f32, bf16 and e5m2 pages the
port's chunk bytes equal the JAX codec's byte for byte (the port carries
pages as raw bits, JAX as ``ml_dtypes`` arrays), each side decodes the
other's, and damaged or foreign chunks raise the port's errors.

Engines: one JAX ``EngineCore`` (f32, tiny, page 8, chunked prefill, the
prefix cache and its host tier; compiled once for the module, and shared
with ``test_torch_disagg.py`` through :func:`jax_core`) and port engines
over the same numpy-made weights. A port engine whose tight pool evicts
the template's pages under pressure demotes and promotes them and gives
the cold run's and the JAX engine's greedy tokens; promoted pages are
shared by later admits; an abort drops the tier and demotes nothing;
chunks exported by either engine ingest into the other with equal
tokens; after the same requests the host tier holds JAX's entries, hit
counts and ranking; ``prefill_only`` stops at the boundary with the
JAX engine's snapshot, and adoption crosses the two engines both ways
with the monolith's tokens.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llmq_tpu.engine import engine as jengine
from llmq_tpu.engine import prefix_store as jstore
from llmq_tpu.engine import snapshot as jsnap
from llmq_tpu.engine.sampling import SamplingParams as JParams
from llmq_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.parallel import make_mesh
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine import prefix_store as tstore
from llmq_tpu_torch.engine import snapshot as tsnap
from llmq_tpu_torch.engine.sampling import SamplingParams as TParams
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.utils.hashing import token_prefix_chain

from test_torch_model import numpy_params

pytestmark = pytest.mark.unit

# --- the store -----------------------------------------------------------------------


def _page(seed, shape=(2, 1, 8, 2, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(budget, **kw):
    return tstore.PrefixStore(budget, **kw), jstore.PrefixStore(budget, **kw)


def _keys(store):
    return list(store._entries)


def test_store_keeps_its_byte_budget_in_lru_order_as_jax():
    page_bytes = 2 * _page(0).nbytes
    for store in _both(3 * page_bytes, page_size=8):
        for i in range(3):
            assert store.put(bytes([i]) * 16, _page(i), _page(100 + i))
        assert len(store) == 3 and store.occupancy_bytes == 3 * page_bytes
        assert store.get(bytes([0]) * 16) is not None  # entry 0 becomes the newest
        assert store.put(bytes([3]) * 16, _page(3), _page(103))  # evicts entry 1
        assert store.evictions == 1
        assert bytes([1]) * 16 not in store and bytes([0]) * 16 in store
        got = store.get(bytes([3]) * 16)
        np.testing.assert_array_equal(got.k, _page(3))
        np.testing.assert_array_equal(got.v, _page(103))
    port, ref = _both(3 * page_bytes, page_size=8)
    for store in (port, ref):
        for i in (0, 1, 2, 0, 3, 4):
            store.put(bytes([i]) * 16, _page(i), _page(i))
    assert _keys(port) == _keys(ref) and port.stats() == ref.stats()


def test_store_refuses_an_oversize_blob_and_evicts_on_demand():
    for store in _both(8, page_size=8):
        assert not store.put(b"x" * 16, _page(0), _page(1))
        assert len(store) == 0 and store.occupancy_bytes == 0
    store = tstore.PrefixStore(1 << 20, page_size=8)
    for i in range(4):
        store.put(bytes([i]) * 16, _page(i), _page(i))
    one = 2 * _page(0).nbytes
    assert store.evict_bytes(one + 1) == 2 * one  # whole entries, oldest first
    assert _keys(store) == [bytes([2]) * 16, bytes([3]) * 16] and store.evictions == 2


def test_store_matches_a_contiguous_chain_from_its_head():
    for store in _both(1 << 20, page_size=8):
        keys = [bytes([i]) * 16 for i in range(4)]
        for i in (0, 1, 3):  # a hole at 2
            store.put(keys[i], _page(i), _page(100 + i))
        assert [h for h, _ in store.match_chain(keys)] == keys[:2]
        assert store.match_chain([keys[2], keys[3]]) == []


def test_store_invalidate_clears_everything():
    for store in _both(1 << 20, page_size=8):
        store.put(b"a" * 16, _page(0), _page(1))
        store.invalidate()
        assert len(store) == 0 and store.occupancy_bytes == 0
        assert store.get(b"a" * 16) is None


def test_store_ranks_hot_chains_by_hits_as_jax():
    hot = []
    for store in _both(1 << 20, page_size=8):
        for i in range(3):
            store.put(bytes([i]) * 16, _page(i), _page(100 + i))
        for _ in range(3):
            store.get(bytes([2]) * 16)
        store.get(bytes([0]) * 16)
        hot.append(store.hot_chains(2))
    assert hot[0] == hot[1] == [(bytes([2]) * 16).hex(), (bytes([0]) * 16).hex()]


# --- the chunk codec -----------------------------------------------------------------

#: stored dtype name -> (torch dtype, ml_dtypes / numpy dtype JAX holds it in)
KV = {"float32": (torch.float32, np.float32), "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
      "float8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2)}
SIG = dict(num_layers=2, num_kv_heads=2, head_dim=4)


def _raw_page(name: str, seed: int) -> np.ndarray:
    """A [L, 1, page, H, D] page of ``name`` as the port carries it."""
    pool = torch.from_numpy(_page(seed)).to(KV[name][0])
    return tsnap.pages_to_host(pool, torch.tensor([0]))


def _as_jax(name: str, raw: np.ndarray) -> np.ndarray:
    return raw if name == "float32" else raw.view(KV[name][1])


def test_store_takes_evictions_from_another_thread():
    """The governor's evictor runs on whichever thread charges the shared
    budget (a worker's event loop), while the engine thread puts, matches
    chains and ranks: nothing raises and the byte count stays the
    entries' sum."""
    page = _page(0)
    store = tstore.PrefixStore(24 * 2 * page.nbytes, page_size=8)
    keys = [bytes([i]) * 16 for i in range(32)]
    errors, done = [], threading.Event()

    def engine_thread():
        try:
            for i in range(3000):
                store.put(keys[i % 32], page, page)
                store.match_chain(keys[: 1 + i % 32])
                if i % 16 == 0:
                    store.hot_chains(4)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)
        finally:
            done.set()

    def evictor():
        try:
            while not done.is_set():
                store.evict_bytes(3 * 2 * page.nbytes)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=engine_thread), threading.Thread(target=evictor)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]
    assert store.evictions > 0
    assert store.occupancy_bytes == sum(e.nbytes for e in store._entries.values())



@pytest.mark.parametrize("name", list(KV))
def test_chunk_bytes_equal_the_jax_codec_and_cross_decode(name):
    k, v = _raw_page(name, 1), _raw_page(name, 2)
    sig = {**SIG, "kv_dtype": name}
    blob = tstore.chunk_to_bytes(b"k" * 16, k, v, model_sig=sig, page_size=8)
    assert blob == jstore.chunk_to_bytes(b"k" * 16, _as_jax(name, k), _as_jax(name, v),
                                         model_sig=sig, page_size=8)
    key, pk, pv, psig, ps = tstore.chunk_from_bytes(blob)
    assert (key, psig, ps) == (b"k" * 16, sig, 8)
    assert pk.dtype == k.dtype and np.array_equal(pk, k) and np.array_equal(pv, v)
    jkey, jk, jv, _, _ = jstore.chunk_from_bytes(blob)
    assert jk.dtype == np.dtype(KV[name][1])
    assert np.array_equal(jk.view(k.dtype), k) and np.array_equal(jv.view(v.dtype), v)
    assert tstore.chunk_from_b64(jstore.chunk_to_b64(blob)) == blob


def test_damaged_and_foreign_chunks_raise_the_ports_errors():
    blob = tstore.chunk_to_bytes(b"k" * 16, _page(7), _page(8), model_sig=SIG, page_size=8)
    bad = bytearray(blob)
    bad[-1] ^= 0xFF
    with pytest.raises(tsnap.SnapshotIntegrityError):
        tstore.chunk_from_bytes(bytes(bad))
    for cut in (blob[: len(blob) // 2], blob[:10]):
        with pytest.raises(tsnap.SnapshotIntegrityError):
            tstore.chunk_from_bytes(cut)
    with pytest.raises(tsnap.SnapshotError, match="magic"):
        tstore.chunk_from_bytes(b"NOTMAGIC" + blob[len(tstore.CHUNK_MAGIC):])
    newer = bytearray(blob)
    newer[len(tstore.CHUNK_MAGIC)] = 0xFF  # the u16 LE version's low byte
    with pytest.raises(tsnap.SnapshotVersionError):
        tstore.chunk_from_bytes(bytes(newer))
    with pytest.raises(tsnap.SnapshotError):
        tstore.chunk_from_b64("not!!base64")
    with pytest.raises(tsnap.SnapshotError, match="stored KV dtype"):
        tstore.chunk_to_bytes(b"k" * 16, _page(0).astype(np.float16), _page(0), model_sig=SIG,
                              page_size=8)
    tstore.check_chunk_compat(SIG, 8, want_sig=SIG, want_page_size=8)
    for sig, page in ((SIG, 16), ({"num_layers": 3}, 8)):
        with pytest.raises(tsnap.SnapshotCompatError):
            tstore.check_chunk_compat(sig, page, want_sig=SIG, want_page_size=8)


# --- engines: the port against the JAX engine ----------------------------------------

JCFG = JConfig.tiny(vocab_size=304)
TCFG = TConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
TREE = numpy_params(JCFG, 0)
# Page 8, chunks of 8, the prefix cache and a host tier, roomy.
ROOMY = dict(max_num_seqs=4, max_model_len=96, page_size=8, num_pages=40, kv_dtype="f32",
             min_prefill_bucket=16, prefill_chunk_size=8, enable_prefix_caching=True,
             prefix_host_gb=0.25, admit_max_wait_s=1e9)
# One slot over 8 usable pages: a second prompt's allocation evicts the first
# one's cached pages.
TIGHT = dict(ROOMY, max_num_seqs=1, num_pages=9)
TEMPLATE = "SYSTEM: answer. "  # 16 bytes: two full pages of 8
_JAX_CORE = []


def jax_core() -> "jengine.EngineCore":
    """The module's JAX engine (ROOMY), built once per process."""
    if not _JAX_CORE:
        _JAX_CORE.append(jengine.EngineCore(
            JCFG, jax.tree.map(jnp.asarray, TREE), JByteTokenizer(),
            mesh=make_mesh(tensor_parallel=1),
            engine_config=jengine.EngineConfig(**{**ROOMY, "kv_dtype": jnp.float32}),
        ))
    return _JAX_CORE[0]


@pytest.fixture
def jcore():
    """The shared JAX engine with both prefix tiers emptied (an abort
    invalidates them), so every test starts from the same state."""
    core = jax_core()
    core.abort_all("reset")
    return core


def tcore(**overrides):
    return tengine.EngineCore(TCFG, params_from_numpy(TREE), ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(**{**ROOMY, **overrides}))


def greedy(cls, n=12):
    return cls(temperature=0.0, max_tokens=n, ignore_eos=True)


def run(core, requests=(), cls=TParams, **kw):
    for rid, prompt, n in requests:
        core.add_request(rid, prompt=prompt, params=greedy(cls, n), **kw)
    outs = {}
    for _ in range(2000):
        for out in core.step():
            outs[out.rid] = out
        if not core.has_work:
            break
    assert not core.has_work, "engine stalled"
    return outs


def digests(prompt):
    return [h.hex() for h in token_prefix_chain(ByteTokenizer().encode(prompt), 8)]


FIRST, FILLER, SECOND = (TEMPLATE + "first question here?", "unrelated filler prompt " * 2,
                         TEMPLATE + "second question now?")


def test_host_tier_serve_under_pressure_equals_cold_and_jax(jcore):
    """A tight pool: the filler's allocation evicts FIRST's cached pages,
    which demote; SECOND promotes the template's two pages. Its tokens
    equal a cold run's (the same pool without the tier) and the JAX engine's with the tier on
    (the JAX run flushes its device cache to the host tier instead)."""
    port = tcore(**TIGHT)
    outs = {}
    for req in (("first", FIRST, 12), ("filler", FILLER, 12), ("second", SECOND, 12)):
        outs.update(run(port, [req]))
    assert port.prefix_demotes > 0 and port.prefix_promotes == 2
    assert port.scheduler.prefix_hits == 2 and port.stats()["prefix_host_hits"] == 2
    cold = tcore(**{**TIGHT, "prefix_host_gb": 0.0})  # the same pool, the tier off
    want = run(cold, [("first", FIRST, 12), ("filler", FILLER, 12)])
    want.update(run(cold, [("second", SECOND, 12)]))
    jouts = run(jcore, [("first", FIRST, 12), ("filler", FILLER, 12)], JParams)
    jcore.flush_prefix_to_host()
    promotes = jcore.prefix_promotes
    jouts.update(run(jcore, [("second", SECOND, 12)], JParams))
    assert jcore.prefix_promotes - promotes == 2
    for rid in ("first", "filler", "second"):
        assert outs[rid].token_ids == want[rid].token_ids == jouts[rid].token_ids, rid
    # The promoted positions were not prefilled again.
    assert port.prefill_tokens == cold.prefill_tokens - 16


def test_promoted_pages_are_shared_by_later_admits(jcore):
    prompt = TEMPLATE + "shared tail q?"
    n_pages = len(digests(prompt))
    counts = []
    for core, cls in ((tcore(), TParams), (jcore, JParams)):
        run(core, [("a", prompt, 6)], cls)
        core.flush_prefix_to_host()
        before = (core.prefix_promotes, core.scheduler.prefix_hits)
        outs = run(core, [("b", prompt, 6), ("c", prompt, 6)], cls)
        assert outs["b"].token_ids == outs["c"].token_ids
        counts.append((core.prefix_promotes - before[0], core.scheduler.prefix_hits - before[1]))
    # One admission promotes; the other shares the promoted pages.
    assert counts[0] == counts[1] == (n_pages, 2 * n_pages)


def test_abort_drops_the_host_tier_and_demotes_nothing():
    core = tcore()
    prompt = TEMPLATE + "to be aborted"
    run(core, [("r0", prompt, 6)])
    core.flush_prefix_to_host()
    assert len(core.prefix_store) > 0
    run(core, [("r1", prompt, 6)])  # cached device pages again
    demotes = core.prefix_demotes
    core.abort_all("test_abort")
    assert len(core.prefix_store) == 0 and core.prefix_demotes == demotes
    assert not core.scheduler._prefix_cache


def test_chunks_ship_across_the_engines_both_ways(jcore):
    """Chunks the port exports (host tier and device cache) ingest into
    the JAX engine, and the JAX engine's into the port; the importer's
    serve skips the shipped pages' prefill and gives the exporter's
    tokens."""
    prompt = TEMPLATE + "cross engine q?"
    want = digests(prompt)
    port = tcore()
    cold = run(port, [("cold", prompt, 12)])["cold"]
    assert len(port.export_prefix_chunks(want)) == len(want)  # from the device cache
    port.flush_prefix_to_host()
    chunks = port.export_prefix_chunks(want + ["ff" * 16, "not hex"])  # misses skipped
    assert len(chunks) == len(want) and port.prefix_chunks_exported == 2 * len(want)
    assert jcore.ingest_prefix_chunks(chunks) == len(want)
    promotes = jcore.prefix_promotes
    assert run(jcore, [("warm", prompt, 12)], JParams)["warm"].token_ids == cold.token_ids
    assert jcore.prefix_promotes - promotes == len(want)
    back = jcore.export_prefix_chunks(want)
    dst = tcore()
    assert dst.ingest_prefix_chunks(back) == len(want) == dst.prefix_chunks_ingested
    assert run(dst, [("warm", prompt, 12)])["warm"].token_ids == cold.token_ids
    assert dst.prefix_promotes == len(want) and dst.scheduler.prefix_hits == len(want)
    assert dst.prefill_tokens == len(ByteTokenizer().encode(prompt)) - 8 * len(want)
    foreign = tstore.chunk_to_bytes(b"z" * 16, _page(0), _page(1), model_sig={"num_layers": 9},
                                    page_size=8)
    with pytest.raises(tsnap.SnapshotCompatError):
        dst.ingest_prefix_chunks([tstore.chunk_to_b64(foreign)])
    assert tcore(prefix_host_gb=0.0).ingest_prefix_chunks(back) == 0  # no tier: nothing taken


def test_host_tier_holds_the_jax_engines_entries_after_the_same_requests(jcore):
    """After the same requests and flushes, the port's host tier holds the
    JAX tier's pages in the same LRU order with the same hit counts and
    ranking, and the engines' prefix counters moved alike."""
    a, b = TEMPLATE + "alpha question?", "another template, longer " + "zz" * 4
    port = tcore()
    counted = ("prefix_demotes", "prefix_promotes", "prefix_host_inserts", "prefix_host_hits",
               "prefix_host_misses", "prefix_host_evictions")
    before = {k: jcore.stats()[k] for k in counted}
    for core, cls in ((port, TParams), (jcore, JParams)):
        run(core, [("a", a, 4)], cls)
        core.flush_prefix_to_host()
        run(core, [("a2", a, 4), ("b", b, 4)], cls)
        core.flush_prefix_to_host()
    ts, js = port.prefix_store, jcore.prefix_store
    assert len(ts) > 0 and _keys(ts) == _keys(js)
    assert [e.hits for e in ts._entries.values()] == [e.hits for e in js._entries.values()]
    assert ts.hot_chains(3) == js.hot_chains(3) and ts.hot_chains() == js.hot_chains()
    st, jst = port.stats(), jcore.stats()
    assert {k: st[k] for k in counted} == {k: jst[k] - before[k] for k in counted}
    assert st["prefix_demotes"] > 0 and st["prefix_promotes"] > 0
    assert st["prefix_host_bytes"] == jst["prefix_host_bytes"] == ts.occupancy_bytes
    assert st["prefix_host_budget_bytes"] == int(0.25 * 2**30)


def test_host_tier_resolves_its_config_as_the_jax_engine(monkeypatch):
    with pytest.raises(ValueError, match="enable_prefix_caching"):
        tcore(enable_prefix_caching=False, prefill_chunk_size=None)
    with pytest.raises(ValueError, match="want >= 0"):
        tengine.EngineConfig(prefix_host_gb=-1)
    monkeypatch.setenv("LLMQ_PREFIX_HOST_GB", "0.5")
    core = tcore(prefix_host_gb=0.0)
    assert core.prefix_store.budget_bytes == int(0.5 * 2**30) and core.prefix_host_gb == 0.5
    monkeypatch.setenv("LLMQ_PREFIX_HOST_GB", "0")
    assert tcore().prefix_store is None
    monkeypatch.setenv("LLMQ_PREFIX_HOST_GB", "lots")
    with pytest.raises(ValueError, match="not a number"):
        tcore()


# --- prefill_only ----------------------------------------------------------------------

PROMPT = "disaggregate this prompt "


def test_prefill_only_stops_at_the_boundary_with_the_jax_snapshot(jcore):
    """Both engines finish a prefill-only request at the boundary with no
    token kept and a snapshot of the prompt KV: fields equal, the bytes
    codec of each decodes in the other, the KV within f32 rounding of
    JAX's (the two frameworks' f32 products round apart)."""
    port = tcore()
    out = run(port, [("p0", PROMPT, 16)], prefill_only=True)["p0"]
    ref = run(jcore, [("p0", PROMPT, 16)], JParams, prefill_only=True)["p0"]
    for o in (out, ref):
        assert o.finish_reason == "prefill_done" and o.token_ids == []
        assert o.completion_tokens == 0 and o.prompt_tokens == len(PROMPT)
    snap, jsn = out.snapshot, ref.snapshot
    assert snap.kv_valid == jsn.kv_valid == len(PROMPT) - 1
    for name in ("rid", "prompt_ids", "output_ids", "epoch", "page_size", "model_sig",
                 "detok_len", "detok_text", "preempt_count"):
        assert getattr(snap, name) == getattr(jsn, name), name
    assert np.array_equal(snap.key_data, jsn.key_data)
    assert snap.kv_k.shape == jsn.kv_k.shape
    valid = snap.kv_valid
    for mine, theirs in ((snap.kv_k, jsn.kv_k), (snap.kv_v, jsn.kv_v)):
        flat = lambda a: a.reshape(a.shape[0], -1, *a.shape[3:])[:, :valid]  # noqa: E731
        np.testing.assert_allclose(flat(mine), flat(np.asarray(theirs)), rtol=0, atol=2e-5)
    blob = snap.to_bytes()
    assert jsnap.RequestSnapshot.from_bytes(blob).to_bytes() == blob
    assert tsnap.RequestSnapshot.from_bytes(jsn.to_bytes()).to_bytes() == jsn.to_bytes()
    assert port.stats()["prefill_done"] == 1 and "prefill_done" not in tcore().stats()


def test_prefill_only_adoption_crosses_the_engines_both_ways(jcore):
    """prefill_only on one engine, the wire bytes inserted into the other:
    the adopter samples the first token again and its greedy tokens equal
    the monolith's, in both directions."""
    mono = run(tcore(), [("r0", PROMPT, 16)])["r0"]
    assert len(mono.token_ids) == 16
    pre = tcore()
    snap = run(pre, [("r0", PROMPT, 16)], prefill_only=True)["r0"].snapshot
    jcore.insert_request(jsnap.snapshot_from_b64(tsnap.snapshot_to_b64(snap)))
    got = run(jcore, cls=JParams)["r0"]
    assert got.token_ids == mono.token_ids and got.text == mono.text
    jsnp = run(jcore, [("r1", PROMPT, 16)], JParams, prefill_only=True)["r1"].snapshot
    dec = tcore()
    dec.insert_request(tsnap.snapshot_from_wire(jsnap.snapshot_to_b64(jsnp)))
    mono1 = run(tcore(), [("r1", PROMPT, 16)])["r1"]
    out = run(dec)["r1"]
    assert out.token_ids == mono1.token_ids and out.finish_reason == mono1.finish_reason
    assert dec.kv_restores == 1 and dec.prefill_tokens == 0
