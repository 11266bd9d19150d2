"""Port EngineCore against the JAX EngineCore: greedy tokens identical.

Both engines get one parameter tree (made with numpy in the layout of JAX
``init_params``, carried to torch by ``params_from_numpy``) and the same
engine settings, on ``ModelConfig.tiny()`` and on the flagship-tiny qwen2 config of
``__graft_entry__``, and on the tiny config with the JAX package's int8
and int4 trees and with an fp8 KV pool. The request mix covers batching
over more requests than slots, stop token ids, a stop string, ``min_tokens``,
``max_model_len`` truncation, and a pool tight enough to force
recompute preemption. Each JAX engine costs seconds of compiles on one
core, so the tests build few. The chunked-prefill tests add templated
traffic with the prefix cache on and off, and seeded temperature > 0
requests, whose tokens must match too (the threefry stream is ported).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_tiny
from llmq_tpu.engine import engine as jengine
from llmq_tpu.engine.sampling import SamplingParams as JParams
from llmq_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.parallel import make_mesh
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine.sampling import SamplingParams as TParams
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models import quant as tq
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.models.transformer import init_params

from test_torch_model import numpy_params

pytestmark = pytest.mark.unit

ENGINE = dict(max_num_seqs=4, max_model_len=64, page_size=8, num_pages=40,
              kv_dtype="f32", min_prefill_bucket=32)


def _cores(jcfg: JConfig, seed: int = 0, bits=None, **overrides):
    """A JAX and a port engine over one tree; ``bits`` quantizes it first
    (the port's ``quantize_params``, whose trees equal the JAX package's
    bit for bit: ``tests/test_torch_quant.py``)."""
    tree = numpy_params(jcfg, seed)
    if bits:
        tree = jax.tree.map(lambda t: t.numpy(), tq.quantize_params(params_from_numpy(tree),
                                                                     bits=bits))
    jparams = jax.tree.map(jnp.asarray, tree)
    settings = {**ENGINE, **overrides}
    jcore = jengine.EngineCore(
        jcfg, jparams, JByteTokenizer(),
        mesh=make_mesh(tensor_parallel=1),
        engine_config=jengine.EngineConfig(**settings),
    )
    tcore = tengine.EngineCore(
        TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}),
        params_from_numpy(tree), ByteTokenizer(),
        engine_config=tengine.EngineConfig(**settings), device="cpu",
    )
    return jcore, tcore


def _run(core, requests, params_cls):
    for rid, prompt, kw in requests:
        core.add_request(rid, prompt=prompt, params=params_cls(**{"temperature": 0.0, **kw}))
    outs = {}
    for _ in range(1000):
        for out in core.step():
            outs[out.rid] = out
        if not core.has_work:
            break
    assert len(outs) == len(requests), "engine stalled"
    return outs


def _both(cores, requests):
    jcore, tcore = cores
    jout = _run(jcore, requests, JParams)
    tout = _run(tcore, requests, TParams)
    for rid in jout:
        assert tout[rid].token_ids == jout[rid].token_ids, rid
        assert tout[rid].finish_reason == jout[rid].finish_reason, rid
        assert tout[rid].text == jout[rid].text, rid
        assert tout[rid].prompt_tokens == jout[rid].prompt_tokens, rid
    return jout, tout


# Prompts stay under 32 tokens, so one prefill bucket serves the mix (each
# extra bucket is another JAX compile).
MIX = [(f"r{i}", f"prompt {i} " * (1 + i % 3), dict(max_tokens=6 + i, ignore_eos=True))
       for i in range(6)]  # more requests than the 4 slots


def test_greedy_tokens_match_jax_engine_flagship_tiny():
    _both(_cores(_flagship_tiny()), MIX[:4])  # one prefill batch, one compile


def test_greedy_tokens_stops_and_preemption_match_jax_engine_tiny():
    # 11 usable pages of 8 tokens: the first wave of the mix fills them at
    # admission, so its growth forces recompute preemption. Prefill goes
    # one row at a time here (the flagship test covers batched prefill):
    # one prefill shape fewer for JAX to compile.
    cores = _cores(JConfig.tiny(vocab_size=304), num_pages=12, max_prefill_batch=1)
    probe, _ = _both(cores, MIX)
    assert cores[1].scheduler.preemptions > 0
    assert cores[1].scheduler.preemptions == cores[0].scheduler.preemptions
    toks, text = probe["r0"].token_ids, probe["r0"].text
    prompt = MIX[0][1]
    stops = [
        ("stop_id", prompt, dict(max_tokens=12, stop_token_ids=(toks[2],), ignore_eos=True)),
        ("min_tokens", prompt, dict(max_tokens=12, stop_token_ids=(toks[1],),
                                    min_tokens=4, ignore_eos=True)),
        ("truncated", "y" * 100, dict(max_tokens=50, ignore_eos=True)),
        ("eos", prompt, dict(max_tokens=12)),
    ]
    if len(text) >= 4:
        stops.append(("stop_str", prompt, dict(max_tokens=12, stop=(text[2:4],),
                                               ignore_eos=True)))
    _, tout = _both(cores, stops)
    assert tout["stop_id"].finish_reason == "stop"
    assert tout["min_tokens"].completion_tokens >= 4
    assert tout["truncated"].prompt_tokens == 63 and tout["truncated"].finish_reason == "length"
    if "stop_str" in tout:
        assert tout["stop_str"].finish_reason == "stop"
        assert text[2:4] not in tout["stop_str"].text


# Templated traffic: a shared 5-page head, distinct tails, greedy and
# sampled rows (seeded, and one unseeded whose stream follows its rid).
TEMPLATE = "Summarise the ticket below in one line. "  # 40 byte tokens: 5 pages of 8
PREFIX_MIX = [
    (f"p{i}", TEMPLATE + f"ticket {i}: " + "x" * (3 * i), dict(max_tokens=5 + i, ignore_eos=True))
    for i in range(4)
] + [
    ("s0", TEMPLATE + "seeded one", dict(max_tokens=8, temperature=0.8, seed=7, ignore_eos=True)),
    ("s1", TEMPLATE + "seeded two", dict(max_tokens=8, temperature=1.2, seed=2**31 + 5,
                                         ignore_eos=True)),
    ("u0", "unseeded " + TEMPLATE, dict(max_tokens=6, temperature=0.9, ignore_eos=True)),
]


@pytest.mark.parametrize("chunk,prefix", [(8, True), (16, False)])
def test_chunked_prefill_and_prefix_cache_match_jax_engine(chunk, prefix):
    """Chunked prefill (with and without the prefix cache) on a pool tight
    enough to force recompute preemption: greedy AND sampled tokens
    identical to the JAX engine (the threefry stream is ported), and the
    prefix-cache page counters equal."""
    cores = _cores(JConfig.tiny(vocab_size=304), num_pages=15, max_model_len=80,
                   prefill_chunk_size=chunk, enable_prefix_caching=prefix)
    _both(cores, PREFIX_MIX)
    jstats, tstats = cores[0].scheduler.stats(), cores[1].scheduler.stats()
    assert tstats["preemptions"] > 0 and tstats["preemptions"] == jstats["preemptions"]
    if prefix:
        assert tstats["prefix_cache_hit_pages"] > 0
        for key in ("prefix_cache_hit_pages", "prefix_cache_miss_pages"):
            assert tstats[key] == jstats[key], key
    assert cores[1].stats()["prefill_tokens"] == cores[0].stats()["prefill_tokens"]


@pytest.mark.parametrize("mode", ["int8", "int4", "fp8"])
def test_quantized_weights_and_fp8_pool_match_jax_engine(monkeypatch, mode):
    """Greedy tokens equal the JAX engine's with int8 / int4 weights (one
    quantized tree on both sides) and with a float8_e5m2 KV pool, f32
    compute, the kernel switches off on both sides."""
    for var in ("LLMQ_INT8_MATMUL", "LLMQ_INT4_MATMUL"):
        monkeypatch.delenv(var, raising=False)
    overrides = {"kv_dtype": "fp8"} if mode == "fp8" else {}
    cores = _cores(JConfig.tiny(), bits={"int8": 8, "int4": 4}.get(mode), **overrides)
    _both(cores, MIX[:4])
    want = "float8_e5m2" if mode == "fp8" else "float32"
    assert cores[1].stats()["kv_dtype"] == want == str(cores[0].k_pages.dtype)


def test_engine_config_fields_and_unported_options():
    assert [f.name for f in dataclasses.fields(tengine.EngineConfig)] == [
        f.name for f in dataclasses.fields(jengine.EngineConfig)
    ]
    jc, tc = jengine.EngineConfig(), tengine.EngineConfig()
    for f in dataclasses.fields(jc):
        if f.name != "kv_dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.kv_dtype == torch.bfloat16
    assert tengine._prefill_buckets(tengine.EngineConfig(max_model_len=700)) == \
        jengine._prefill_buckets(jengine.EngineConfig(max_model_len=700))
    cfg = TConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(NotImplementedError, match="M13"):
        tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu",
                           engine_config=tengine.EngineConfig(tp_overlap="on"))
    # The fault planes' fields (M12, once refused here) build, each honoured
    # with the JAX config's checks; the activation taps are refused by name.
    core = tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(
                                  watchdog_mult=2.0, watchdog_min_s=5.0, logit_guard="on",
                                  guard_logit_max=1e4, guard_entropy_min=0.01))
    assert (core.watchdog.mult, core.watchdog.min_s, core.logit_guard, core.guard_logit_max,
            core.guard_entropy_min) == (2.0, 5.0, "on", 1e4, 0.01)
    assert core.stats()["integrity"] == "ok" and core.stats()["watchdog_trips"] == 0
    core.stop_watchdog()
    for field, value in (("watchdog_mult", -1.0), ("watchdog_min_s", 0.0),
                         ("logit_guard", "maybe"), ("canary_every", -1.0)):
        with pytest.raises(ValueError, match=field):
            tengine.EngineConfig(**{field: value})
        with pytest.raises(ValueError, match=field):
            jengine.EngineConfig(**{field: value})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMQ_ACT_STATS", "1")
        with pytest.raises(NotImplementedError, match="LLMQ_ACT_STATS.*M12b"):
            tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu")
    # The fused dispatch modes (M10) and the request-state fields (M11, once
    # refused here: interactive_decode_block) build, holding the JAX config's
    # values; interactive_decode_block is what the config says (0 unless set).
    for fields in (dict(decode_block=4), dict(spec_tokens=2),
                   dict(mixed_step="on", prefill_chunk_size=16),
                   dict(decode_block=4, interactive_decode_block=2),
                   dict(preempt_mode="swap"),
                   dict(decode_block=2, priority_classes=False, interactive_decode_block=1)):
        core = tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu",
                                  engine_config=tengine.EngineConfig(**fields))
        jcfg = jengine.EngineConfig(**fields)
        for name in fields:
            assert getattr(core.cfg, name) == getattr(jcfg, name), name
        mode = next(iter(fields))
        assert core.stats()[mode] == fields[mode]
        # JAX resolves it to 0 with the priority classes off (:774).
        want_ik = fields.get("interactive_decode_block", 0) if core.priority_classes else 0
        assert core.interactive_decode_block == want_ik
    # The host prefix tier (M11b, once refused here) builds over the prefix
    # cache, and is refused without it, as in JAX.
    core = tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(
                                  prefix_host_gb=0.5, enable_prefix_caching=True,
                                  prefill_chunk_size=16))
    assert core.stats()["prefix_host_budget_bytes"] == int(0.5 * 2**30)
    with pytest.raises(ValueError, match="enable_prefix_caching"):
        tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu",
                           engine_config=tengine.EngineConfig(prefix_host_gb=0.5))
    with pytest.raises(ValueError, match="preempt_mode"):
        tengine.EngineConfig(preempt_mode="maybe")
    for name in ("fp8", "fp8_e5m2", "float8_e5m2"):  # JAX's name table (M9 is ported)
        assert tengine.EngineConfig(kv_dtype=name).kv_dtype == torch.float8_e5m2
    with pytest.raises(ValueError, match="kv_dtype"):
        tengine.EngineConfig(kv_dtype="int4")
    with pytest.raises(ValueError, match="prefill_chunk_size"):
        tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu",
                           engine_config=tengine.EngineConfig(enable_prefix_caching=True))


def test_abort_all_invalidates_prefix_cache():
    """After an abort the KV content is untrusted: no cached prefix page may
    survive to serve a later request, and every page returns to the pool."""
    cfg = TConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    core = tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(
                                  **{**ENGINE, "prefill_chunk_size": 16,
                                     "enable_prefix_caching": True}))
    for i in range(2):  # one after the other: the second hits the first's pages
        _run(core, [(f"a{i}", TEMPLATE + str(i), dict(max_tokens=3, ignore_eos=True))], TParams)
    sched = core.scheduler
    assert sched.stats()["prefix_cache_hit_pages"] > 0 and sched.allocator._cached
    core.add_request("late", prompt=TEMPLATE + "late", params=TParams(max_tokens=3))
    core.abort_all()
    assert not sched._prefix_cache and not sched.allocator._cached
    assert sched.allocator.available == sched.config.num_pages - 1
    out = _run(core, [("after", TEMPLATE + "after", dict(max_tokens=3, ignore_eos=True))],
               TParams)
    assert out["after"].completion_tokens == 3
    assert sched.stats()["prefix_cache_miss_pages"] >= 5  # nothing left to hit


def test_async_engine_generate_sync_and_cancel():
    cfg = TConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    core = tengine.EngineCore(cfg, params, ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(**ENGINE))
    engine = tengine.AsyncEngine(core)
    try:
        out = engine.generate_sync(rid="a", prompt="hello", timeout=60,
                                   params=TParams(temperature=0.0, max_tokens=5,
                                                  ignore_eos=True))
        assert out.completion_tokens == 5 and out.finish_reason == "length"
        fut = engine._submit("b", "hello again", None, None,
                             TParams(temperature=0.0, max_tokens=60, ignore_eos=True))
        engine.cancel("b")
        assert fut.result(timeout=60).finish_reason in ("cancelled", "length")
        assert engine.stats()["generated_tokens"] >= 5
    finally:
        engine.shutdown()
    assert not engine._thread.is_alive()
