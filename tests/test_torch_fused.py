"""The port's fused dispatch modes (M10) against the JAX engine's.

``decode_block`` K, speculative decoding (``spec_tokens``, its drafter and
verify sampler, ``Transformer.verify``) and mixed steps (``mixed_step``,
``mixed_query_grid``, ``Transformer.mixed``), each held against the JAX
function or engine in the same mode on the JAX CPU backend: one numpy-made
tree on both sides (``test_torch_model.numpy_params``), the tiny config.
Greedy tokens must equal JAX's and the port's own run with the mode off;
seeded tokens must equal JAX's; the drafter and the verify sampler are
bit-equal; verify / mixed logits within 1e-4. Each JAX engine compiles
for seconds on one core, so there is one a mode, module-scoped, reused by
every test of that mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmq_tpu.engine import engine as jengine
from llmq_tpu.engine import sampling as jsampling
from llmq_tpu.engine.sampling import SamplingParams as JParams
from llmq_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.models.transformer import Transformer as JTransformer
from llmq_tpu.models.transformer import make_kv_pages as jpages
from llmq_tpu.ops.attention import mixed_query_grid as jgrid
from llmq_tpu.parallel import make_mesh
from llmq_tpu_torch.engine import engine as tengine
from llmq_tpu_torch.engine import sampling as tsampling
from llmq_tpu_torch.engine.sampling import SamplingParams as TParams
from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.models.transformer import Transformer
from llmq_tpu_torch.ops.attention import mixed_query_grid as tgrid

from test_torch_model import BASE, _jax_tree, numpy_params

pytestmark = pytest.mark.unit

JCFG = JConfig.tiny(vocab_size=304)
TCFG = TConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
TREE = numpy_params(JCFG, 0)
ENGINE = dict(max_num_seqs=4, max_model_len=64, page_size=8, num_pages=40,
              kv_dtype="f32", min_prefill_bucket=32)


def _jcore(**overrides):
    return jengine.EngineCore(
        JCFG, jax.tree.map(jnp.asarray, TREE), JByteTokenizer(),
        mesh=make_mesh(tensor_parallel=1),
        engine_config=jengine.EngineConfig(**{**ENGINE, **overrides}),
    )


def _tcore(**overrides):
    return tengine.EngineCore(TCFG, params_from_numpy(TREE), ByteTokenizer(), device="cpu",
                              engine_config=tengine.EngineConfig(**{**ENGINE, **overrides}))


def _run(core, requests, params_cls):
    for rid, prompt, kw in requests:
        core.add_request(rid, prompt=prompt, params=params_cls(**{"temperature": 0.0, **kw}))
    outs = {}
    for _ in range(1000):
        for out in core.step():
            outs[out.rid] = out
        if not core.has_work:
            break
    assert set(outs) == {rid for rid, _, _ in requests}, "engine stalled"
    return outs


def _tokens(outs):
    return {rid: (o.token_ids, o.finish_reason) for rid, o in outs.items()}


def _same(jcore, requests, **port_mode):
    """The requests through the JAX engine and the port in its mode: the
    port's outputs (tokens, finish reasons) equal JAX's."""
    tcore = _tcore(**port_mode)
    jout = _tokens(_run(jcore, requests, JParams))
    tout = _tokens(_run(tcore, requests, TParams))
    assert tout == jout
    return tcore, tout


def _dispatch_counts(core, before=None) -> dict:
    """Dispatches recorded by kind (``stats()["dispatch_ms"]``), less
    ``before``'s; kinds that did not move are left out."""
    counts = {kind: v["count"] for kind, v in core.stats()["dispatch_ms"].items()}
    before = before or {}
    return {kind: n - before.get(kind, 0) for kind, n in counts.items()
            if n != before.get(kind, 0)}


def _off(requests, **settings):
    return _tokens(_run(_tcore(**settings), requests, TParams))


GREEDY_SEEDED = [
    ("g", "hello world hello wor", dict(max_tokens=7, ignore_eos=True)),
    ("s", "hello world", dict(temperature=0.8, seed=7, max_tokens=6, ignore_eos=True)),
    ("f", "another one", dict(temperature=0.5, top_k=8, top_p=0.9, seed=3, max_tokens=5,
                              ignore_eos=True)),
]
# Repetitive prompts, so the n-gram drafter finds matches, and a seeded row.
SPEC_MIX = [
    ("g", "hello world hello wor", dict(max_tokens=10, ignore_eos=True)),
    ("rep", "abcabcabcabc", dict(max_tokens=8, ignore_eos=True)),
    ("short", "hi", dict(max_tokens=3, ignore_eos=True)),
    ("s", "abcabcabcab", dict(temperature=0.8, seed=11, max_tokens=8, ignore_eos=True)),
]


def _greedy(outs, requests):
    return {rid: outs[rid] for rid, _, kw in requests if not kw.get("temperature")}


def _stop_requests(companion):
    """A greedy row whose third token is made its stop token, beside
    ``companion`` (a sampled row: the JAX engine then reuses the sampler
    variant it has compiled)."""
    ref = _off([("r", "stop test", dict(max_tokens=8, ignore_eos=True))])["r"][0]
    stop = ("r", "stop test", dict(max_tokens=8, ignore_eos=True, stop_token_ids=(ref[2],)))
    return ref, [stop, companion]


# --- decode_block ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_block4():
    return _jcore(decode_block=4)


def test_decode_block_matches_jax_and_block_one(jax_block4):
    """decode_block=4 (test_engine.py:636): greedy, seeded and top-k /
    top-p rows equal the JAX engine's at K=4 and the port's at K=1."""
    tcore, tout = _same(jax_block4, GREEDY_SEEDED, decode_block=4)
    assert tout == _off(GREEDY_SEEDED)
    st = tcore.stats()
    assert st["decode_block"] == 4
    assert st["decode_dispatches"] <= -(-st["decode_steps"] // 4)


def test_decode_block_mid_block_stop_discards_lagged_tokens(jax_block4):
    """A row that stops at iteration j of a block rides out the rest
    inactive; the host drops those tokens (test_engine.py:664)."""
    ref, reqs = _stop_requests(GREEDY_SEEDED[2])
    _, tout = _same(jax_block4, reqs, decode_block=4)
    assert tout == _off(reqs)
    assert tout["r"] == (ref[:2], "stop")


# --- speculative decoding ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_spec2():
    return _jcore(spec_tokens=2)


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def test_draft_lookup_matches_jax(jax_spec2):
    """The JAX engine's on-device drafter (engine.py:1412), taken from its
    verify step, against the port's on numpy-made repetitive histories."""
    jdraft = _closure(_closure(jax_spec2._verify_block_fn)["verify_step"])["draft_lookup"]
    rng = np.random.default_rng(5)
    S, M = 4, 64  # the engine's slots and max_model_len
    history = rng.integers(0, 6, size=(S, M)).astype(np.int32)  # small vocab: many matches
    history[1, :20] = np.tile([7, 8, 9, 10], 5)
    ctx = np.asarray([0, 19, 40, 63], np.int32)
    want = np.asarray(jdraft(jnp.asarray(history), jnp.asarray(ctx)))
    got = tengine.draft_lookup(torch.from_numpy(history), torch.from_numpy(ctx), 2, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()
    for n_draft, n_gram in ((3, 1), (1, 3)):  # the port's other shapes
        got = tengine.draft_lookup(torch.from_numpy(history), torch.from_numpy(ctx),
                                   n_draft, n_gram)
        assert got.shape == (S, n_draft)


@pytest.mark.parametrize("mode", ["greedy", "stochastic", "filtered"])
def test_spec_verify_tokens_matches_jax(mode):
    """Emitted tokens and accepted runs bit-equal to
    ``sampling.spec_verify_tokens`` (sampling.py:200) on numpy-made
    logits, drafts (half of them the argmax, so runs get accepted) and
    threefry keys; greedy rows ride in the sampled batches."""
    rng = np.random.default_rng({"greedy": 0, "stochastic": 1, "filtered": 2}[mode])
    S, Q, V = 6, 4, 257
    logits = (rng.standard_normal((S, Q, V)) * 4).astype(np.float32)  # peaked: drafts accepted
    drafts = rng.integers(0, V, size=(S, Q - 1)).astype(np.int32)
    top = logits[:, :-1].argmax(-1).astype(np.int32)
    drafts = np.where(rng.random((S, Q - 1)) < 0.5, top, drafts)
    drafts[0] = -1  # no draft: position 0 only
    keys = np.stack([np.asarray(jsampling.make_base_key(s, 0)) for s in range(S)])
    steps = rng.integers(0, 50, size=S).astype(np.int32)
    temps = np.asarray([0.0, 0.7, 1.0, 1.3, 0.9, 0.5], np.float32)
    topks = np.asarray([0, 0, 5, 0, 20, 3], np.int32)
    topps = np.asarray([1.0, 1.0, 0.9, 0.8, 1.0, 0.95], np.float32)
    if mode == "stochastic":
        topks[:], topps[:] = 0, 1.0
    args = (logits, drafts, keys, steps, temps, topks, topps)
    jverify = jax.jit(jsampling.spec_verify_tokens, static_argnames="mode")
    want = np.asarray(jverify(*map(jnp.asarray, args), mode=mode))
    t_args = [torch.from_numpy(a.astype(np.int64) if a is keys else a) for a in args]
    got = tsampling.spec_verify_tokens(*t_args, mode=mode).numpy()
    np.testing.assert_array_equal(got, want)

    def runs(emit):
        return np.cumprod(emit[:, :-1] == drafts, axis=1).sum(axis=1)

    np.testing.assert_array_equal(runs(got), runs(want))
    assert runs(want).max() > 0


def test_spec_greedy_matches_jax_and_spec_off(jax_spec2):
    """spec_tokens=2 (test_engine.py:688): greedy and seeded tokens equal
    the JAX engine's in the same mode (the seeded row through rejection
    sampling on the ported threefry stream and its key splits), greedy
    tokens the port's with speculation off, and the stats carry the JAX
    engine's speculation keys."""
    before = _dispatch_counts(jax_spec2)
    tcore, tout = _same(jax_spec2, SPEC_MIX, spec_tokens=2)
    assert _greedy(tout, SPEC_MIX) == _greedy(_off(SPEC_MIX), SPEC_MIX)
    st, jst = tcore.stats(), jax_spec2.stats()
    # Each dispatch kind's recorded count (the "verify" kind) equals JAX's.
    assert _dispatch_counts(tcore) == _dispatch_counts(jax_spec2, before)
    assert set(_dispatch_counts(tcore)) == {"prefill", "verify"}
    assert st["spec_tokens"] == 2 and st["spec_proposed"] > 0
    for key in ("spec_proposed", "spec_accepted", "acceptance_rate"):
        assert st[key] == jst[key], key
    assert st["acceptance_rate"] == pytest.approx(st["spec_accepted"] / st["spec_proposed"])
    assert st["verify_kernel"] == "plain"  # K3's plain version: CPU tensors
    assert len(tcore._dev_state) == 13 and len(_tcore()._dev_state) == 12


def test_spec_stop_token_cuts_accepted_run(jax_spec2):
    """A stop token emitted mid-verify cuts the accepted run there
    (test_engine.py:738)."""
    ref, reqs = _stop_requests(SPEC_MIX[3])
    _, tout = _same(jax_spec2, reqs, spec_tokens=2)
    assert tout["r"] == _off(reqs)["r"] == (ref[:2], "stop")


def test_spec_composes_with_decode_block():
    """spec_tokens=2 with decode_block=2 (test_engine.py:708): greedy
    tokens equal speculation off; two verify iterations a dispatch."""
    tcore = _tcore(spec_tokens=2, decode_block=2)
    out = _tokens(_run(tcore, SPEC_MIX, TParams))
    assert _greedy(out, SPEC_MIX) == _greedy(_off(SPEC_MIX), SPEC_MIX)
    st = tcore.stats()
    assert st["decode_dispatches"] <= -(-st["decode_steps"] // 2)


# --- mixed steps ------------------------------------------------------------------


MIXED = dict(prefill_chunk_size=8, enable_prefix_caching=True, num_pages=20,
             max_num_seqs=6, max_prefill_batch=2)
TEMPLATE = "Summarise the ticket below in one line. "  # 40 byte tokens: 5 pages of 8
MIXED_MIX = [
    (f"p{i}", TEMPLATE + f"ticket {i}: " + "x" * (3 * i), dict(max_tokens=5 + i, ignore_eos=True))
    for i in range(6)
]


@pytest.fixture(scope="module")
def jax_mixed():
    return _jcore(mixed_step="on", decode_block=2, **MIXED)


def test_mixed_steps_match_jax_and_mixed_off(jax_mixed):
    """mixed_step=on with decode_block=2 on a tight pool under the prefix
    cache (test_engine_soak.py:348): greedy tokens equal the JAX engine's
    and the port's with mixed steps off, and the mixed_steps and
    mixed_prefill_tokens counters equal JAX's (:389, :394)."""
    before = _dispatch_counts(jax_mixed)
    tcore, tout = _same(jax_mixed, MIXED_MIX, mixed_step="on", decode_block=2, **MIXED)
    assert tout == _off(MIXED_MIX, decode_block=2, **MIXED)
    st, jst = tcore.stats(), jax_mixed.stats()
    # Each dispatch kind's recorded count ("mixed" among them) equals JAX's.
    assert _dispatch_counts(tcore) == _dispatch_counts(jax_mixed, before)
    assert "mixed" in _dispatch_counts(tcore)
    assert st["mixed_steps"] > 0 and st["mixed_prefill_tokens"] > 0
    for key in ("mixed_steps", "mixed_prefill_tokens", "decode_steps", "decode_dispatches",
                "prefill_tokens"):
        assert st[key] == jst[key], key
    assert st["mixed_kernel"] == "plain" and st["mixed_step"] == "on"


def test_mixed_composes_with_spec_and_decode_block():
    """Mixed steps, speculation and decode blocks together
    (test_engine_soak.py:348's composition): greedy tokens equal the
    port with all three off."""
    tcore = _tcore(mixed_step="on", decode_block=2, spec_tokens=2, **MIXED)
    assert _tokens(_run(tcore, MIXED_MIX, TParams)) == _off(MIXED_MIX, **MIXED)
    assert tcore.stats()["mixed_steps"] > 0


def test_mixed_step_config_and_env_pin(monkeypatch):
    """As in JAX: mixed steps need chunked prefill, LLMQ_MIXED_STEP pins
    over the config, the fields are checked, and interactive_decode_block
    (refused until M11 was ported) resolves as the JAX engine resolves it:
    the config's value, LLMQ_INTERACTIVE_DECODE_BLOCK over it, 0 with the
    priority classes off."""
    with pytest.raises(ValueError, match="prefill_chunk_size"):
        _tcore(mixed_step="on")
    monkeypatch.setenv("LLMQ_MIXED_STEP", "off")
    assert _tcore(prefill_chunk_size=8, mixed_step="on").mixed_step == "off"
    monkeypatch.setenv("LLMQ_MIXED_STEP", "on")
    assert _tcore(prefill_chunk_size=8).mixed_step == "on"
    monkeypatch.delenv("LLMQ_MIXED_STEP")
    for bad in (dict(decode_block=0), dict(spec_tokens=-1), dict(spec_ngram=0),
                dict(mixed_step="maybe"), dict(interactive_decode_block=-1)):
        with pytest.raises(ValueError):
            tengine.EngineConfig(**bad)
        with pytest.raises(ValueError):
            jengine.EngineConfig(**bad)
    assert _tcore().interactive_decode_block == 0
    assert _tcore(decode_block=4, interactive_decode_block=2).interactive_decode_block == 2
    monkeypatch.setenv("LLMQ_INTERACTIVE_DECODE_BLOCK", "1")
    assert _tcore(decode_block=4, interactive_decode_block=2).interactive_decode_block == 1
    monkeypatch.setenv("LLMQ_PRIORITY_CLASSES", "0")
    assert _tcore(decode_block=4).interactive_decode_block == 0


# --- the model's verify and mixed forwards ----------------------------------------


def test_verify_and_mixed_logits_match_jax():
    """``Transformer.verify`` (Q candidates a slot, every position's
    logits) and ``Transformer.mixed`` (decode rows plus a piggy segment in
    one [S, C] grid from ``mixed_query_grid``) within 1e-4 of JAX's, the
    pools within 1e-5, over a cache of numpy-made K/V."""
    kw = {**BASE, "model_type": "qwen2", "attention_bias": True}
    jcfg, tcfg = JConfig.tiny(**kw), TConfig.tiny(**kw)
    tree = _jax_tree(jcfg, seed=4)
    model, jm = Transformer(tcfg, params_from_numpy(tree)), JTransformer(jcfg, attn_backend="xla")
    jparams = jax.tree.map(jnp.asarray, tree)
    S, C, page, P = 4, 8, 8, 24
    rng = np.random.default_rng(9)
    bt = (1 + np.arange(S * 5, dtype=np.int32)).reshape(S, 5)
    shape = tuple(jpages(jcfg, P, page, jnp.float32)[0].shape)
    pools = [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in "kv"]
    jk, jv = map(jnp.asarray, pools)
    tk, tv = (torch.from_numpy(p.copy()) for p in pools)
    ctx = np.asarray([10, 3, 0, 17], np.int32)

    def check(jl, tl, rows):
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], rtol=1e-5, atol=1e-5)

    Q = 3
    active = np.asarray([True, True, False, True])
    qtok = rng.integers(1, kw["vocab_size"], size=(S, Q)).astype(np.int32)
    qpos = np.where(active[:, None], ctx[:, None] + np.arange(Q), -1).astype(np.int32)
    jl, jk, jv = jax.jit(jm.verify)(jparams, jnp.asarray(qtok), jnp.asarray(qpos), jk, jv,
                                    jnp.asarray(bt))
    tl = model.verify(torch.from_numpy(qtok), torch.from_numpy(qpos), tk, tv, torch.from_numpy(bt))
    check(jl, tl, active)

    ctx2 = np.where(active, ctx + Q, 0).astype(np.int32)
    tokens = rng.integers(1, kw["vocab_size"], size=S).astype(np.int32)
    seg_tok = rng.integers(1, kw["vocab_size"], size=C).astype(np.int32)
    seg_pos = np.full(C, -1, np.int32)
    seg_pos[:5] = np.arange(5)  # the piggy (slot 2, inactive) prefills 0..4
    grid_args = (tokens, ctx2, active, seg_tok, seg_pos)
    jq = jgrid(*map(jnp.asarray, grid_args), jnp.int32(2), 40)
    tq = tgrid(*map(torch.from_numpy, grid_args), torch.tensor(2), 40)
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    gather = np.where(np.asarray(jq[2]), 4, 0).astype(np.int32)
    jl, jk, jv = jax.jit(jm.mixed)(jparams, jq[0], jq[1], jk, jv, jnp.asarray(bt),
                                   jnp.asarray(gather))
    tl = model.mixed(tq[0], tq[1], tk, tv, torch.from_numpy(bt), torch.from_numpy(gather))
    check(jl, tl, np.ones(S, bool))
