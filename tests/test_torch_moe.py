"""The port's mixture-of-experts serving (qwen2_moe / qwen3_moe) against
the JAX package, on the CPU in f32.

Inputs and weights are made with numpy (``test_torch_model.numpy_params``,
JAX's tree layout) and carried to torch by ``params_from_numpy``.

- The module: ``_moe_mlp`` in both of its forms (grouped for the prefill
  paths, sync-free for the captured decode-type dispatches) within 2e-5
  of JAX ``_moe_mlp``, plain and with int8 / int4 expert stacks, for
  qwen2_moe (shared expert, no renorm) and qwen3_moe (renorm, no shared
  expert); a router with exact ties picks what ``lax.top_k`` picks.
- The trees: ``quantize_params`` of an MoE tree equals JAX's bit for bit.
- The engine: greedy requests through ``EngineCore`` give the JAX
  engine's tokens (one JAX engine for the file), on the plain decode
  path and with mixed steps and speculative verify blocks.
- The loader: tiny HF Qwen2MoE / Qwen3MoE checkpoints written offline
  load into JAX's tree bit for bit (and the same load ledger), and the
  port's logits match HF's within 1e-4.

The whole-model logits of ``__graft_entry__._moe_tiny`` and a qwen3_moe
tiny are held in ``tests/test_torch_model.py::test_prefill_and_decode_match_jax``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _moe_tiny
from llmq_tpu.models import presets as jpresets
from llmq_tpu.models import quant as jq
from llmq_tpu.models import transformer as jt
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu_torch.models import presets as tpresets
from llmq_tpu_torch.models import quant as tq
from llmq_tpu_torch.models import transformer as tt
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models.convert import params_from_numpy

from test_torch_model import BASE, FAMILIES, _as_dict, numpy_params

pytestmark = pytest.mark.unit

MOE = ("qwen2_moe", "qwen3_moe")


def _configs(family):
    kw = {**BASE, **FAMILIES[family]}
    return JConfig.tiny(**kw), TConfig.tiny(**kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _assert_same_tree(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert sorted(got) == sorted(ref)
    for name, t in got.items():
        assert (t.dtype, t.shape) == (ref[name].dtype, ref[name].shape), name
        assert np.array_equal(_bits(t), _bits(ref[name])), name


def test_moe_configs_and_presets_match_jax():
    assert _as_dict(TConfig.tiny(**{**BASE, **FAMILIES["qwen2_moe"]})) == _as_dict(_moe_tiny())
    preset = tpresets.get_preset("qwen1.5-moe-a2.7b")
    assert _as_dict(preset) == _as_dict(jpresets.get_preset("qwen1.5-moe-a2.7b"))
    assert (preset.num_layers, preset.hidden_size, preset.num_heads, preset.num_kv_heads,
            preset.num_experts, preset.num_experts_per_tok, preset.moe_intermediate_size,
            preset.shared_expert_intermediate_size) == (24, 2048, 16, 16, 60, 4, 1408, 5632)
    for name in ("qwen1.5-moe-a2.7b",) + MOE:
        t = preset if name not in MOE else _configs(name)[1]
        j = jpresets.get_preset(name) if name not in MOE else _configs(name)[0]
        assert (t.num_params(), t.active_params_per_token()) == (
            j.num_params(), j.active_params_per_token())
    assert 14.0e9 < preset.num_params() < 14.6e9
    hf = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 96,
          "num_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
          "shared_expert_intermediate_size": 48, "norm_topk_prob": True, "head_dim": 16}
    for mt in MOE:
        t = TConfig.from_hf_config({**hf, "model_type": mt})
        assert _as_dict(t) == _as_dict(JConfig.from_hf_config({**hf, "model_type": mt}))
        assert t.qk_norm == (mt == "qwen3_moe") and t.attention_bias == (mt == "qwen2_moe")
        assert t.shared_expert_intermediate_size == (48 if mt == "qwen2_moe" else None)
        assert t.norm_topk_prob
        for cls in (TConfig, JConfig):
            with pytest.raises(ValueError, match="interleaved"):
                cls.from_hf_config({**hf, "model_type": mt, "decoder_sparse_step": 2})


def _layer(tree, bits):
    """Layer 0 of ``tree`` (quantized by the port's ``quantize_params``
    first, whose trees equal JAX's) as numpy leaves."""
    if bits:
        tree = jax.tree.map(lambda t: t.numpy(),
                            tq.quantize_params(params_from_numpy(tree), bits=bits))
    return jax.tree.map(lambda a: a[0], tree["layers"])


@functools.lru_cache(maxsize=None)
def _module_case(family, bits):
    """(port config, layer-0 numpy leaves, x, JAX ``_moe_mlp`` of x)."""
    jcfg, tcfg = _configs(family)
    lp = _layer(numpy_params(jcfg, seed=3), bits)
    x = np.random.default_rng(4).standard_normal((9, jcfg.hidden_size)).astype(np.float32)
    ref = jt._moe_mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, lp), jcfg)
    return tcfg, lp, x, np.asarray(ref)


@pytest.mark.parametrize("sync_free", [False, True], ids=["grouped", "sync_free"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["f32", "int8", "int4"])
@pytest.mark.parametrize("family", MOE)
def test_moe_mlp_matches_jax(family, bits, sync_free):
    tcfg, lp, x, ref = _module_case(family, bits)
    got = tt._moe_mlp(torch.from_numpy(x), params_from_numpy(lp), tcfg, frozenset(), sync_free)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_top_k_takes_the_lower_expert_on_a_tie():
    """``lax.top_k([1, 3, 3, 0, 3], 2)`` gives [1, 2]; so does the port's
    routing, for logits that tie exactly."""
    cfg = TConfig.tiny(num_experts=5, num_experts_per_tok=2, moe_intermediate_size=8,
                       model_type="qwen3_moe")
    router = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])  # x = [1]: the logits are the row
    _, top_e = tt.moe_route(torch.ones((1, 1)), router, cfg)
    _, jtop = jax.lax.top_k(jnp.asarray([1.0, 3.0, 3.0, 0.0, 3.0]), 2)
    assert top_e.tolist() == [[1, 2]] == [np.asarray(jtop).tolist()]


@pytest.mark.parametrize("family", MOE)
def test_router_ties_pick_as_lax_top_k(family):
    """A router whose expert columns 1, 2, 4 and 6 are equal (so every row's
    logits tie among them): the port picks JAX's experts, weights and
    output."""
    jcfg, tcfg = _configs(family)
    lp = _layer(numpy_params(jcfg, seed=5), None)
    router = lp["router"].copy()
    router[:, [2, 4, 6]] = router[:, [1]]
    lp["router"] = router
    x = np.random.default_rng(6).standard_normal((12, jcfg.hidden_size)).astype(np.float32)
    x[:4] = 0.0  # every logit equal: the lowest ids win
    logits = jnp.asarray(x) @ jnp.asarray(router)
    jw, je = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), axis=-1),
                           jcfg.num_experts_per_tok)
    tw, te = tt.moe_route(torch.from_numpy(x), torch.from_numpy(router), tcfg)
    if jcfg.norm_topk_prob:
        jw = jw / jnp.sum(jw, axis=-1, keepdims=True)
    assert te.tolist() == np.asarray(je).tolist()
    assert te[:4].tolist() == [list(range(jcfg.num_experts_per_tok))] * 4
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    ref = np.asarray(jt._moe_mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, lp), jcfg))
    for sync_free in (False, True):
        got = tt._moe_mlp(torch.from_numpy(x), params_from_numpy(lp), tcfg, frozenset(),
                          sync_free)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rows", [1, 3, 40])
def test_sync_free_form_equals_the_grouped_form(rows):
    """One row, a few rows, and more rows than experts (every expert
    used), plain and bf16: the two forms agree to f32 rounding (bf16: to
    one rounding of the output)."""
    jcfg, tcfg = _configs("qwen2_moe")
    lp = params_from_numpy(_layer(numpy_params(jcfg, seed=rows), None))
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, jcfg.hidden_size)).astype(np.float32))
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        lpd = {n: t.to(dtype) for n, t in lp.items()}
        a = tt._moe_mlp(x.to(dtype), lpd, tcfg, frozenset(), False)
        b = tt._moe_mlp(x.to(dtype), lpd, tcfg, frozenset(), True)
        assert a.dtype == b.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("family,bits", [("qwen2_moe", 8), ("qwen3_moe", 4)])
def test_quantize_params_of_an_moe_tree_equals_jax(family, bits):
    jcfg, _ = _configs(family)
    tree = numpy_params(jcfg, seed=7, dtype=jnp.bfloat16)
    ref = jq.quantize_params(jax.tree.map(jnp.asarray, tree), scale_dtype=jnp.bfloat16,
                             bits=bits)
    got = tq.quantize_params(params_from_numpy(tree), scale_dtype=torch.bfloat16, bits=bits)
    _assert_same_tree(got, params_from_numpy(jax.tree.map(np.asarray, ref)))
    for name in ("router",) + (("shared_expert_gate",) if family == "qwen2_moe" else ()):
        assert got["layers"][name].dtype == torch.bfloat16  # stays in the compute dtype
    assert got["layers"]["expert_down_proj"]["q"].dim() == 4
    deq = tq.dequantize(got["layers"]["expert_gate_proj"], torch.float32)
    ref_deq = jq.dequantize(ref["layers"]["expert_gate_proj"], jnp.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(ref_deq))


# --- the engine ------------------------------------------------------------------

ENGINE = dict(max_num_seqs=4, max_model_len=64, page_size=8, num_pages=40, kv_dtype="f32",
              min_prefill_bucket=32)
REQUESTS = [(f"m{i}", f"expert {i} " * (1 + i % 3), dict(max_tokens=5 + i, ignore_eos=True))
            for i in range(5)]  # more requests than the 4 slots
PORT_MODES = {
    "decode": {},
    "mixed": dict(mixed_step="on", prefill_chunk_size=16),
    "spec": dict(spec_tokens=2),
}


def _run(core, params_cls):
    for rid, prompt, kw in REQUESTS:
        core.add_request(rid, prompt=prompt, params=params_cls(temperature=0.0, **kw))
    outs = {}
    for _ in range(500):
        outs.update({o.rid: o.token_ids for o in core.step()})
        if not core.has_work:
            break
    assert len(outs) == len(REQUESTS), "engine stalled"
    return outs


@pytest.fixture(scope="module")
def jax_serve():
    """The JAX engine's greedy tokens for ``REQUESTS`` on ``_moe_tiny``."""
    from llmq_tpu.engine import engine as jengine
    from llmq_tpu.engine.sampling import SamplingParams
    from llmq_tpu.engine.tokenizer import ByteTokenizer
    from llmq_tpu.parallel import make_mesh

    jcfg = _moe_tiny()
    tree = numpy_params(jcfg, seed=11)
    core = jengine.EngineCore(jcfg, jax.tree.map(jnp.asarray, tree), ByteTokenizer(),
                              mesh=make_mesh(tensor_parallel=1),
                              engine_config=jengine.EngineConfig(**ENGINE))
    return tree, _run(core, SamplingParams)


@pytest.mark.parametrize("mode", list(PORT_MODES))
def test_engine_greedy_tokens_match_the_jax_engine(jax_serve, mode):
    from llmq_tpu_torch.engine.engine import EngineConfig, EngineCore
    from llmq_tpu_torch.engine.sampling import SamplingParams
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    tree, ref = jax_serve
    cfg = TConfig(**{f.name: getattr(_moe_tiny(), f.name)
                     for f in dataclasses.fields(_moe_tiny())})
    core = EngineCore(cfg, params_from_numpy(tree), ByteTokenizer(),
                      engine_config=EngineConfig(**{**ENGINE, **PORT_MODES[mode]}),
                      device="cpu")
    assert _run(core, SamplingParams) == ref
    st = core.stats()
    if mode == "decode":  # reported as a dense model's engine is
        dense = EngineCore(TConfig.tiny(vocab_size=320), tt.init_params(
            TConfig.tiny(vocab_size=320), torch.Generator().manual_seed(0)), ByteTokenizer(),
            engine_config=EngineConfig(**ENGINE), device="cpu")
        _run(dense, SamplingParams)
        assert sorted(st) == sorted(dense.stats())
        assert st["decode_dispatches"] > 0 and st["generated_tokens"] == sum(map(len, ref.values()))
    if mode == "mixed":
        assert st["mixed_steps"] > 0
    if mode == "spec":
        assert st["spec_proposed"] > 0


# --- the loader ------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_moe(tmp_path_factory):
    """Tiny random HF Qwen2MoE and Qwen3MoE checkpoints, saved offline:
    {family: (directory, model)}."""
    with pytest.MonkeyPatch.context() as mp:  # no TensorFlow import (~8 s on one core)
        mp.setenv("USE_TF", "0")
        transformers = pytest.importorskip("transformers")
    out = {}
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                  tie_word_embeddings=False, rope_theta=10000.0, num_experts=8,
                  num_experts_per_tok=2, moe_intermediate_size=32, decoder_sparse_step=1,
                  mlp_only_layers=[])
    torch.manual_seed(0)
    for family, cls, extra in (
        ("qwen2_moe", "Qwen2Moe", dict(shared_expert_intermediate_size=48,
                                       norm_topk_prob=False)),
        ("qwen3_moe", "Qwen3Moe", dict(head_dim=16, norm_topk_prob=True)),
    ):
        hf_cfg = getattr(transformers, f"{cls}Config")(**common, **extra)
        model = getattr(transformers, f"{cls}ForCausalLM")(hf_cfg).eval().to(torch.float32)
        with torch.no_grad():  # norms and biases off their init, so they count
            for name, p in model.named_parameters():
                if "norm" in name or name.endswith("bias"):
                    p.add_(0.1 * torch.randn_like(p))
        path = tmp_path_factory.mktemp("hf") / family
        model.save_pretrained(path, safe_serialization=True)
        out[family] = (path, model)
    return out


@pytest.mark.parametrize("family,dtype,quantize", [
    ("qwen2_moe", "float32", False), ("qwen3_moe", "float32", False),
    ("qwen2_moe", "bfloat16", "int8"), ("qwen3_moe", "bfloat16", "int4")])
def test_load_moe_checkpoint_matches_the_jax_loader(hf_moe, family, dtype, quantize):
    from llmq_tpu.engine.weights import load_checkpoint as jax_load
    from llmq_tpu_torch.engine.weights import load_checkpoint

    path = hf_moe[family][0]
    ref_ledger, got_ledger = {}, {}
    ref = jax_load(path, dtype=getattr(jnp, dtype), quantize=quantize,
                   checksum_ledger=ref_ledger)
    got = load_checkpoint(path, dtype=getattr(torch, dtype), device="cpu", quantize=quantize,
                          checksum_ledger=got_ledger)
    _assert_same_tree(got, params_from_numpy(jax.tree.map(np.asarray, ref)))
    assert got_ledger == ref_ledger
    assert "layers.expert_down_proj" + (".q" if quantize else "") in got_ledger
    assert ("layers.shared_expert_gate" in got_ledger) == (family == "qwen2_moe")


@pytest.mark.parametrize("family", MOE)
def test_loaded_moe_logits_match_hf(hf_moe, family):
    """Prefill logits at every prompt length of a ragged batch, and one
    decode step, against HF's forward over the same tokens."""
    from llmq_tpu_torch.engine.weights import load_checkpoint

    path, hf_model = hf_moe[family]
    cfg = TConfig.from_pretrained(path)
    model = tt.Transformer(cfg, load_checkpoint(path, cfg, dtype=torch.float32, device="cpu"))
    rng = np.random.default_rng(0)
    T, lengths = 21, [21, 14]
    tokens = rng.integers(0, cfg.vocab_size, size=(2, T + 1))
    with torch.no_grad():
        hf = hf_model(torch.from_numpy(tokens)).logits.numpy()
    k, v = tt.make_kv_pages(cfg, 9, 8, torch.float32)
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    padded = torch.zeros((2, 24), dtype=torch.int32)
    padded[0, :21] = torch.from_numpy(tokens[0, :21])
    padded[1, :14] = torch.from_numpy(tokens[1, :14])
    lens = torch.tensor(lengths, dtype=torch.int32)
    ours = model.prefill(padded, lens, k, v, bt)
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(ours[row].numpy(), hf[row, n - 1], rtol=1e-4, atol=1e-4)
    nxt = torch.tensor([tokens[0, 21], tokens[1, 14]], dtype=torch.int32)
    ours = model.decode(nxt, lens, k, v, bt, torch.tensor([True, True]))
    np.testing.assert_allclose(ours[0].numpy(), hf[0, 21], rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        hf1 = hf_model(torch.from_numpy(tokens[1:, :15])).logits.numpy()
    np.testing.assert_allclose(ours[1].numpy(), hf1[0, 14], rtol=1e-4, atol=1e-4)


def test_moe_transient_is_kept_out_of_the_kv_pool():
    """The per-layer transient the pool sizing reserves: the dequantized
    stacks at int8 (~1.04 GB at qwen1.5-moe-a2.7b's widths) and the
    [E, rows, *] products at the widest captured dispatch."""
    from llmq_tpu_torch.engine.engine import EngineConfig, EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    preset = tpresets.get_preset("qwen1.5-moe-a2.7b")
    stacks = 3 * 60 * 2048 * 1408 * 2
    assert tt.moe_transient_bytes(preset, torch.bfloat16, 16, True) == (
        stacks + 60 * 16 * (2 * 2048 + 3 * 1408) * 2)
    assert tt.moe_transient_bytes(preset, torch.bfloat16, 16, False) == 60 * 16 * 8320 * 2
    assert tt.moe_transient_bytes(tpresets.get_preset("qwen2.5-3b"), torch.bfloat16, 16,
                                  True) == 0
    _, tcfg = _configs("qwen3_moe")
    tree = tq.quantize_params(params_from_numpy(numpy_params(_configs("qwen3_moe")[0], 1)))
    for fields, rows in (({}, 4), (dict(spec_tokens=3), 16),
                         (dict(mixed_step="on", prefill_chunk_size=16), 64)):
        core = EngineCore(tcfg, tree, ByteTokenizer(), device="cpu",
                          engine_config=EngineConfig(**{**ENGINE, **fields}))
        assert core._moe_transient_bytes() == tt.moe_transient_bytes(tcfg, torch.float32, rows,
                                                                     True)


def test_weight_audit_and_canary_cover_the_expert_leaves(monkeypatch):
    """The digests of an int8 MoE tree equal JAX's leaf for leaf; the
    engine's audit names a flipped byte of one expert's int8 codes, and
    its canary replays bit for bit on intact weights."""
    from llmq_tpu.engine import integrity as jint
    from llmq_tpu_torch.engine import integrity as tint
    from llmq_tpu_torch.engine.engine import EngineConfig, EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    jcfg, tcfg = _configs("qwen2_moe")
    tree = jax.tree.map(lambda t: t.numpy(),
                        tq.quantize_params(params_from_numpy(numpy_params(jcfg, 2))))
    want = jint.digest_params(jax.tree.map(jnp.asarray, tree))
    assert "['layers']['expert_down_proj']['q']" in want and "['layers']['router']" in want
    core = EngineCore(tcfg, params_from_numpy(tree), ByteTokenizer(), device="cpu",
                      engine_config=EngineConfig(max_num_seqs=2, max_model_len=64,
                                                 weight_audit_every=1e6, canary_every=1e6))
    assert tint.digest_params(core.params) == want
    assert core.audit_weights() == [] and core.run_canary()
    with torch.no_grad():
        core.params["layers"]["expert_down_proj"]["q"][1, 3].view(-1)[5] ^= 0x10
    assert core.audit_weights() == ["['layers']['expert_down_proj']['q']"]


def test_worker_serves_an_moe_checkpoint_written_as_the_smoke_writes_it(tmp_path, monkeypatch):
    """``chip_smoke.write_hf_checkpoint`` (one tensor per expert) and
    ``write_text_tokenizer`` on a tiny qwen2_moe tree: the port's loader
    and the JAX loader both read the tree back bit for bit, and
    ``run_torch_worker(CHECKPOINT)`` (``build_engine``, no new option)
    serves jobs over memory:// with an engine's tokens on the loaded tree."""
    import asyncio
    import json

    pytest.importorskip("tokenizers")
    monkeypatch.setenv("USE_TF", "0")  # the HF tokenizer: no TensorFlow import
    import chip_smoke
    from llmq_tpu.engine.weights import load_checkpoint as jax_load
    from llmq_tpu_torch.broker.base import make_broker
    from llmq_tpu_torch.broker.memory import reset_namespace
    from llmq_tpu_torch.cli.worker import build_engine, run_torch_worker
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.engine.sampling import SamplingParams
    from llmq_tpu_torch.engine.weights import load_checkpoint

    jcfg, tcfg = _configs("qwen2_moe")
    tree = params_from_numpy(numpy_params(jcfg, seed=9))
    path = tmp_path / "moe"
    path.mkdir()
    chip_smoke.write_hf_checkpoint(tcfg, tree, str(path))
    chip_smoke.write_text_tokenizer(str(path), tcfg.vocab_size)
    assert _as_dict(TConfig.from_pretrained(path)) == _as_dict(dataclasses.replace(
        tcfg, eos_token_ids=(), max_position_embeddings=tcfg.max_position_embeddings))
    _assert_same_tree(load_checkpoint(path, dtype=torch.float32, device="cpu"), tree)
    _assert_same_tree(params_from_numpy(jax.tree.map(np.asarray, jax_load(path, dtype=jnp.float32))),
                      tree)

    url, queue = "memory://torch-moe-ckpt", "moe"
    reset_namespace(url.split("://")[1])
    jobs = [Job(id=f"j{i}", prompt=f"expert {i} " * (i + 1), temperature=0.0, max_tokens=4 + i,
                ignore_eos=True) for i in range(3)]

    async def submit():
        broker = make_broker(url)
        await broker.connect()
        for j in jobs:
            await broker.publish(queue, j.model_dump_json().encode())
        await broker.close()

    async def drain():
        broker = make_broker(url)
        await broker.connect()
        out = []
        while (msg := await broker.get(queue + ".results")) is not None:
            out.append(json.loads(msg.body))
            await msg.ack()
        await broker.close()
        return out

    asyncio.run(submit())
    kw = dict(device="cpu", dtype="float32", max_num_seqs=4, max_model_len=64)
    worker = run_torch_worker(str(path), queue, broker_url=url, max_jobs=len(jobs), **kw)
    assert worker.jobs_processed == len(jobs)
    results = {r["id"]: r for r in asyncio.run(drain())}
    reference = build_engine(str(path), **kw)
    try:
        for j in jobs:
            expect = reference.generate_sync(
                rid=j.id, prompt=j.prompt, timeout=60,
                params=SamplingParams(temperature=0.0, max_tokens=j.max_tokens,
                                      ignore_eos=True))
            assert results[j.id]["usage"]["completion_tokens"] == j.max_tokens
            assert results[j.id]["result"] == expect.text
    finally:
        reference.shutdown()
