"""Port model (config, presets, parameter bridge, dense forward) against
the JAX reference.

One parameter tree in the layout of JAX ``init_params``, made with numpy
and with its norm weights and biases perturbed so those paths matter, is
carried to torch by ``params_from_numpy`` (bit-exact). Prefill and decode logits must agree within 1e-4 and the KV
pools within 1e-5 (f32, every page but the scratch page 0), over tiny
qwen2 / llama (llama3 RoPE scaling) / mistral (sliding window) / qwen3
(qk-norm) / gemma2 (softcaps, pattern-2 window, post-norms, scaled
embeddings) / qwen2_moe (``__graft_entry__._moe_tiny``: routed experts
and a shared expert) / qwen3_moe (renormed top-k, qk-norm) configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmq_tpu.models import presets as jpresets
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.models.transformer import Transformer as JTransformer
from llmq_tpu.models.transformer import init_params as jinit
from llmq_tpu.models.transformer import make_kv_pages as jpages
from llmq_tpu_torch.models import presets as tpresets
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.models.transformer import Transformer, init_params, make_kv_pages

pytestmark = pytest.mark.unit

BASE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=96, eos_token_ids=(0,))
FAMILIES = {
    "qwen2": dict(model_type="qwen2", attention_bias=True, rope_theta=1e6),
    "llama": dict(model_type="llama", rope_theta=5e5, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
    "mistral": dict(model_type="mistral", sliding_window=6),
    "qwen3": dict(model_type="qwen3", qk_norm=True, head_dim=32),
    "gemma2": dict(model_type="gemma2", activation="gelu_tanh", scale_embeddings=True,
                   logit_softcap=30.0, attn_softcap=50.0, post_norms=True,
                   sliding_window=5, sliding_window_pattern=2, head_dim=32,
                   query_pre_attn_scalar=24, tie_word_embeddings=True),
    # ``__graft_entry__._moe_tiny`` (tests/test_torch_moe.py pins it): shared
    # expert, no renorm.
    "qwen2_moe": dict(model_type="qwen2_moe", attention_bias=True, vocab_size=512,
                      hidden_size=128, num_heads=8, num_kv_heads=4, intermediate_size=256,
                      num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
                      shared_expert_intermediate_size=96),
    "qwen3_moe": dict(model_type="qwen3_moe", qk_norm=True, head_dim=32, num_experts=8,
                      num_experts_per_tok=3, moe_intermediate_size=48, norm_topk_prob=True),
}


def _as_dict(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_model_config_matches_jax_field_for_field():
    assert [f.name for f in dataclasses.fields(TConfig)] == [
        f.name for f in dataclasses.fields(JConfig)
    ]
    assert sorted(tpresets.PRESETS) == sorted(jpresets.PRESETS)
    for name in jpresets.PRESETS:
        assert _as_dict(tpresets.get_preset(name)) == _as_dict(jpresets.get_preset(name))
    for fam, kw in FAMILIES.items():
        t, j = TConfig.tiny(**{**BASE, **kw}), JConfig.tiny(**{**BASE, **kw})
        assert _as_dict(t) == _as_dict(j), fam
        assert (t.head_dim_, t.attn_scale) == (j.head_dim_, j.attn_scale)
        assert [t.layer_uses_sliding_window(i) for i in range(4)] == [
            j.layer_uses_sliding_window(i) for i in range(4)
        ]
    hf = {"model_type": "gemma2", "vocab_size": 256, "hidden_size": 64,
          "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
          "intermediate_size": 96, "head_dim": 16, "eos_token_id": [1, 107],
          "query_pre_attn_scalar": 16}
    for mt in ("llama", "mistral", "qwen2", "qwen3", "gemma2"):
        assert _as_dict(TConfig.from_hf_config({**hf, "model_type": mt})) == _as_dict(
            JConfig.from_hf_config({**hf, "model_type": mt})
        )


def numpy_params(cfg: JConfig, seed: int, dtype=jnp.float32) -> dict:
    """A tree in the layout of JAX ``init_params`` (from ``jax.eval_shape``),
    filled with numpy as ``init_params`` fills it: weights N(0, 1/fan_in),
    norms 1, biases 0. Eager ``jax.random`` draws would cost seconds of
    compiles per config on one core."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: jinit(cfg, key, dtype=dtype), jax.random.key(0))

    def fill(path, leaf):
        name = path[-1].key
        if "norm" in name or name in ("ln1", "ln2"):
            return np.ones(leaf.shape, leaf.dtype)
        if "bias" in name:
            return np.zeros(leaf.shape, leaf.dtype)
        fan_in = leaf.shape[-1] if name == "embed" else leaf.shape[-2]
        w = rng.standard_normal(leaf.shape, dtype=np.float32) / np.float32(np.sqrt(fan_in))
        return w.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_tree(cfg: JConfig, seed: int) -> dict:
    """``numpy_params`` with norms and biases perturbed (they start at
    1 / 0, which would leave the bias paths untested). Gemma's norms
    multiply by ``1 + w``, so its norm weights sit near 0 as in real
    checkpoints."""
    tree = numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    center = 0.0 if cfg.model_type.startswith("gemma") else 1.0

    def jitter(leaf, base):
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)

    for name, leaf in tree["layers"].items():
        if "bias" in name:
            tree["layers"][name] = jitter(leaf, 0.0)
        elif "norm" in name or name in ("ln1", "ln2"):
            tree["layers"][name] = jitter(leaf, center)
    tree["final_norm"] = jitter(tree["final_norm"], center)
    return tree


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_params_from_numpy_is_bit_exact(dtype):
    cfg = JConfig.tiny(**{**BASE, **FAMILIES["qwen2"]})
    tree = numpy_params(cfg, seed=1, dtype=dtype)
    ours = params_from_numpy(tree)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat_j:
        t = ours
        for key in path:
            t = t[key.key]
        expect = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
        assert t.dtype == expect and tuple(t.shape) == leaf.shape
        bits = np.uint16 if dtype == jnp.bfloat16 else np.uint32
        ours_bits = t.view(torch.int16 if bits is np.uint16 else torch.int32).numpy()
        np.testing.assert_array_equal(ours_bits.view(bits), leaf.view(bits))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_match_jax(family):
    kw = {**BASE, **FAMILIES[family]}
    jcfg, tcfg = JConfig.tiny(**kw), TConfig.tiny(**kw)
    tree = _jax_tree(jcfg, seed=len(family))
    jparams = jax.tree.map(jnp.asarray, tree)
    model = Transformer(tcfg, params_from_numpy(tree))
    jm = JTransformer(jcfg, attn_backend="xla")

    B, page, P = 3, 8, 16
    rng = np.random.default_rng(7)
    # Page-aligned bucket (page writes) for the qwen2/llama/qwen3 rows,
    # a ragged bucket (token writes) for the others.
    T = 16 if family in ("qwen2", "llama", "qwen3") else 13
    lengths = np.asarray([T, 9, 4], np.int32)
    tokens = rng.integers(1, kw["vocab_size"], size=(B, T)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)

    jk, jv = jpages(jcfg, P, page, jnp.float32)
    tk, tv = make_kv_pages(tcfg, P, page, torch.float32)
    jl, jk, jv = jm.prefill(jparams, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv,
                            jnp.asarray(bt))
    tl = model.prefill(torch.from_numpy(tokens), torch.from_numpy(lengths), tk, tv,
                       torch.from_numpy(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], rtol=1e-5, atol=1e-5)

    # A decode step with one slot inactive (it writes only scratch page 0).
    toks = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    active = np.asarray([True, False, True])
    jl, jk, jv = jm.decode(jparams, jnp.asarray(toks), jnp.asarray(lengths), jk, jv,
                           jnp.asarray(bt), jnp.asarray(active))
    tl = model.decode(torch.from_numpy(toks), torch.from_numpy(lengths), tk, tv,
                      torch.from_numpy(bt), torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], rtol=1e-5, atol=1e-5)


def test_init_params_tree_matches_jax_layout():
    cfg = TConfig.tiny(**{**BASE, **FAMILIES["gemma2"]})
    ours = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    theirs = jax.eval_shape(lambda key: jinit(JConfig.tiny(**{**BASE, **FAMILIES["gemma2"]}),
                                              key, dtype=jnp.bfloat16), jax.random.key(0))
    assert set(ours) == set(theirs) and set(ours["layers"]) == set(theirs["layers"])
    for name, leaf in theirs["layers"].items():
        assert tuple(ours["layers"][name].shape) == leaf.shape
        assert ours["layers"][name].dtype == torch.bfloat16
    same = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    assert torch.equal(ours["embed"], same["embed"])  # seeded: reproducible


def test_moe_config_raises():
    """An MoE config no longer raises: it builds (JAX's tree, int8 too) and
    a prefill and a decode step run to finite logits."""
    cfg = TConfig.tiny(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
                       model_type="qwen2_moe", shared_expert_intermediate_size=48)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    theirs = jax.eval_shape(lambda key: jinit(JConfig.tiny(**_as_dict(cfg)), key),
                            jax.random.key(0))
    assert {n: tuple(t.shape) for n, t in params["layers"].items()} == {
        n: leaf.shape for n, leaf in theirs["layers"].items()}
    quant = init_params(cfg, torch.Generator().manual_seed(0), quantize="int8")
    assert quant["layers"]["expert_up_proj"]["scale"].shape == (2, 4, 32)
    assert quant["layers"]["router"].dtype == torch.float32
    for tree in (params, quant):
        model = Transformer(cfg, tree)
        k, v = make_kv_pages(cfg, 8, 8, torch.float32)
        bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        lengths = torch.tensor([5, 3], dtype=torch.int32)
        logits = model.prefill(torch.ones((2, 8), dtype=torch.int32), lengths, k, v, bt)
        logits = model.decode(logits.argmax(-1).int(), lengths, k, v, bt,
                              torch.tensor([True, True]))
        assert logits.shape == (2, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_params_from_numpy_carries_quantized_and_fp8_leaves():
    """int8 and packed uint8 weights, bf16 scales and an e5m2 array (an
    fp8 KV page) keep their bits, past e5m2's range included."""
    import ml_dtypes

    rng = np.random.default_rng(2)
    tree = {"layers": {"q_proj": {
        "q": rng.integers(-127, 128, size=(2, 8, 6)).astype(np.int8),
        "scale": rng.standard_normal((2, 6)).astype(ml_dtypes.bfloat16)}},
        "packed": {"q": rng.integers(0, 256, size=(4, 6)).astype(np.uint8),
                   "scale": rng.standard_normal((1, 6)).astype(np.float32),
                   "zero": np.full((1, 6), 3.0, np.float32)},
        "page": np.asarray([0.1, -2.5, 57344.0, 6.1e4, 1e5, -1e5],
                           np.float32).astype(ml_dtypes.float8_e5m2)}
    ours = params_from_numpy(tree)
    expect = {"int8": torch.int8, "uint8": torch.uint8, "bfloat16": torch.bfloat16,
              "float32": torch.float32, "float8_e5m2": torch.float8_e5m2}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        t = ours
        for key in path:
            t = t[key.key]
        assert t.dtype == expect[leaf.dtype.name] and tuple(t.shape) == leaf.shape
        width = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16),
                 4: (torch.int32, np.uint32)}[leaf.dtype.itemsize]
        np.testing.assert_array_equal(t.view(width[0]).numpy().view(width[1]),
                                      leaf.view(width[1]))
    assert torch.isinf(ours["page"].float()).sum() == 2
