"""Port weight-only quantization (``models/quant.py``, ``ops/matmul.py``)
against the JAX package: the same trees bit for bit, the same products.

- ``quantize_array`` / ``quantize_array_int4`` / ``pack_int4`` /
  ``unpack_int4`` (scales and zero-points in f32 and bf16) and
  ``quantize_params`` (int8 with f32 scales, int4 with bf16 ones) on
  numpy-made f32 weights give bit-identical leaves, including the gcd
  group of a contraction dim below 128 and the odd-K refusal. The JAX
  side runs jitted, as the JAX package always quantizes (XLA turns a
  division by a constant into a multiplication by its reciprocal, which
  moves some f32 scales by one ulp against an eager call).
- The plain versions of K6 / K7 against ``int8_matmul_pallas`` /
  ``int4_matmul_pallas`` in interpret mode on the two smallest cases of
  ``tests/test_pallas_matmul.py``'s grids, and against the f64 product at
  that file's tolerances on the largest.
- ``quant.matmul``, ``embed_lookup`` and ``tied_head_matmul`` against the
  JAX functions with the kernel switches off and on.
- ``Transformer`` prefill and decode logits within 1e-4 (f32) on a tiny
  tied qwen2 with an int8 tree and an untied llama with an int4 tree,
  carried over by ``params_from_numpy``; the llama case with both
  switches on, against JAX's interpret-mode kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmq_tpu.models import quant as jq
from llmq_tpu.models.config import ModelConfig as JConfig
from llmq_tpu.models.transformer import Transformer as JTransformer
from llmq_tpu.models.transformer import init_params as jinit
from llmq_tpu.models.transformer import make_kv_pages as jpages
from llmq_tpu.ops.pallas_matmul import int4_matmul_pallas, int8_matmul_pallas
from llmq_tpu_torch.models import quant as tq
from llmq_tpu_torch.models.config import ModelConfig as TConfig
from llmq_tpu_torch.models.convert import params_from_numpy
from llmq_tpu_torch.models.transformer import Transformer, init_params, make_kv_pages
from llmq_tpu_torch.ops import dispatch
from llmq_tpu_torch.ops import matmul as tmm
from llmq_tpu_torch.ops.cuda_matmul import int4_matmul_cuda, int8_matmul_cuda

from test_torch_model import BASE, FAMILIES, numpy_params

pytestmark = pytest.mark.unit

SCALE_DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
KERNEL_ENV = ("LLMQ_INT8_MATMUL", "LLMQ_INT4_MATMUL")


def _bits(x) -> np.ndarray:
    """A JAX array or torch tensor as unsigned integers of its width."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            x = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()])
        x = x.numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _assert_same_tree(theirs, ours):
    assert set(theirs) == set(ours)
    for key, leaf in theirs.items():
        if isinstance(leaf, dict):
            _assert_same_tree(leaf, ours[key])
        else:
            np.testing.assert_array_equal(_bits(ours[key]), _bits(leaf), err_msg=key)


def _switches(monkeypatch, on: bool):
    for var in KERNEL_ENV:
        if on:
            monkeypatch.setenv(var, "pallas")
        else:
            monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("sd", SCALE_DTYPES, ids=["f32", "bf16"])
def test_quantize_arrays_and_packing_are_bit_identical(sd):
    jd, td = sd
    rng = np.random.default_rng(0)
    # K = 96: int4 falls back to gcd(96, 128) = 32-row groups. One column
    # of zeros takes the scale = 1 branch.
    w = rng.standard_normal((2, 96, 40)).astype(np.float32)
    w[:, :, 3] = 0.0
    for axis in (-2, -1):
        _assert_same_tree(
            jax.jit(lambda a: jq.quantize_array(a, axis=axis, scale_dtype=jd))(jnp.asarray(w)),
            tq.quantize_array(torch.from_numpy(w), axis=axis, scale_dtype=td))
    j4 = jax.jit(lambda a: jq.quantize_array_int4(a, scale_dtype=jd))(jnp.asarray(w))
    t4 = tq.quantize_array_int4(torch.from_numpy(w), scale_dtype=td)
    _assert_same_tree(j4, t4)
    assert t4["scale"].shape == (2, 3, 40) and tq.int4_group(96) == jq.int4_group(96) == 32
    codes = rng.integers(0, 16, size=(6, 10)).astype(np.uint8)
    packed = tq.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), codes)
    np.testing.assert_array_equal(
        tq.dequantize_int4_parts(t4["q"], t4["scale"], t4["zero"], torch.float32).numpy(),
        np.asarray(jq.dequantize_int4_parts(j4["q"], j4["scale"], j4["zero"], jnp.float32)))
    with pytest.raises(ValueError, match="even"):
        tq.quantize_array_int4(torch.zeros(33, 8))


@pytest.mark.parametrize("bits,sd", [(8, SCALE_DTYPES[0]), (4, SCALE_DTYPES[1])],
                         ids=["int8-f32", "int4-bf16"])
def test_quantize_params_trees_are_bit_identical(bits, sd):
    jd, td = sd
    cfg = JConfig.tiny(**{**BASE, **FAMILIES["llama"]})  # untied: lm_head too
    tree = numpy_params(cfg, seed=3)
    theirs = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, tree), scale_dtype=jd, bits=bits))
    ours = tq.quantize_params(params_from_numpy(tree), scale_dtype=td, bits=bits)
    _assert_same_tree(theirs, ours)
    assert tq.is_int4(ours["layers"]["q_proj"]) == (bits == 4)
    assert not tq.is_int4(ours["embed"]) and not tq.is_int4(ours["lm_head"])
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_params(params_from_numpy(tree), bits=2)
    # donate=True frees the full-precision leaves in place.
    src = params_from_numpy(tree)
    again = tq.quantize_params(src, scale_dtype=td, bits=bits, donate=True)
    _assert_same_tree(theirs, again)
    assert src["embed"].numel() == 0 and src["layers"]["down_proj"].numel() == 0
    assert src["layers"]["ln1"].numel() > 0


def _x(seed, M, K, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((M, K)).astype(dtype)


@pytest.mark.parametrize("M,K,N", [(8, 32, 48), (5, 33, 47), (256, 512, 520)])
def test_plain_int8_matmul_matches_pallas_and_f64(M, K, N):
    rng = np.random.default_rng(M)
    x = _x(K, M, K)
    q = rng.integers(-127, 127, size=(K, N)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, size=N).astype(np.float32)
    ours = tmm.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                           torch.from_numpy(scale)).numpy()
    if M * K * N < 10**6:  # interpret mode: each grid step costs time
        theirs = int8_matmul_pallas(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                    block_m=16, block_n=64, block_k=32, interpret=True)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-5, atol=1e-4)
    exact = (x.astype(np.float64) @ q.astype(np.float64)) * scale.astype(np.float64)
    np.testing.assert_allclose(ours.astype(np.float64), exact, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M,K,N,group", [(8, 32, 48, 16), (16, 128, 64, 128),
                                         (64, 256, 136, 32)])
def test_plain_int4_matmul_matches_pallas_and_f64(M, K, N, group):
    w = np.random.default_rng(K).standard_normal((K, N)).astype(np.float32)
    qt = tq.quantize_array_int4(torch.from_numpy(w), group_size=group)
    x = _x(N, M, K)
    ours = tmm.int4_matmul(torch.from_numpy(x), qt["q"], qt["scale"], qt["zero"]).numpy()
    if M * K * N < 10**6:
        theirs = int4_matmul_pallas(jnp.asarray(x), *(jnp.asarray(qt[k].numpy())
                                                      for k in ("q", "scale", "zero")),
                                    block_m=16, block_n=64, interpret=True)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-4, atol=1e-4)
    deq = tq.dequantize_int4_parts(qt["q"], qt["scale"], qt["zero"], torch.float32)
    exact = x.astype(np.float64) @ deq.numpy().astype(np.float64)
    np.testing.assert_allclose(ours.astype(np.float64), exact, rtol=1e-4, atol=1e-4)


def test_plain_matmuls_in_bf16_return_bf16():
    x = torch.from_numpy(_x(1, 16, 64)).to(torch.bfloat16)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((64, 48)).astype(np.float32))
    q8 = tq.quantize_array(w, axis=-2, scale_dtype=torch.bfloat16)
    q4 = tq.quantize_array_int4(w, scale_dtype=torch.bfloat16)
    out8 = tmm.int8_matmul(x, q8["q"], q8["scale"])
    out4 = tmm.int4_matmul(x, q4["q"], q4["scale"], q4["zero"])
    assert out8.dtype == out4.dtype == torch.bfloat16
    # The JAX test's bf16 contract: the XLA int8 path's numerics within 2e-2.
    xla = (x @ q8["q"].to(torch.bfloat16)).float() * q8["scale"].float()
    torch.testing.assert_close(out8.float(), xla, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("on", [False, True], ids=["dequant-path", "kernel-path"])
def test_matmul_embed_and_tied_head_match_jax(monkeypatch, on):
    _switches(monkeypatch, on)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    table = rng.standard_normal((40, 64)).astype(np.float32)
    ids = rng.integers(0, 40, size=(2, 5)).astype(np.int32)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    for jw, tw in ((jq.quantize_array(jnp.asarray(w), axis=-2),
                    tq.quantize_array(torch.from_numpy(w), axis=-2)),
                   (jq.quantize_array_int4(jnp.asarray(w), group_size=32),
                    tq.quantize_array_int4(torch.from_numpy(w), group_size=32)),
                   (jnp.asarray(w), torch.from_numpy(w))):
        ours = tq.matmul(torch.from_numpy(x), tw)
        assert ours.shape == (2, 6, 48)
        np.testing.assert_allclose(ours.numpy(), np.asarray(jq.matmul(jnp.asarray(x), jw)),
                                   rtol=1e-4, atol=1e-4)
    for dt_j, dt_t in SCALE_DTYPES:
        jt = jq.quantize_array(jnp.asarray(table), axis=-1, scale_dtype=dt_j)
        tt = tq.quantize_array(torch.from_numpy(table), axis=-1, scale_dtype=dt_t)
        rows = tq.embed_lookup(tt, torch.from_numpy(ids))
        assert rows.dtype == dt_t and rows.shape == (2, 5, 64)
        np.testing.assert_array_equal(
            _bits(rows), _bits(jq.embed_lookup(jt, jnp.asarray(ids))))
    jt = jq.quantize_array(jnp.asarray(table), axis=-1)
    tt = tq.quantize_array(torch.from_numpy(table), axis=-1)
    np.testing.assert_allclose(
        tq.tied_head_matmul(torch.from_numpy(h), tt).numpy(),
        np.asarray(jq.tied_head_matmul(jnp.asarray(h), jt)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tq.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy(), table[ids])


def test_dispatch_switches_and_cpu_routing(monkeypatch):
    """The switches resolve to the rungs set to ``pallas``; a CPU tensor
    takes the plain version even with a switch on, and the kernel
    wrappers refuse CPU tensors, counters untouched."""
    _switches(monkeypatch, False)
    assert dispatch.resolve_quant_matmul() == frozenset()
    monkeypatch.setenv("LLMQ_INT8_MATMUL", "Pallas")
    monkeypatch.setenv("LLMQ_INT4_MATMUL", "xla")
    assert dispatch.resolve_quant_matmul() == frozenset({"int8"})
    before = (int8_matmul_cuda.launches, int4_matmul_cuda.launches)
    x = torch.from_numpy(_x(5, 4, 64))
    w = torch.from_numpy(np.random.default_rng(6).standard_normal((64, 32)).astype(np.float32))
    q8 = tq.quantize_array(w, axis=-2)
    q4 = tq.quantize_array_int4(w)
    torch.testing.assert_close(tq.matmul(x, q8, frozenset({"int8"})),
                               tmm.int8_matmul(x, q8["q"], q8["scale"]), rtol=0, atol=0)
    torch.testing.assert_close(tq.matmul(x, q4, frozenset({"int4"})),
                               tmm.int4_matmul(x, *q4.values()), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul_cuda(x, q8["q"], q8["scale"])
    with pytest.raises(ValueError, match="CUDA"):
        int4_matmul_cuda(x, q4["q"], q4["scale"], q4["zero"])
    assert (int8_matmul_cuda.launches, int4_matmul_cuda.launches) == before


def test_init_params_quantized_tree_matches_jax_layout():
    for family, mode in (("qwen2", "int8"), ("llama", "int4")):
        kw = {**BASE, **FAMILIES[family]}
        ours = init_params(TConfig.tiny(**kw), torch.Generator().manual_seed(0),
                           torch.bfloat16, quantize=mode)
        theirs = jax.eval_shape(lambda key: jinit(JConfig.tiny(**kw), key, dtype=jnp.bfloat16,
                                                  quantize=mode), jax.random.key(0))
        flat_j = {jax.tree_util.keystr(p): leaf
                  for p, leaf in jax.tree_util.tree_leaves_with_path(theirs)}
        flat_t = {jax.tree_util.keystr(p): leaf
                  for p, leaf in jax.tree_util.tree_leaves_with_path(ours)}
        assert set(flat_t) == set(flat_j), family
        for key, leaf in flat_j.items():
            assert tuple(flat_t[key].shape) == leaf.shape, key
            assert str(flat_t[key].dtype).replace("torch.", "") == str(leaf.dtype), key


@pytest.mark.parametrize("family,bits,on", [("qwen2", 8, False), ("llama", 4, True)],
                         ids=["qwen2-tied-int8", "llama-untied-int4-kernels"])
def test_quantized_prefill_and_decode_match_jax(monkeypatch, family, bits, on):
    """The tied qwen2 takes the dequantize paths and the tied int8 head;
    the untied llama runs K7's and K6's plain versions (its int8 head
    through K6) against JAX's interpret-mode kernels."""
    _switches(monkeypatch, on)
    kw = {**BASE, **FAMILIES[family], "tie_word_embeddings": family == "qwen2"}
    jcfg, tcfg = JConfig.tiny(**kw), TConfig.tiny(**kw)
    tree = numpy_params(jcfg, seed=bits)
    jparams = jq.quantize_params(jax.tree.map(jnp.asarray, tree), bits=bits)
    model = Transformer(tcfg, params_from_numpy(jax.tree.map(np.asarray, jparams)))
    assert model.quant_kernels == (frozenset({"int8", "int4"}) if on else frozenset())
    jm = JTransformer(jcfg, attn_backend="xla")
    B, T, page, P = 2, 16, 8, 10
    rng = np.random.default_rng(9)
    lengths = np.asarray([T, 7], np.int32)
    tokens = rng.integers(1, kw["vocab_size"], size=(B, T)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jk, jv = jpages(jcfg, P, page, jnp.float32)
    tk, tv = make_kv_pages(tcfg, P, page, torch.float32)
    jl, jk, jv = jm.prefill(jparams, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv,
                            jnp.asarray(bt))
    tl = model.prefill(torch.from_numpy(tokens), torch.from_numpy(lengths), tk, tv,
                       torch.from_numpy(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    toks = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    active = np.asarray([True, True])
    jl, _, _ = jm.decode(jparams, jnp.asarray(toks), jnp.asarray(lengths), jk, jv,
                         jnp.asarray(bt), jnp.asarray(active))
    tl = model.decode(torch.from_numpy(toks), torch.from_numpy(lengths), tk, tv,
                      torch.from_numpy(bt), torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
