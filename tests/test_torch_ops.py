"""Port attention ops (plain PyTorch versions of K1/K2 + the KV writes)
against the JAX reference ops and the Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and handed to both sides. f32
attention is held at 2e-5, bf16 prefill at 3e-2 (the tolerances of
``tests/test_pallas_attention.py``); KV writes must be bit-exact on every
page but the scratch page 0 (duplicate scratch writes land in any order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmq_tpu.ops import attention as jref
from llmq_tpu.ops import pallas_attention as pk
from llmq_tpu.ops.dispatch import _WINDOW_DISABLED
from llmq_tpu_torch.models.convert import tensor_from_numpy
from llmq_tpu_torch.ops import attention as tops
from llmq_tpu_torch.ops import dispatch as tdispatch
from llmq_tpu_torch.ops.cuda_attention import (
    attention_route,
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
)

pytestmark = pytest.mark.unit


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _paged_inputs(seed, *, S, n_heads, n_kv, d, page, pps, L, ctx):
    rng = np.random.default_rng(seed)
    P = 1 + S * pps
    q = (rng.standard_normal((S, n_heads, d)) * 0.3).astype(np.float32)
    kp = (rng.standard_normal((L, P, page, n_kv, d)) * 0.3).astype(np.float32)
    vp = (rng.standard_normal((L, P, page, n_kv, d)) * 0.3).astype(np.float32)
    bt = (1 + rng.permutation(S * pps)).reshape(S, pps).astype(np.int32)
    return q, kp, vp, bt, np.asarray(ctx, np.int32)


@pytest.mark.parametrize(
    "n_heads,n_kv,window,softcap,layer",
    [
        (4, 4, None, None, 0),  # GQA ratio 1 (MHA)
        (8, 4, 13, None, 2),  # ratio 2, short window, stacked layer
        (8, 2, None, 50.0, 1),  # ratio 4, softcap
        (8, 2, 7, 50.0, 3),  # everything at once
    ],
)
def test_paged_decode_matches_jax_and_pallas(n_heads, n_kv, window, softcap, layer):
    S, d, page, pps, L = 4, 16, 8, 3, 4
    ctx = [0, 1, 8, 19]  # inactive row, page-aligned and not, full
    q, kp, vp, bt, cl = _paged_inputs(
        layer, S=S, n_heads=n_heads, n_kv=n_kv, d=d, page=page, pps=pps, L=L, ctx=ctx
    )
    scale = d**-0.5
    kw = dict(scale=scale, sliding_window=window, softcap=softcap)
    ours = tops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(cl), layer=layer, **kw,
    ).numpy()
    ref = jref.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), layer=jnp.asarray(layer, jnp.int32), **kw,
    )
    np.testing.assert_allclose(ours, _np(ref), rtol=2e-5, atol=2e-5)
    pallas = pk.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), jnp.asarray([window or _WINDOW_DISABLED], jnp.int32),
        jnp.asarray(layer, jnp.int32), scale=scale, softcap=softcap, interpret=True,
    )
    # The ctx == 0 row is inactive: the kernels write zeros there, the
    # plain versions a finite average. Both never read; compare live rows.
    live = cl > 0
    np.testing.assert_allclose(ours[live], _np(pallas)[live], rtol=2e-5, atol=2e-5)
    assert np.isfinite(ours).all()
    assert (_np(pallas)[~live] == 0).all()


def _prefill_inputs(seed, B, T, n_heads, n_kv, d):
    rng = np.random.default_rng(seed)
    return tuple(
        (rng.standard_normal((B, T, h, d)) * 0.3).astype(np.float32)
        for h in (n_heads, n_kv, n_kv)
    )


@pytest.mark.parametrize(
    "n_heads,n_kv,window,softcap,T",
    [
        (4, 4, None, None, 32),  # GQA ratio 1
        (8, 4, 9, None, 32),  # ratio 2, window crossing blocks
        (8, 2, None, 50.0, 24),  # ratio 4, softcap, T not a block multiple
        (6, 3, 11, 15.0, 24),  # everything at once
    ],
)
def test_full_prefill_matches_jax_and_pallas(n_heads, n_kv, window, softcap, T):
    B, d = 3, 16
    lengths = np.asarray([T, T // 2, 3], np.int32)  # ragged
    q, k, v = _prefill_inputs(T, B, T, n_heads, n_kv, d)
    scale = d**-0.5
    kw = dict(scale=scale, sliding_window=window, softcap=softcap)
    ours = tops.full_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lengths=torch.from_numpy(lengths), **kw,
    ).numpy()
    ref = jref.full_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths=jnp.asarray(lengths), **kw
    )
    np.testing.assert_allclose(ours, _np(ref), rtol=2e-5, atol=2e-5)
    pallas = pk.flash_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray([window or _WINDOW_DISABLED], jnp.int32),
        scale=scale, softcap=softcap, block_q=16, block_kv=16, interpret=True,
    )
    for b, n in enumerate(lengths):  # rows past a length are padding
        np.testing.assert_allclose(ours[b, :n], _np(pallas)[b, :n], rtol=2e-5, atol=2e-5)


def test_full_prefill_bf16_matches_jax():
    B, T, n_heads, n_kv, d = 2, 32, 4, 2, 16
    lengths = np.asarray([T, T // 2], np.int32)
    q, k, v = _prefill_inputs(40, B, T, n_heads, n_kv, d)
    to_t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    to_j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    ours = tops.full_prefill_attention(
        to_t(q), to_t(k), to_t(v), scale=d**-0.5, lengths=torch.from_numpy(lengths)
    )
    assert ours.dtype == torch.bfloat16
    ref = jref.full_prefill_attention(
        to_j(q), to_j(k), to_j(v), scale=d**-0.5, lengths=jnp.asarray(lengths)
    )
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(
            ours[b, :n].float().numpy(), _np(ref[b, :n]), rtol=3e-2, atol=3e-2
        )


def test_compute_dtype_rule():
    assert tops._compute_dtype(torch.bfloat16, torch.float32) == torch.float32
    assert tops._compute_dtype(torch.float32, torch.bfloat16) == torch.float32
    assert tops._compute_dtype(torch.bfloat16, torch.float8_e5m2) == torch.bfloat16
    assert tops._compute_dtype(torch.bfloat16, torch.bfloat16) == torch.bfloat16
    assert tops.NEG_INF == jref.NEG_INF == -1e30


def _pools(seed, L, P, page, n_kv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((L, P, page, n_kv, d)).astype(np.float32) for _ in "kv")


@pytest.mark.parametrize("stacked", [True, False])
def test_write_kv_pages_matches_jax(stacked):
    L, P, page, n_kv, d, B, T = 3, 9, 4, 2, 8, 2, 5
    kp, vp = _pools(0, L, P, page, n_kv, d)
    rng = np.random.default_rng(1)
    k_new = rng.standard_normal((B, T, n_kv, d)).astype(np.float32)
    v_new = rng.standard_normal((B, T, n_kv, d)).astype(np.float32)
    bt = np.asarray([[3, 5, 1, 0], [2, 7, 8, 4]], np.int32)
    positions = np.asarray([[0, 1, 2, 3, 4], [6, 7, 8, -1, -1]], np.int32)
    layer = 1
    if not stacked:
        kp, vp = kp[layer], vp[layer]
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tops.write_kv_pages(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(bt),
        torch.from_numpy(positions), layer if stacked else None,
    )
    assert out[0] is tk and out[1] is tv  # in place
    jk, jv = jref.write_kv_pages(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(bt), jnp.asarray(positions),
        jnp.asarray(layer, jnp.int32) if stacked else None,
    )
    page_axis = 1 if stacked else 0
    np.testing.assert_array_equal(
        tk.numpy().take(range(1, P), page_axis), _np(jk).take(range(1, P), page_axis)
    )
    np.testing.assert_array_equal(
        tv.numpy().take(range(1, P), page_axis), _np(jv).take(range(1, P), page_axis)
    )


def test_write_prompt_kv_pages_matches_jax():
    L, P, page, n_kv, d, B, T = 2, 9, 4, 2, 8, 3, 8
    kp, vp = _pools(2, L, P, page, n_kv, d)
    rng = np.random.default_rng(3)
    k_new = rng.standard_normal((B, T, n_kv, d)).astype(np.float32)
    v_new = rng.standard_normal((B, T, n_kv, d)).astype(np.float32)
    bt = np.asarray([[1, 2, 0], [3, 4, 0], [0, 0, 0]], np.int32)  # last row padding
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tops.write_prompt_kv_pages(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(bt), 1
    )
    jk, jv = jref.write_prompt_kv_pages(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(bt), jnp.asarray(1, jnp.int32),
    )
    np.testing.assert_array_equal(tk.numpy()[:, 1:], _np(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], _np(jv)[:, 1:])
    with pytest.raises(ValueError):
        tops.write_prompt_kv_pages(
            tk, tv, torch.from_numpy(k_new[:, :5]), torch.from_numpy(v_new[:, :5]),
            torch.from_numpy(bt), 0,
        )


def test_dispatch_routes_cpu_tensors_to_plain_versions():
    """A CPU tensor never reaches a kernel: the plain versions run and the
    launch counters stay put."""
    before = (paged_decode_attention_cuda.launches, flash_prefill_attention_cuda.launches)
    q, kp, vp, bt, cl = _paged_inputs(
        5, S=2, n_heads=4, n_kv=2, d=16, page=8, pps=2, L=2, ctx=[3, 9]
    )
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, cl)]
    out = tdispatch.decode_attention(*args, scale=0.25, layer=1)
    ref = tops.paged_decode_attention(*args, scale=0.25, layer=1)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    qp, kq, vq = (torch.from_numpy(a) for a in _prefill_inputs(6, 2, 16, 4, 2, 16))
    out = tdispatch.prefill_attention(qp, kq, vq, scale=0.25, sliding_window=5)
    ref = tops.full_prefill_attention(qp, kq, vq, scale=0.25, sliding_window=5,
                                      lengths=torch.full((2,), 16, dtype=torch.int32))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (paged_decode_attention_cuda.launches, flash_prefill_attention_cuda.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: CPU tensors raise before any
    build or launch, and the launch counters stay put."""
    before = (paged_decode_attention_cuda.launches, flash_prefill_attention_cuda.launches)
    q, kp, vp, bt, cl = (torch.from_numpy(a) for a in _paged_inputs(
        5, S=2, n_heads=4, n_kv=2, d=64, page=8, pps=2, L=2, ctx=[3, 9]))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_cuda(q, kp, vp, bt, cl, scale=0.25, layer=1)
    qp, kq, vq = (torch.from_numpy(a) for a in _prefill_inputs(6, 2, 16, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_attention_cuda(qp, kq, vq, torch.full((2,), 16, dtype=torch.int32),
                                     scale=0.25)
    assert (paged_decode_attention_cuda.launches, flash_prefill_attention_cuda.launches) == before


@pytest.mark.parametrize("q_dtype,kv_dtype,route", [
    (torch.bfloat16, torch.bfloat16, "tensor_core"),
    (torch.bfloat16, torch.float8_e5m2, "tensor_core"),  # e5m2 widens exactly to bf16
    (torch.bfloat16, torch.float32, "exact"),  # an f32 pool promotes the math to f32
    (torch.float32, torch.float32, "exact"),
    (torch.float32, torch.bfloat16, "exact"),
    (torch.float32, torch.float8_e5m2, "exact"),
])
def test_prefill_route_is_a_function_of_dtypes(q_dtype, kv_dtype, route):
    """K1, K2 and K3 run bf16 queries over bf16 or e5m2 K/V on the tensor
    cores and everything that computes in f32 on the exact kernels."""
    assert attention_route(q_dtype, kv_dtype) == route


# --- fp8 (float8_e5m2) KV pools: the tests/test_kv_fp8.py case grid ----------

FP8 = jnp.float8_e5m2


def _fp8_pool(seed, shape):
    """A pool made in f32 and cast to e5m2 once (numpy, ml_dtypes): both
    sides get the same bits."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32).astype(FP8)


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a))


def _pool_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


@pytest.mark.parametrize("case", ["decode", "fused_write", "chunk_f32", "chunk_bf16"])
def test_fp8_pool_attention_matches_jax(case):
    """The plain ops read an e5m2 pool as the JAX references do (upcast to
    the query dtype on load): 2e-5 in f32, 3e-2 with a bf16 query; the
    fused write stores the new rows bit for bit as the JAX write does."""
    n_heads, n_kv, d, page, pps, L = 4, 2, 16, 8, 3, 2
    rng = np.random.default_rng(len(case))
    if case in ("decode", "fused_write"):
        ctx = [1, 9, 24] if case == "decode" else [1, 9, 0]
        S = len(ctx)
        kp = _fp8_pool(1, (L, 1 + S * pps, page, n_kv, d))
        vp = _fp8_pool(2, kp.shape)
        bt = np.arange(1, 1 + S * pps, dtype=np.int32).reshape(S, pps)
        q = (rng.standard_normal((S, n_heads, d)) * 0.3).astype(np.float32)
        cl = np.asarray(ctx, np.int32)
        li, kw = 1, dict(scale=d**-0.5)
        if case == "decode":
            ours = tops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(cl),
                                               layer=li, **kw)
            ref = jref.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                              jnp.asarray(bt), jnp.asarray(cl),
                                              layer=jnp.asarray(li, jnp.int32), **kw)
            np.testing.assert_allclose(ours.numpy(), _np(ref), rtol=2e-5, atol=2e-5)
            return
        kn = (rng.standard_normal((S, n_kv, d)) * 0.3).astype(np.float32)
        vn = (rng.standard_normal((S, n_kv, d)) * 0.3).astype(np.float32)
        tk, tv = _t(kp), _t(vp)
        ours, _, _ = tops.paged_decode_attention_fused_write(
            _t(q), tk, tv, _t(kn), _t(vn), _t(bt), _t(cl), layer=li, **kw)
        positions = jnp.where(jnp.asarray(cl) > 0, jnp.asarray(cl) - 1, -1)[:, None]
        jk, jv = jref.write_kv_pages(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn)[:, None],
                                     jnp.asarray(vn)[:, None], jnp.asarray(bt), positions,
                                     layer=jnp.asarray(li, jnp.int32))
        ref = jref.paged_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                          jnp.asarray(cl), layer=jnp.asarray(li, jnp.int32),
                                          **kw)
        live = cl > 0
        np.testing.assert_allclose(ours.numpy()[live], _np(ref)[live], rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(_pool_bits(tk)[:, 1:], np.asarray(jk).view(np.uint8)[:, 1:])
        np.testing.assert_array_equal(_pool_bits(tv)[:, 1:], np.asarray(jv).view(np.uint8)[:, 1:])
        return
    B, C = 2, 8
    kp = _fp8_pool(3, (1 + B * pps, page, n_kv, d))
    vp = _fp8_pool(4, kp.shape)
    bt = np.arange(1, 1 + B * pps, dtype=np.int32).reshape(B, pps)
    q = (rng.standard_normal((B, C, n_heads, d)) * 0.3).astype(np.float32)
    pos = np.asarray([[4, 5, 6, 7, 8, 9, 10, 11], [0, 1, 2, 3, 4, 5, -1, -1]], np.int32)
    bf16 = case == "chunk_bf16"
    tq_ = _t(q).to(torch.bfloat16) if bf16 else _t(q)
    jq_ = jnp.asarray(q).astype(jnp.bfloat16) if bf16 else jnp.asarray(q)
    ours = tops.paged_prefill_attention(tq_, _t(kp), _t(vp), _t(bt), _t(pos), scale=d**-0.5)
    assert ours.dtype == tq_.dtype
    ref = jref.paged_prefill_attention(jq_, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                                       jnp.asarray(pos), scale=d**-0.5)
    tol = 3e-2 if bf16 else 2e-5
    valid = pos >= 0
    np.testing.assert_allclose(ours.float().numpy()[valid], _np(ref)[valid], rtol=tol, atol=tol)


@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_fp8_pool_writes_are_bit_exact_with_jax(src):
    """Both write paths cast to e5m2 as JAX does, round to nearest even
    and overflow to +-inf included (one row of each write is scaled past
    e5m2's largest finite value, 57,344)."""
    S, n_kv, d, page, pps, L = 2, 2, 16, 8, 2, 2
    P = 1 + S * pps
    bt = np.arange(1, P, dtype=np.int32).reshape(S, pps)
    rng = np.random.default_rng(11)
    big = np.linspace(5.0e4, 7.0e4, n_kv * d, dtype=np.float32).reshape(n_kv, d)

    def rows(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        a.reshape(-1, n_kv, d)[1] = big  # one row past the range
        return a

    cast_t = (lambda a: _t(a).to(torch.bfloat16)) if src == "bf16" else _t
    cast_j = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if src == "bf16" else jnp.asarray
    zero = np.zeros((L, P, page, n_kv, d), np.float32).astype(FP8)
    li = jnp.asarray(1, jnp.int32)
    kn, vn = rows((S, 1, n_kv, d)), rows((S, 1, n_kv, d))
    positions = np.asarray([[3], [7]], np.int32)
    tk, tv = _t(zero), _t(zero)
    tops.write_kv_pages(tk, tv, cast_t(kn), cast_t(vn), _t(bt), _t(positions), 1)
    jk, jv = jref.write_kv_pages(jnp.asarray(zero), jnp.asarray(zero), cast_j(kn), cast_j(vn),
                                 jnp.asarray(bt), jnp.asarray(positions), li)
    assert tk.dtype == torch.float8_e5m2 and jk.dtype == FP8
    np.testing.assert_array_equal(_pool_bits(tk)[:, 1:], np.asarray(jk).view(np.uint8)[:, 1:])
    np.testing.assert_array_equal(_pool_bits(tv)[:, 1:], np.asarray(jv).view(np.uint8)[:, 1:])
    assert torch.isinf(tk.float()).any() and (tk.float().abs() == 57344.0).any()
    kb, vb = rows((S, page * pps, n_kv, d)), rows((S, page * pps, n_kv, d))
    tk, tv = _t(zero), _t(zero)
    tops.write_prompt_kv_pages(tk, tv, cast_t(kb), cast_t(vb), _t(bt), 1)
    jk, jv = jref.write_prompt_kv_pages(jnp.asarray(zero), jnp.asarray(zero), cast_j(kb),
                                        cast_j(vb), jnp.asarray(bt), li)
    np.testing.assert_array_equal(_pool_bits(tk)[:, 1:], np.asarray(jk).view(np.uint8)[:, 1:])
    np.testing.assert_array_equal(_pool_bits(tv)[:, 1:], np.asarray(jv).view(np.uint8)[:, 1:])
