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
from llmq_tpu_torch.ops import attention as tops
from llmq_tpu_torch.ops import dispatch as tdispatch
from llmq_tpu_torch.ops.cuda_attention import (
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
