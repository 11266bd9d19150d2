"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card
and skips without one (so on a CPU-only machine these count as skipped).
On a GPU machine: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Every kernel (K1-K7) runs bf16 on its tensor-core route and f32 on its
exact route; each test asserts the route its launch took.
Tolerances: 2e-5 in f32, 3e-2 in bf16, as for the Pallas kernels; the
weight-only matmuls (K6, K7) in f32 within 1e-5 / 1e-4 (K6) and 1e-4
(K7) of the f64 product, in bf16 within 2e-2 of the plain version, as
``tests/test_pallas_matmul.py`` holds the TPU kernels.
"""

import numpy as np
import pytest
import torch

from llmq_tpu_torch.models import quant as qm
from llmq_tpu_torch.models.config import ModelConfig
from llmq_tpu_torch.models.transformer import Transformer, init_params, make_kv_pages
from llmq_tpu_torch.ops import attention as plain
from llmq_tpu_torch.ops import matmul as plain_mm
from llmq_tpu_torch.ops.cuda_attention import (
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
    paged_decode_attention_v2_cuda,
    paged_decode_attention_v3_cuda,
    paged_prefill_attention_cuda,
)
from llmq_tpu_torch.ops.cuda_matmul import int4_matmul_cuda, int8_matmul_cuda

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _routes(wrapper):
    return wrapper.tensor_core_launches, wrapper.exact_launches


def _assert_launched_on(wrapper, before, route):
    """One launch since ``before`` (from :func:`_routes`), on ``route``."""
    tc, exact = before
    assert _routes(wrapper) == ((tc + 1, exact) if route == "tensor_core" else (tc, exact + 1))


def _route_of(dtype):
    return "tensor_core" if dtype == torch.bfloat16 else "exact"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "n_heads,n_kv,d,window,softcap",
    [(4, 4, 64, None, None), (8, 4, 128, 13, None), (16, 2, 128, None, 50.0),
     (8, 4, 256, 64, 50.0), (14, 2, 64, 7, 30.0),
     (16, 16, 128, None, None)],  # qwen1.5-moe-a2.7b: a query group of 1
)
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, n_heads, n_kv, d, window,
                                           softcap):
    rng = np.random.default_rng(n_heads * d)
    S, page, pps, L = 6, 16, 8, 3
    P = 1 + S * pps
    ctx = torch.tensor([0, 1, 16, 37, 100, 128], dtype=torch.int32, device=cuda_device)
    bt = torch.from_numpy((1 + rng.permutation(S * pps)).reshape(S, pps).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((S, n_heads, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((L, P, page, n_kv, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((L, P, page, n_kv, d)).astype(np.float32))
    q, kp, vp = (t.to(cuda_device, dtype) for t in (q, kp, vp))
    bt = bt.to(cuda_device)
    kw = dict(scale=d**-0.5, sliding_window=window, softcap=softcap, layer=L - 1)
    before = paged_decode_attention_cuda.launches
    out = paged_decode_attention_cuda(q, kp, vp, bt, ctx, **kw)
    ref = plain.paged_decode_attention(q, kp, vp, bt, ctx, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert (out[0] == 0).all()  # ctx == 0: exact zeros
    torch.testing.assert_close(out[1:].float(), ref[1:].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_paged_decode_kernel_promotes_f32_pool_under_bf16_query(cuda_device):
    S, H, n_kv, d, page, pps = 3, 8, 2, 128, 8, 4
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((S, H, d), generator=g, device=cuda_device).bfloat16()
    kp = torch.randn((1, 1 + S * pps, page, n_kv, d), generator=g, device=cuda_device)
    vp = torch.randn((1, 1 + S * pps, page, n_kv, d), generator=g, device=cuda_device)
    bt = torch.arange(1, 1 + S * pps, dtype=torch.int32, device=cuda_device).reshape(S, pps)
    ctx = torch.tensor([5, 17, 32], dtype=torch.int32, device=cuda_device)
    out = paged_decode_attention_cuda(q, kp, vp, bt, ctx, scale=d**-0.5, layer=0)
    ref = plain.paged_decode_attention(q, kp, vp, bt, ctx, scale=d**-0.5, layer=0)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "n_heads,n_kv,d,T,window,softcap",
    [(4, 4, 64, 32, None, None), (8, 2, 128, 100, None, None),
     (8, 4, 128, 130, 9, None), (8, 4, 256, 70, None, 50.0), (6, 3, 64, 65, 11, 15.0),
     (16, 16, 128, 200, None, None)],  # qwen1.5-moe-a2.7b: a query group of 1
)
def test_flash_prefill_kernel_matches_plain(cuda_device, dtype, n_heads, n_kv, d, T, window,
                                            softcap):
    g = torch.Generator(device=cuda_device).manual_seed(T)
    B = 3
    lengths = [T, T // 2, 3]
    q = torch.randn((B, T, n_heads, d), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((B, T, n_kv, d), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((B, T, n_kv, d), generator=g, device=cuda_device).to(dtype)
    len_t = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    kw = dict(scale=d**-0.5, sliding_window=window, softcap=softcap)
    before = _routes(flash_prefill_attention_cuda)
    out = flash_prefill_attention_cuda(q, k, v, len_t, **kw)
    ref = plain.full_prefill_attention(q, k, v, lengths=len_t, **kw)
    torch.cuda.synchronize()
    _assert_launched_on(flash_prefill_attention_cuda, before, _route_of(dtype))
    for b, n in enumerate(lengths):
        torch.testing.assert_close(out[b, :n].float(), ref[b, :n].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert (out[b, n:] == 0).all()  # padding rows: zeros


@pytest.mark.parametrize(
    "n_heads,n_kv,d,T,lengths,window,softcap",
    [(8, 8, 128, 1, [1], None, None),  # one token; GQA ratio 1
     (8, 4, 64, 97, [97, 1, 64], None, None),  # ratio 2, T % 64 != 0
     (16, 2, 128, 200, [200, 129, 1], None, None),  # ratio 8 (qwen2.5-3b heads)
     (8, 1, 128, 300, [300, 171], 100, None),  # window frontier crosses key tiles
     (8, 4, 256, 150, [150, 65, 2], 64, 50.0)],  # gemma2: d 256, window 64, softcap 50
    ids=["len1-gqa1", "gqa2-d64", "gqa8", "window100", "d256-window-softcap"],
)
def test_flash_prefill_tensor_core_edges(cuda_device, n_heads, n_kv, d, T, lengths, window,
                                         softcap):
    """bf16 K2 on the tensor cores at its design's edges: ragged T and
    lengths against the 64-row tiles, GQA 1 / 2 / 8, d = 256 (32-key
    tiles), and frontiers that cross several key tiles."""
    g = torch.Generator(device=cuda_device).manual_seed(T + d)
    B = len(lengths)
    q, k, v = (torch.randn((B, T, h, d), generator=g, device=cuda_device).bfloat16()
               for h in (n_heads, n_kv, n_kv))
    len_t = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    kw = dict(scale=d**-0.5, sliding_window=window, softcap=softcap)
    before = _routes(flash_prefill_attention_cuda)
    out = flash_prefill_attention_cuda(q, k, v, len_t, **kw)
    ref = plain.full_prefill_attention(q, k, v, lengths=len_t, **kw)
    torch.cuda.synchronize()
    _assert_launched_on(flash_prefill_attention_cuda, before, "tensor_core")
    for b, n in enumerate(lengths):
        torch.testing.assert_close(out[b, :n].float(), ref[b, :n].float(), rtol=3e-2,
                                   atol=3e-2)
        assert (out[b, n:] == 0).all()


def test_flash_prefill_kernel_reads_strided_inputs(cuda_device):
    """q/k/v as views of one fused projection (non-contiguous in time)."""
    B, T, H, n_kv, d = 2, 40, 4, 2, 64
    g = torch.Generator(device=cuda_device).manual_seed(1)
    fused = torch.randn((B, T, (H + 2 * n_kv) * d), generator=g, device=cuda_device)
    q = fused[..., : H * d].view(B, T, H, d)
    k = fused[..., H * d: (H + n_kv) * d].view(B, T, n_kv, d)
    v = fused[..., (H + n_kv) * d:].view(B, T, n_kv, d)
    len_t = torch.tensor([T, 17], dtype=torch.int32, device=cuda_device)
    out = flash_prefill_attention_cuda(q, k, v, len_t, scale=0.125)
    ref = plain.full_prefill_attention(q, k, v, scale=0.125, lengths=len_t)
    torch.testing.assert_close(out[0].float(), ref[0].float(), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out[1, :17], ref[1, :17], rtol=2e-5, atol=2e-5)
    # the same views in bf16, on the tensor-core route
    fused = fused.bfloat16()
    q, k, v = (fused[..., a:b].view(B, T, -1, d)
               for a, b in ((0, H * d), (H * d, (H + n_kv) * d), ((H + n_kv) * d, None)))
    before = _routes(flash_prefill_attention_cuda)
    out = flash_prefill_attention_cuda(q, k, v, len_t, scale=0.125)
    ref = plain.full_prefill_attention(q, k, v, scale=0.125, lengths=len_t)
    _assert_launched_on(flash_prefill_attention_cuda, before, "tensor_core")
    torch.testing.assert_close(out[0].float(), ref[0].float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(out[1, :17].float(), ref[1, :17].float(), rtol=3e-2, atol=3e-2)


def test_tensor_core_prefill_refuses_misaligned_rows(cuda_device):
    """The tensor-core route copies 16-byte words: a base or a row stride
    off 16 bytes raises ValueError, naming the case."""
    B, T, H, n_kv, d = 2, 16, 4, 2, 64
    g = torch.Generator(device=cuda_device).manual_seed(2)
    wide = torch.randn((B, T, H * d + 3), generator=g, device=cuda_device)
    q_stride = wide.bfloat16()[..., : H * d].view(B, T, H, d)  # time stride 518 bytes
    flat = torch.randn(B * T * H * d + 4, generator=g, device=cuda_device).bfloat16()
    q_base = flat[4:].view(B, T, H, d)  # base 8 bytes off
    k = torch.randn((B, T, n_kv, d), generator=g, device=cuda_device).bfloat16()
    len_t = torch.full((B,), T, dtype=torch.int32, device=cuda_device)
    for q in (q_stride, q_base):
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_prefill_attention_cuda(q, k, k, len_t, scale=0.125)
    pool = torch.randn((1, 5, 8, n_kv, d), generator=g, device=cuda_device).bfloat16()
    bt = torch.arange(1, 5, dtype=torch.int32, device=cuda_device).reshape(2, 2)
    ints = torch.tensor([0, 3], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_prefill_attention_cuda(q_stride, pool, pool, bt, ints, ints, scale=0.125, layer=0)
    # f32 takes the exact route, which reads any stride
    q32 = wide[..., : H * d].view(B, T, H, d)
    out = flash_prefill_attention_cuda(q32, k.float(), k.float(), len_t, scale=0.125)
    ref = plain.full_prefill_attention(q32, k.float(), k.float(), scale=0.125, lengths=len_t)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


def test_wrappers_raise_on_unsupported_shapes(cuda_device):
    q = torch.zeros((2, 4, 96), device=cuda_device)
    pool = torch.zeros((1, 3, 8, 2, 96), device=cuda_device)
    bt = torch.ones((2, 1), dtype=torch.int32, device=cuda_device)
    ctx = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention_cuda(q, pool, pool, bt, ctx, scale=1.0, layer=0)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention_cuda(q[..., :64], pool[..., :64].contiguous(),
                                    pool[..., :64].contiguous(), bt.long(), ctx,
                                    scale=1.0, layer=0)


# --- K3: chunked prefill over the paged cache ---------------------------------


def _pool(rng, shape, device, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "n_heads,n_kv,d,window,softcap,page",
    [(4, 4, 64, None, None, 8), (8, 2, 128, None, None, 16), (8, 2, 128, 13, None, 8),
     (4, 1, 64, None, 30.0, 8), (8, 4, 256, 64, 50.0, 32), (6, 3, 64, 7, 20.0, 8)],
)
def test_paged_prefill_kernel_matches_plain(cuda_device, dtype, n_heads, n_kv, d, window,
                                            softcap, page):
    """Chunks that start mid-page after earlier chunks, a ragged tail, a
    row with no valid query, chunks longer than one query tile."""
    rng = np.random.default_rng(n_heads * d + page)
    B, C, pps, L = 4, 70, 12, 3
    starts, valids = [0, 5, 37, 0], [70, 70, 23, 0]
    q = _pool(rng, (B, C, n_heads, d), cuda_device, dtype)
    kp = _pool(rng, (L, 1 + B * pps, page, n_kv, d), cuda_device, dtype)
    vp = _pool(rng, (L, 1 + B * pps, page, n_kv, d), cuda_device, dtype)
    bt = torch.from_numpy((1 + rng.permutation(B * pps)).reshape(B, pps).astype(np.int32))
    positions = torch.full((B, C), -1, dtype=torch.int32)
    for r, (s0, n) in enumerate(zip(starts, valids)):
        positions[r, :n] = torch.arange(s0, s0 + n)
    bt, positions = bt.to(cuda_device), positions.to(cuda_device)
    kw = dict(scale=d**-0.5, sliding_window=window, softcap=softcap, layer=1)
    before = paged_prefill_attention_cuda.launches
    routes = _routes(paged_prefill_attention_cuda)
    out = paged_prefill_attention_cuda(
        q, kp, vp, bt, torch.tensor(starts, dtype=torch.int32, device=cuda_device),
        torch.tensor(valids, dtype=torch.int32, device=cuda_device), **kw)
    ref = plain.paged_prefill_attention(q, kp, vp, bt, positions, **kw)
    torch.cuda.synchronize()
    assert paged_prefill_attention_cuda.launches == before + 1
    _assert_launched_on(paged_prefill_attention_cuda, routes, _route_of(dtype))
    for r, n in enumerate(valids):
        torch.testing.assert_close(out[r, :n].float(), ref[r, :n].float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        assert (out[r, n:] == 0).all()  # padding queries: zeros


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
@pytest.mark.parametrize(
    "n_heads,n_kv,d,window,softcap,page,C,starts,valids",
    [(16, 2, 128, None, None, 32, 160, [37, 300, 0], [150, 90, 1]),  # mid-page, GQA 8
     (8, 4, 256, 64, 50.0, 16, 100, [75, 0, 200], [100, 33, 64]),  # gemma2 d 256, GQA 2
     (4, 4, 64, 20, None, 8, 64, [5, 130, 0], [64, 1, 40]),  # GQA 1, window in a tile
     # the speculative verify step: Q = spec_tokens + 1 queries a row
     (16, 2, 128, None, None, 32, 4, [300, 317, 0, 31], [4, 3, 0, 4]),
     # the mixed step's [S, C] grid: one query a decode row, a prompt segment
     (16, 2, 128, None, None, 32, 256, [330, 0, 95, 7], [1, 0, 200, 1])],
    ids=["midpage-gqa8", "d256-window-softcap", "gqa1-window20", "verify-q4", "mixed-grid"],
)
def test_paged_prefill_tensor_core_edges(cuda_device, kv_dtype, n_heads, n_kv, d, window,
                                         softcap, page, C, starts, valids):
    """bf16 K3 on the tensor cores over bf16 and e5m2 pools: chunks that
    start mid-page, C off the 64-row tile, causal and window frontiers
    that cross several key tiles, a single valid query."""
    rng = np.random.default_rng(C + d)
    B, L = len(starts), 2
    pps = -(-max(s0 + n for s0, n in zip(starts, valids)) // page)
    q = _pool(rng, (B, C, n_heads, d), cuda_device, torch.bfloat16)
    kp = _pool(rng, (L, 1 + B * pps, page, n_kv, d), cuda_device, torch.bfloat16).to(kv_dtype)
    vp = _pool(rng, (L, 1 + B * pps, page, n_kv, d), cuda_device, torch.bfloat16).to(kv_dtype)
    bt = torch.from_numpy((1 + rng.permutation(B * pps)).reshape(B, pps).astype(np.int32))
    positions = torch.full((B, C), -1, dtype=torch.int32)
    for r, (s0, n) in enumerate(zip(starts, valids)):
        positions[r, :n] = torch.arange(s0, s0 + n)
    bt, positions = bt.to(cuda_device), positions.to(cuda_device)
    kw = dict(scale=d**-0.5, sliding_window=window, softcap=softcap, layer=1)
    before = _routes(paged_prefill_attention_cuda)
    out = paged_prefill_attention_cuda(
        q, kp, vp, bt, torch.tensor(starts, dtype=torch.int32, device=cuda_device),
        torch.tensor(valids, dtype=torch.int32, device=cuda_device), **kw)
    ref = plain.paged_prefill_attention(q, kp, vp, bt, positions, **kw)
    torch.cuda.synchronize()
    _assert_launched_on(paged_prefill_attention_cuda, before, "tensor_core")
    for r, n in enumerate(valids):
        torch.testing.assert_close(out[r, :n].float(), ref[r, :n].float(), rtol=3e-2,
                                   atol=3e-2)
        assert (out[r, n:] == 0).all()


# --- K5 and K4: chunked decode, and its fused KV write ------------------------


def _decode_inputs(rng, device, dtype, *, S, n_heads, n_kv, d, page, pps, L):
    q = _pool(rng, (S, n_heads, d), device, dtype)
    kp = _pool(rng, (L, 1 + S * pps, page, n_kv, d), device, dtype)
    vp = _pool(rng, (L, 1 + S * pps, page, n_kv, d), device, dtype)
    bt = torch.from_numpy((1 + rng.permutation(S * pps)).reshape(S, pps).astype(np.int32))
    return q, kp, vp, bt.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("page,pps,ctx", [
    (8, 5, [3, 8, 27, 40]),  # 5 pages per row: the last chunk is partial
    (16, 7, [0, 1, 16, 112]),  # an inactive row, a full row
])
def test_paged_decode_v2_chunk_padding(cuda_device, dtype, page, pps, ctx):
    rng = np.random.default_rng(page)
    S, n_heads, n_kv, d, L = len(ctx), 8, 2, 128, 2
    q, kp, vp, bt = _decode_inputs(rng, cuda_device, dtype, S=S, n_heads=n_heads, n_kv=n_kv,
                                   d=d, page=page, pps=pps, L=L)
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda_device)
    fn = paged_decode_attention_v2_cuda
    before, routes = fn.launches, _routes(fn)
    out = fn(q, kp, vp, bt, cl, scale=d**-0.5, layer=1)
    ref = plain.paged_decode_attention(q, kp, vp, bt, cl, scale=d**-0.5, layer=1)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_launched_on(fn, routes, _route_of(dtype))
    live = cl > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_decode_v2_dead_chunk_then_live(cuda_device, dtype):
    """A narrow window leaves whole leading chunks dead; a row whose live
    span ends before the page map does leaves trailing chunks dead."""
    rng = np.random.default_rng(6)
    S, n_heads, n_kv, d, page, pps, L = 3, 4, 2, 64, 8, 32, 1
    q, kp, vp, bt = _decode_inputs(rng, cuda_device, dtype, S=S, n_heads=n_heads, n_kv=n_kv,
                                   d=d, page=page, pps=pps, L=L)
    cl = torch.tensor([250, 20, 9], dtype=torch.int32, device=cuda_device)
    kw = dict(scale=d**-0.5, sliding_window=10, layer=0)
    routes = _routes(paged_decode_attention_v2_cuda)
    out = paged_decode_attention_v2_cuda(q, kp, vp, bt, cl, **kw)
    ref = plain.paged_decode_attention(q, kp, vp, bt, cl, **kw)
    _assert_launched_on(paged_decode_attention_v2_cuda, routes, _route_of(dtype))
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "n_heads,n_kv,d,window,softcap",
    [(4, 4, 64, None, None), (16, 2, 128, 13, None), (6, 3, 64, 7, 20.0),
     (8, 4, 256, 64, 50.0)],
)
def test_paged_decode_v3_fused_write(cuda_device, dtype, n_heads, n_kv, d, window, softcap):
    """Output against write_kv_pages + the plain decode; the pools bit-exact
    with that write on every page but the scratch page 0. An inactive row
    (ctx 0) writes nothing."""
    rng = np.random.default_rng(n_heads + d)
    S, page, pps, L, layer = 5, 8, 5, 3, 1
    q, kp, vp, bt = _decode_inputs(rng, cuda_device, dtype, S=S, n_heads=n_heads, n_kv=n_kv,
                                   d=d, page=page, pps=pps, L=L)
    k_new = _pool(rng, (S, n_kv, d), cuda_device, dtype)
    v_new = _pool(rng, (S, n_kv, d), cuda_device, dtype)
    cl = torch.tensor([1, 7, 8, 23, 0], dtype=torch.int32, device=cuda_device)
    kw = dict(scale=d**-0.5, sliding_window=window, softcap=softcap, layer=layer)
    kp_ref, vp_ref = kp.clone(), vp.clone()
    ref, _, _ = plain.paged_decode_attention_fused_write(q, kp_ref, vp_ref, k_new, v_new, bt,
                                                         cl, **kw)
    before, routes = paged_decode_attention_v3_cuda.launches, _routes(paged_decode_attention_v3_cuda)
    out, k_out, v_out = paged_decode_attention_v3_cuda(q, kp, vp, k_new, v_new, bt, cl, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention_v3_cuda.launches == before + 1
    _assert_launched_on(paged_decode_attention_v3_cuda, routes, _route_of(dtype))
    assert k_out is kp and v_out is vp
    live = cl > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert (out[~live] == 0).all()
    assert torch.equal(kp[:, 1:], kp_ref[:, 1:]) and torch.equal(vp[:, 1:], vp_ref[:, 1:])


# --- fp8 (float8_e5m2) pools in the pool-reading kernels ----------------------

FP8 = torch.float8_e5m2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ["v1", "v2", "chunk"])
def test_kernels_read_fp8_pools_as_the_plain_versions(cuda_device, dtype, variant):
    """K1, K5 and K3 over one e5m2 pool against the plain versions on the
    same pool (each element widens exactly to the query dtype)."""
    rng = np.random.default_rng(3)
    S, n_heads, n_kv, d, page, pps, L = 4, 8, 2, 128, 16, 6, 2
    q, kp, vp, bt = _decode_inputs(rng, cuda_device, dtype, S=S, n_heads=n_heads, n_kv=n_kv,
                                   d=d, page=page, pps=pps, L=L)
    kp, vp = kp.to(FP8), vp.to(FP8)
    if variant == "chunk":
        C, starts, valids = 40, [0, 9, 50, 0], [40, 40, 21, 0]
        qc = _pool(rng, (S, C, n_heads, d), cuda_device, dtype)
        positions = torch.full((S, C), -1, dtype=torch.int32)
        for r, (s0, n) in enumerate(zip(starts, valids)):
            positions[r, :n] = torch.arange(s0, s0 + n)
        before = _routes(paged_prefill_attention_cuda)
        out = paged_prefill_attention_cuda(
            qc, kp, vp, bt, torch.tensor(starts, dtype=torch.int32, device=cuda_device),
            torch.tensor(valids, dtype=torch.int32, device=cuda_device), scale=d**-0.5,
            layer=1, softcap=30.0)
        ref = plain.paged_prefill_attention(qc, kp, vp, bt, positions.to(cuda_device),
                                            scale=d**-0.5, layer=1, softcap=30.0)
        _assert_launched_on(paged_prefill_attention_cuda, before, _route_of(dtype))
        for r, n in enumerate(valids):
            torch.testing.assert_close(out[r, :n].float(), ref[r, :n].float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
        return
    fn = paged_decode_attention_cuda if variant == "v1" else paged_decode_attention_v2_cuda
    cl = torch.tensor([0, 5, 33, 96], dtype=torch.int32, device=cuda_device)
    kw = dict(scale=d**-0.5, sliding_window=40, layer=1)
    out = fn(q, kp, vp, bt, cl, **kw)
    ref = plain.paged_decode_attention(q, kp, vp, bt, cl, **kw)
    live = cl > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_write_into_fp8_pool_rounds_like_the_plain_cast(cuda_device, dtype):
    """K4 stores its new rows into an e5m2 pool bit for bit as
    write_kv_pages does: round to nearest even, +-inf past the range (one
    row runs 50,000-70,000, across 57,344 and the 61,440 midpoint)."""
    rng = np.random.default_rng(4)
    S, n_heads, n_kv, d, page, pps, L = 4, 8, 2, 64, 8, 4, 2
    q, kp, vp, bt = _decode_inputs(rng, cuda_device, dtype, S=S, n_heads=n_heads, n_kv=n_kv,
                                   d=d, page=page, pps=pps, L=L)
    kp, vp = kp.to(FP8), vp.to(FP8)
    k_new = _pool(rng, (S, n_kv, d), cuda_device, dtype)
    v_new = _pool(rng, (S, n_kv, d), cuda_device, dtype)
    big = torch.linspace(5.0e4, 7.0e4, n_kv * d, device=cuda_device).reshape(n_kv, d)
    k_new[2], v_new[2] = big.to(dtype), (-big).to(dtype)
    cl = torch.tensor([3, 0, 17, 30], dtype=torch.int32, device=cuda_device)
    kw = dict(scale=d**-0.5, layer=1)
    kp_ref, vp_ref = kp.clone(), vp.clone()
    ref, _, _ = plain.paged_decode_attention_fused_write(q, kp_ref, vp_ref, k_new, v_new, bt,
                                                         cl, **kw)
    routes = _routes(paged_decode_attention_v3_cuda)
    out, _, _ = paged_decode_attention_v3_cuda(q, kp, vp, k_new, v_new, bt, cl, **kw)
    torch.cuda.synchronize()
    _assert_launched_on(paged_decode_attention_v3_cuda, routes, _route_of(dtype))
    as_bits = (lambda t: t[:, 1:].contiguous().view(torch.uint8))  # noqa: E731
    assert torch.equal(as_bits(kp), as_bits(kp_ref)) and torch.equal(as_bits(vp), as_bits(vp_ref))
    stored = kp.float()
    assert torch.isinf(stored).any() and (stored == 57344.0).any()
    rows = torch.tensor([True, False, False, True], device=cuda_device)  # row 2 meets inf
    torch.testing.assert_close(out[rows].float(), ref[rows].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# --- K6 and K7: weight-only int8 / int4 matmuls -------------------------------


def _quant_case(kind, M, K, N, dtype, device, group=128, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=device) / K**0.5
    x = torch.randn((M, K), generator=g, device=device).to(dtype)
    if kind == "int8":
        qt = qm.quantize_array(w.to(dtype), axis=-2, scale_dtype=dtype)
        return x, qt, (qt["q"], qt["scale"])
    qt = qm.quantize_array_int4(w.to(dtype), group_size=group, scale_dtype=dtype)
    return x, qt, (qt["q"], qt["scale"], qt["zero"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,M,K,N,group", [
    ("int8", 8, 32, 48, 0), ("int8", 5, 33, 47, 0), ("int8", 256, 512, 520, 0),
    ("int8", 16, 2048, 256, 0), ("int8", 70, 1000, 100, 0),
    ("int4", 8, 32, 48, 16), ("int4", 16, 128, 64, 128), ("int4", 64, 256, 136, 32),
    ("int4", 16, 2048, 256, 128), ("int4", 33, 96, 30, 32),
])
def test_quant_matmul_kernels_match_f64_and_plain(cuda_device, dtype, kind, M, K, N, group):
    """Ragged M, N and K (no tile divides them), N not a multiple of the
    vector width, decode-sized M with split-K, groups below the tile."""
    x, qt, parts = _quant_case(kind, M, K, N, dtype, cuda_device, group=group or 128, seed=M)
    fn, plain_fn = ((int8_matmul_cuda, plain_mm.int8_matmul) if kind == "int8"
                    else (int4_matmul_cuda, plain_mm.int4_matmul))
    before, routes = fn.launches, _routes(fn)
    out = fn(x, *parts)
    ref = plain_fn(x, *parts)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and out.dtype == dtype and out.shape == (M, N)
    _assert_launched_on(fn, routes, _route_of(dtype))
    if dtype == torch.float32:
        exact = (x.double() @ qt["q"].double()) * qt["scale"].double() if kind == "int8" \
            else x.double() @ qm.dequantize(qt, torch.float32).double()
        rtol, atol = (1e-5, 1e-4) if kind == "int8" else (1e-4, 1e-4)
        torch.testing.assert_close(out.double(), exact, rtol=rtol, atol=atol)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quant_matmul_kernels_read_layer_slices(cuda_device, kind):
    """A layer's weight as a view into the stacked [L, K, N] tensor, at a
    storage offset that breaks the vector loads' alignment."""
    L, M, K, N = 3, 16, 64, 36
    g = torch.Generator(device=cuda_device).manual_seed(1)
    w = torch.randn((L, K, N), generator=g, device=cuda_device) / K**0.5
    qt = (qm.quantize_array(w, axis=-2) if kind == "int8"
          else qm.quantize_array_int4(w, group_size=32))
    x = torch.randn((M, K), generator=g, device=cuda_device)
    for li in range(L):
        layer = {k: t[li] for k, t in qt.items()}
        out = qm.matmul(x, layer, frozenset({kind}))
        ref = plain_mm.int8_matmul(x, layer["q"], layer["scale"]) if kind == "int8" \
            else plain_mm.int4_matmul(x, layer["q"], layer["scale"], layer["zero"])
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_quant_matmul_wrappers_raise_on_bad_inputs(cuda_device):
    x = torch.zeros((4, 64), device=cuda_device)
    q8 = torch.zeros((64, 32), dtype=torch.int8, device=cuda_device)
    s = torch.ones(32, device=cuda_device)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul_cuda(x, q8.float(), s)
    with pytest.raises(ValueError, match="x"):
        int8_matmul_cuda(x[:, :48].contiguous(), q8, s)
    q4 = torch.zeros((32, 32), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="G"):
        int4_matmul_cuda(x, q4, torch.ones((3, 32), device=cuda_device),
                         torch.ones((3, 32), device=cuda_device))


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_model_on_card_matches_cpu(cuda_device, quantize, monkeypatch):
    """A tiny quantized model, f32, both switches on: prefill and decode
    logits on the card (K6 / K7, K2, K1) within 1e-4 of the CPU's (the
    kernels' plain versions), every projection through its kernel."""
    for var in ("LLMQ_INT8_MATMUL", "LLMQ_INT4_MATMUL"):
        monkeypatch.setenv(var, "pallas")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.tiny(vocab_size=128, hidden_size=256, num_layers=2, num_heads=4,
                           num_kv_heads=2, intermediate_size=320, model_type="llama")
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                         quantize=quantize)
    tokens = torch.randint(1, 128, (2, 16), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    lengths = torch.tensor([16, 9], dtype=torch.int32)
    bt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    logits = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = Transformer(cfg, params).to(dev)
        kp, vp = make_kv_pages(cfg, 10, 8, torch.float32, device=dev)
        args = [t.to(dev) for t in (tokens, lengths, bt)]
        before = (int8_matmul_cuda.launches, int4_matmul_cuda.launches)
        pre = model.prefill(args[0], args[1], kp, vp, args[2])
        dec = model.decode(pre.argmax(-1).to(torch.int32), args[1], kp, vp, args[2],
                           torch.ones(2, dtype=torch.bool, device=dev))
        launched = (int8_matmul_cuda.launches - before[0], int4_matmul_cuda.launches - before[1])
        logits[dev.type] = (pre.cpu(), dec.cpu(), launched)
    layers = 7 * cfg.num_layers * 2  # 7 projections per layer, prefill + decode
    want = (layers + 2, 0) if quantize == "int8" else (2, layers)  # the head is int8 (K6)
    assert logits["cuda"][2] == want and logits["cpu"][2] == (0, 0)
    for i in (0, 1):
        torch.testing.assert_close(logits["cuda"][i], logits["cpu"][i], rtol=1e-4, atol=1e-4)


# --- K1 and K7 on their tensor-core routes ------------------------------------


def _decode_tc_case(device, *, S, H, n_kv, d, page, pps, L, ctx, kv_dtype, seed,
                    reverse_pages=False):
    rng = np.random.default_rng(seed)
    P = 1 + S * pps
    if reverse_pages:  # each row's pages in descending pool order
        bt = (P - 1 - np.arange(S * pps)).reshape(S, pps)
    else:
        bt = (1 + rng.permutation(S * pps)).reshape(S, pps)
    q = torch.from_numpy(rng.standard_normal((S, H, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((L, P, page, n_kv, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((L, P, page, n_kv, d)).astype(np.float32))
    return (q.to(device, torch.bfloat16), kp.to(device).to(kv_dtype), vp.to(device).to(kv_dtype),
            torch.from_numpy(bt.astype(np.int32)).to(device),
            torch.tensor(ctx, dtype=torch.int32, device=device))


def _check_decode_tc(q, kp, vp, bt, ctx, fn=paged_decode_attention_cuda, **kw):
    """K1 (or K5, ``fn``) on the tensor-core route against the plain
    version on the same bf16 values, in bf16 (3e-2) and in f32 math (1e-2,
    chip_smoke.py's DECODE_F32_MATH_TOLERANCE); rows with ctx == 0 are
    exact zeros."""
    before = _routes(fn)
    out = fn(q, kp, vp, bt, ctx, **kw)
    ref = plain.paged_decode_attention(q, kp, vp, bt, ctx, **kw)
    layer = kw.pop("layer")
    ref32 = plain.paged_decode_attention(q.float(), kp[layer:layer + 1].float(),
                                         vp[layer:layer + 1].float(), bt, ctx, layer=0, **kw)
    torch.cuda.synchronize()
    _assert_launched_on(fn, before, "tensor_core")
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    live = ctx > 0
    assert (out[~live] == 0).all()
    torch.testing.assert_close(out[live].float(), ref[live].float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(out[live].float(), ref32[live], rtol=1e-2, atol=1e-2)
    return out


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n_heads,n_kv", [(2, 2), (4, 2), (8, 2), (14, 2), (16, 2), (32, 2)],
                         ids=["g1", "g2", "g4", "g7", "g8", "g16"])
def test_paged_decode_tensor_core_groups_dims_and_edges(cuda_device, n_heads, n_kv, d):
    """Groups 1-16, every head_dim, and contexts 0, 1, page - 1, page,
    page + 1 beside a longer row."""
    page = 16
    case = _decode_tc_case(cuda_device, S=6, H=n_heads, n_kv=n_kv, d=d, page=page, pps=8, L=2,
                           ctx=[0, 1, page - 1, page, page + 1, 101], kv_dtype=torch.bfloat16,
                           seed=n_heads * d)
    _check_decode_tc(*case, scale=d**-0.5, layer=1)


@pytest.mark.parametrize("d,n_heads,n_kv,window,softcap", [
    (128, 16, 2, None, None), (128, 8, 2, 13, 30.0), (256, 8, 4, 64, 50.0), (64, 14, 2, 7, None),
])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
def test_paged_decode_tensor_core_window_softcap_fp8(cuda_device, kv_dtype, d, n_heads, n_kv,
                                                      window, softcap):
    case = _decode_tc_case(cuda_device, S=5, H=n_heads, n_kv=n_kv, d=d, page=32, pps=6, L=3,
                           ctx=[0, 1, 31, 90, 192], kv_dtype=kv_dtype, seed=d + n_heads)
    _check_decode_tc(*case, scale=d**-0.5, sliding_window=window, softcap=softcap, layer=2)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
def test_paged_decode_tensor_core_long_row_reversed_pages(cuda_device, kv_dtype):
    """A row of 8,192 keys (the split count at its cap) beside short
    ones, each row's pages in descending pool order."""
    case = _decode_tc_case(cuda_device, S=3, H=16, n_kv=2, d=128, page=32, pps=256, L=1,
                           ctx=[8192, 5000, 3], kv_dtype=kv_dtype, seed=3, reverse_pages=True)
    _check_decode_tc(*case, scale=128**-0.5, layer=0)


def test_paged_decode_tensor_core_is_deterministic(cuda_device):
    """The same launch twice gives the same bits (no atomics, fixed order)."""
    q, kp, vp, bt, ctx = _decode_tc_case(cuda_device, S=16, H=16, n_kv=2, d=128, page=32,
                                         pps=32, L=2, ctx=list(range(60, 1000, 60)),
                                         kv_dtype=torch.bfloat16, seed=11)
    kw = dict(scale=128**-0.5, layer=1)
    a = paged_decode_attention_cuda(q, kp, vp, bt, ctx, **kw)
    b = paged_decode_attention_cuda(q, kp, vp, bt, ctx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _check_int4_tc(x, q, scale, zero):
    before = _routes(int4_matmul_cuda)
    out = int4_matmul_cuda(x, q, scale, zero)
    ref = plain_mm.int4_matmul(x, q, scale, zero)
    torch.cuda.synchronize()
    _assert_launched_on(int4_matmul_cuda, before, "tensor_core")
    assert out.dtype == torch.bfloat16 and out.shape == (x.shape[0], q.shape[1])
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("M", [1, 5, 16, 17, 64, 200, 1024])
@pytest.mark.parametrize("K,N,group", [
    (256, 136, 32), (2048, 256, 128), (96, 30, 32), (1024, 1000, 16), (200, 72, 8),
])
def test_int4_matmul_tensor_core_shapes(cuda_device, M, K, N, group):
    """Every M band (decode kernel up to 16 rows, prefill kernel above),
    ragged N (30, 136, 1,000) and K (96, 200), groups 8 (not a multiple of
    16: the slow scale path), 16, 32 and 128, with split-K."""
    x, _, parts = _quant_case("int4", M, K, N, torch.bfloat16, cuda_device, group=group, seed=M)
    _check_int4_tc(x, *parts)


@pytest.mark.parametrize("M", [16, 300])
def test_int4_matmul_tensor_core_f32_scales(cuda_device, M):
    """bf16 activations over f32 scales and zeros stay on the tensor cores."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    w = torch.randn((512, 264), generator=g, device=cuda_device) / 512**0.5
    qt = qm.quantize_array_int4(w, group_size=128, scale_dtype=torch.float32)
    x = torch.randn((M, 512), generator=g, device=cuda_device).bfloat16()
    _check_int4_tc(x, qt["q"], qt["scale"], qt["zero"])


@pytest.mark.parametrize("K,N,group_size", [(48, 37, 16), (40, 42, 32), (256, 37, 128)])
@pytest.mark.parametrize("M", [16, 100])
def test_int4_matmul_tensor_core_reads_layer_slices(cuda_device, M, K, N, group_size):
    """The bf16 form of test_quant_matmul_kernels_read_layer_slices: each
    layer's q, scale and zero are views into stacked tensors at storage
    offsets that are not 16-byte aligned (odd N, K / 2 * N not a multiple
    of 16), through the model's quantized matmul."""
    L = 3
    g = torch.Generator(device=cuda_device).manual_seed(K + N)
    w = torch.randn((L, K, N), generator=g, device=cuda_device) / K**0.5
    qt = qm.quantize_array_int4(w.bfloat16(), group_size=group_size, scale_dtype=torch.bfloat16)
    x = torch.randn((M, K), generator=g, device=cuda_device).bfloat16()
    assert any(t[li].data_ptr() % 16 for t in qt.values() for li in range(L))
    for li in range(L):
        layer = {k: t[li] for k, t in qt.items()}
        before = _routes(int4_matmul_cuda)
        out = qm.matmul(x, layer, frozenset({"int4"}))
        ref = plain_mm.int4_matmul(x, layer["q"], layer["scale"], layer["zero"])
        torch.cuda.synchronize()
        _assert_launched_on(int4_matmul_cuda, before, "tensor_core")
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


# --- K4 and K6 on their tensor-core routes ------------------------------------


def _check_v3_tc(q, kp, vp, k_new, v_new, bt, ctx, **kw):
    """K4 on the tensor-core route against write_kv_pages + the plain
    decode on the same bf16 values: outputs within 3e-2, and within 1e-2
    of the plain version in f32 math over the pools the kernel left; pools
    bit-exact on every page but the scratch page 0; ctx == 0 rows zeros."""
    kp_ref, vp_ref = kp.clone(), vp.clone()
    ref, _, _ = plain.paged_decode_attention_fused_write(q, kp_ref, vp_ref, k_new, v_new, bt,
                                                         ctx, **kw)
    before = _routes(paged_decode_attention_v3_cuda)
    out, _, _ = paged_decode_attention_v3_cuda(q, kp, vp, k_new, v_new, bt, ctx, **kw)
    layer = kw.pop("layer")
    ref32 = plain.paged_decode_attention(q.float(), kp[layer:layer + 1].float(),
                                         vp[layer:layer + 1].float(), bt, ctx, layer=0, **kw)
    torch.cuda.synchronize()
    _assert_launched_on(paged_decode_attention_v3_cuda, before, "tensor_core")
    as_bits = (lambda t: t[:, 1:].contiguous().view(torch.uint8))  # noqa: E731
    assert torch.equal(as_bits(kp), as_bits(kp_ref)) and torch.equal(as_bits(vp), as_bits(vp_ref))
    live = ctx > 0
    assert (out[~live] == 0).all()
    torch.testing.assert_close(out[live].float(), ref[live].float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(out[live].float(), ref32[live], rtol=1e-2, atol=1e-2)
    return out


def _new_rows(rng, device, S, n_kv, d):
    return tuple(torch.from_numpy(rng.standard_normal((S, n_kv, d)).astype(np.float32))
                 .to(device, torch.bfloat16) for _ in range(2))


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
@pytest.mark.parametrize("page,pps,ctx", [
    (8, 5, [3, 8, 27, 40]),  # the last page of the map partial, a full row
    (16, 7, [0, 1, 16, 112]),  # an inactive row, a full row
])
def test_paged_decode_v3_tensor_core_chunk_padding(cuda_device, kv_dtype, page, pps, ctx):
    """test_paged_decode_v2_chunk_padding on K4's tensor-core route: the
    new row at every tile position, a full page map."""
    n_kv, d = 2, 128
    q, kp, vp, bt, cl = _decode_tc_case(cuda_device, S=len(ctx), H=8, n_kv=n_kv, d=d, page=page,
                                        pps=pps, L=2, ctx=ctx, kv_dtype=kv_dtype, seed=page)
    k_new, v_new = _new_rows(np.random.default_rng(page + 1), cuda_device, len(ctx), n_kv, d)
    _check_v3_tc(q, kp, vp, k_new, v_new, bt, cl, scale=d**-0.5, layer=1)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
def test_paged_decode_v3_tensor_core_dead_chunk_then_live(cuda_device, kv_dtype):
    """test_paged_decode_v2_dead_chunk_then_live on K4's tensor-core route:
    a narrow window leaves the leading tiles dead; a short row leaves the
    trailing ones dead."""
    n_kv, d = 2, 64
    q, kp, vp, bt, cl = _decode_tc_case(cuda_device, S=3, H=4, n_kv=n_kv, d=d, page=8, pps=32,
                                        L=1, ctx=[250, 20, 9], kv_dtype=kv_dtype, seed=6)
    k_new, v_new = _new_rows(np.random.default_rng(7), cuda_device, 3, n_kv, d)
    _check_v3_tc(q, kp, vp, k_new, v_new, bt, cl, scale=d**-0.5, sliding_window=10, layer=0)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
@pytest.mark.parametrize("n_heads,n_kv,d,window,softcap", [
    (4, 4, 64, None, None), (16, 2, 128, 13, None), (6, 3, 64, 7, 20.0), (8, 4, 256, 64, 50.0),
    (32, 2, 128, None, None),
])
def test_paged_decode_v3_tensor_core_fused_write(cuda_device, kv_dtype, n_heads, n_kv, d, window,
                                                 softcap):
    """test_paged_decode_v3_fused_write on the tensor-core route, over bf16
    and e5m2 pools, groups 1-16, every head_dim, and a row of 8,192 keys
    (split-KV at its cap: the new row lands in the last span)."""
    ctx = [1, 7, 8, 23, 0, 8192]
    q, kp, vp, bt, cl = _decode_tc_case(cuda_device, S=6, H=n_heads, n_kv=n_kv, d=d, page=32,
                                        pps=256, L=2, ctx=ctx, kv_dtype=kv_dtype, seed=n_heads + d)
    k_new, v_new = _new_rows(np.random.default_rng(d), cuda_device, 6, n_kv, d)
    _check_v3_tc(q, kp, vp, k_new, v_new, bt, cl, scale=d**-0.5, sliding_window=window,
                 softcap=softcap, layer=1)


def test_paged_decode_v3_tensor_core_is_deterministic(cuda_device):
    """The same K4 launch twice, on two copies of the pools, gives the
    same output and pools bit for bit."""
    q, kp, vp, bt, ctx = _decode_tc_case(cuda_device, S=16, H=16, n_kv=2, d=128, page=32,
                                         pps=32, L=2, ctx=list(range(60, 1000, 60)),
                                         kv_dtype=torch.bfloat16, seed=12)
    k_new, v_new = _new_rows(np.random.default_rng(13), cuda_device, 16, 2, 128)
    kw = dict(scale=128**-0.5, layer=1)
    kp2, vp2 = kp.clone(), vp.clone()
    a, _, _ = paged_decode_attention_v3_cuda(q, kp, vp, k_new, v_new, bt, ctx, **kw)
    b, _, _ = paged_decode_attention_v3_cuda(q, kp2, vp2, k_new, v_new, bt, ctx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)


# --- K5 on its tensor-core route -----------------------------------------------


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
@pytest.mark.parametrize("page,pps,ctx", [
    (8, 5, [3, 8, 27, 40]),  # 5 pages per row: the last chunk is partial
    (16, 7, [0, 1, 16, 112]),  # an inactive row, a full row
    (32, 9, [0, 33, 200, 288]),  # chunks of four 32-key pages, the last partial
])
def test_paged_decode_v2_tensor_core_chunk_padding(cuda_device, kv_dtype, page, pps, ctx):
    """test_paged_decode_v2_chunk_padding on K5's tensor-core route."""
    d = 128
    case = _decode_tc_case(cuda_device, S=len(ctx), H=8, n_kv=2, d=d, page=page, pps=pps, L=2,
                           ctx=ctx, kv_dtype=kv_dtype, seed=page)
    _check_decode_tc(*case, fn=paged_decode_attention_v2_cuda, scale=d**-0.5, layer=1)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
def test_paged_decode_v2_tensor_core_dead_chunk_then_live(cuda_device, kv_dtype):
    """test_paged_decode_v2_dead_chunk_then_live on K5's tensor-core route:
    a narrow window leaves the leading chunks dead; a short row leaves the
    trailing ones dead."""
    d = 64
    case = _decode_tc_case(cuda_device, S=3, H=4, n_kv=2, d=d, page=8, pps=32, L=1,
                           ctx=[250, 20, 9], kv_dtype=kv_dtype, seed=6)
    _check_decode_tc(*case, fn=paged_decode_attention_v2_cuda, scale=d**-0.5, sliding_window=10,
                     layer=0)


def test_paged_decode_v2_tensor_core_is_deterministic(cuda_device):
    """The same K5 launch twice gives the same bits."""
    q, kp, vp, bt, ctx = _decode_tc_case(cuda_device, S=16, H=16, n_kv=2, d=128, page=32,
                                         pps=32, L=2, ctx=list(range(60, 1000, 60)),
                                         kv_dtype=torch.bfloat16, seed=14)
    kw = dict(scale=128**-0.5, layer=1)
    a = paged_decode_attention_v2_cuda(q, kp, vp, bt, ctx, **kw)
    b = paged_decode_attention_v2_cuda(q, kp, vp, bt, ctx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
@pytest.mark.parametrize("H,n_kv,d,page,pps,ctx,window,softcap", [
    (16, 2, 128, 32, 32, list(range(60, 1000, 60)), None, None),  # qwen2.5-3b decode
    (8, 4, 256, 32, 6, [0, 1, 31, 90, 192], 64, 50.0),  # gemma2-2b: window, softcap
    (14, 2, 64, 16, 8, [0, 1, 15, 16, 17, 101], 7, None),
    (16, 2, 128, 32, 256, [8192, 5000, 3], None, None),  # the split count at its cap
])
def test_paged_decode_v2_tensor_core_equals_k1_bit_for_bit(cuda_device, kv_dtype, H, n_kv, d,
                                                           page, pps, ctx, window, softcap):
    """K5's chunk staging (two tiles a warp's ring stage: a block's stage
    is four 32-key pages) changes the grain of the copies, not the order
    of arithmetic: at K1's split plan its output equals K1's bit for bit.
    The wrapper, which sizes the stage from pages_per_chunk (two tiles on
    the e5m2 qwen2.5-3b case), too."""
    from llmq_tpu_torch.ops import _build
    from llmq_tpu_torch.ops import cuda_attention as ca

    q, kp, vp, bt, cl = _decode_tc_case(cuda_device, S=len(ctx), H=H, n_kv=n_kv, d=d, page=page,
                                        pps=pps, L=2, ctx=ctx, kv_dtype=kv_dtype, seed=H + d)
    kw = dict(scale=d**-0.5, layer=1, sliding_window=window, softcap=softcap)
    k1 = paged_decode_attention_cuda(q, kp, vp, bt, cl, **kw)
    chunked = ca._decode_tc(q, kp, vp, None, None, bt, cl, tiles_per_stage=2, **kw)
    k5 = paged_decode_attention_v2_cuda(q, kp, vp, bt, cl, **kw)
    torch.cuda.synchronize()
    tps = ca.decode_tc_tiles_per_stage(len(ctx), n_kv, page, pps, d, kp.element_size(),
                                       _build.sm_count(cuda_device))
    if (H, d, pps) == (16, 128, 32):
        assert tps == (2 if kv_dtype == torch.float8_e5m2 else 1)
    assert torch.equal(chunked.view(torch.int16), k1.view(torch.int16))
    assert torch.equal(k5.view(torch.int16), k1.view(torch.int16))


def _check_int8_tc(x, q, scale):
    before = _routes(int8_matmul_cuda)
    out = int8_matmul_cuda(x, q, scale)
    ref = plain_mm.int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    _assert_launched_on(int8_matmul_cuda, before, "tensor_core")
    assert out.dtype == torch.bfloat16 and out.shape == (x.shape[0], q.shape[1])
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("M", [1, 5, 16, 17, 64, 200, 1024])
@pytest.mark.parametrize("K,N", [(256, 136), (2048, 256), (96, 30), (1000, 1000), (200, 72)])
def test_int8_matmul_tensor_core_shapes(cuda_device, M, K, N):
    """Every M band (decode kernel up to 16 rows, prefill kernel above),
    ragged N (30, 72, 136, 1,000: the plain-load path where N % 16 != 0)
    and K (96, 200, 1,000), split-K at decode and prefill sizes."""
    x, _, parts = _quant_case("int8", M, K, N, torch.bfloat16, cuda_device, seed=M)
    _check_int8_tc(x, *parts)


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 5632), (5632, 2048), (2048, 151936)])
def test_int8_matmul_tensor_core_at_the_moe_shapes(cuda_device, K, N):
    """qwen1.5-moe-a2.7b's 2-D int8 weights at a decode step of 16 rows:
    q/k/v/o, the shared expert's gate/up and down, the untied head."""
    x, _, parts = _quant_case("int8", 16, K, N, torch.bfloat16, cuda_device, seed=K + N)
    _check_int8_tc(x, *parts)


@pytest.mark.parametrize("M", [16, 300])
def test_int8_matmul_tensor_core_f32_scales(cuda_device, M):
    """bf16 activations over f32 scales stay on the tensor cores."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    w = torch.randn((512, 264), generator=g, device=cuda_device) / 512**0.5
    qt = qm.quantize_array(w, axis=-2, scale_dtype=torch.float32)
    x = torch.randn((M, 512), generator=g, device=cuda_device).bfloat16()
    _check_int8_tc(x, qt["q"], qt["scale"])


@pytest.mark.parametrize("K,N", [(48, 37), (40, 42), (256, 264)])
@pytest.mark.parametrize("M", [16, 100])
def test_int8_matmul_tensor_core_reads_layer_slices(cuda_device, M, K, N):
    """The bf16 form of test_quant_matmul_kernels_read_layer_slices for K6:
    each layer's q and scale are views into stacked tensors, at offsets
    that are not 16-byte aligned where K * N or N is not a multiple of 16
    (the plain-load path), aligned for (256, 264) at M = 100 (TMA)."""
    L = 3
    g = torch.Generator(device=cuda_device).manual_seed(K + N)
    w = torch.randn((L, K, N), generator=g, device=cuda_device) / K**0.5
    qt = qm.quantize_array(w.bfloat16(), axis=-2, scale_dtype=torch.bfloat16)
    x = torch.randn((M, K), generator=g, device=cuda_device).bfloat16()
    for li in range(L):
        layer = {k: t[li] for k, t in qt.items()}
        before = _routes(int8_matmul_cuda)
        out = qm.matmul(x, layer, frozenset({"int8"}))
        ref = plain_mm.int8_matmul(x, layer["q"], layer["scale"])
        torch.cuda.synchronize()
        _assert_launched_on(int8_matmul_cuda, before, "tensor_core")
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_int8_matmul_tensor_core_llama_head(cuda_device):
    """llama3.1-8b's untied int8 head at a decode step: K 4,096, N 128,256."""
    x, _, parts = _quant_case("int8", 16, 4096, 128256, torch.bfloat16, cuda_device, seed=8)
    _check_int8_tc(x, *parts)


@pytest.mark.parametrize("M,K,N", [(16, 2048, 11008), (1024, 14336, 4096)])
def test_int8_matmul_tensor_core_is_deterministic(cuda_device, M, K, N):
    """The same K6 launch three times gives the same bits, at a decode
    shape (split-K, combined in order) and a long prefill contraction
    (224 k-tiles through the TMA ring and the queued wgmma)."""
    x, _, parts = _quant_case("int8", M, K, N, torch.bfloat16, cuda_device, seed=9)
    outs = [int8_matmul_cuda(x, *parts) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o.view(torch.int16), outs[0].view(torch.int16)) for o in outs[1:])


# --- the engine's decode-type dispatches as captured CUDA graphs ----------------

GRAPH_MODES = {
    "decode": {},
    "block": dict(decode_block=4),
    "verify": dict(spec_tokens=3, decode_block=2),
    "mixed": dict(mixed_step="on", prefill_chunk_size=32, decode_block=2),
}
GRAPH_REQUESTS = [
    ("g0", "hello world hello world hello", dict(max_tokens=12)),
    ("g1", "abcabcabcabcabc", dict(max_tokens=9)),
    ("s0", "a seeded request", dict(max_tokens=10, temperature=0.8, seed=5)),
    ("f0", "a filtered one", dict(max_tokens=7, temperature=0.6, top_k=5, seed=1)),
    ("g2", "x" * 70, dict(max_tokens=8)),  # a prompt of three chunks under mixed steps
    ("m0", "min tokens", dict(max_tokens=6, min_tokens=3)),
]


#: a small qwen2_moe (routed and shared experts) for the MoE graph tests
MOE_GRAPH_CONFIG = dict(model_type="qwen2_moe", attention_bias=True, num_experts=8,
                        num_experts_per_tok=2, moe_intermediate_size=96,
                        shared_expert_intermediate_size=128)


def _graph_engine(device, cuda_graphs, moe=False, **fields):
    from llmq_tpu_torch.engine.engine import EngineConfig, EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = ModelConfig.tiny(vocab_size=320, hidden_size=256, num_layers=2, num_heads=4,
                           num_kv_heads=2, intermediate_size=320,
                           **(MOE_GRAPH_CONFIG if moe else {}))
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    ecfg = EngineConfig(**{**dict(max_num_seqs=4, max_model_len=128, page_size=16,
                                  num_pages=64, kv_dtype="bf16"), **fields})
    return EngineCore(cfg, params, ByteTokenizer(), engine_config=ecfg, device=device,
                      cuda_graphs=cuda_graphs)


def _serve(core, requests=GRAPH_REQUESTS):
    from llmq_tpu_torch.engine.sampling import SamplingParams

    for rid, prompt, kw in requests:
        core.add_request(rid, prompt=prompt, params=SamplingParams(
            **{"temperature": 0.0, "ignore_eos": True, **kw}))
    outs = {}
    while core.has_work:
        outs.update({o.rid: (o.token_ids, o.finish_reason) for o in core.step()})
    return outs


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_engine_graph_replay_equals_eager(cuda_device, mode):
    """Every decode-type dispatch of the engine is a replay of a captured
    graph, and greedy, seeded, filtered and min_tokens rows come out bit
    for bit as the same engine's eager dispatches give them: plain decode,
    decode blocks, verify blocks (spec + block) and mixed blocks."""
    eager = _serve(_graph_engine(cuda_device, False, **GRAPH_MODES[mode]))
    core = _graph_engine(cuda_device, True, **GRAPH_MODES[mode])
    assert _serve(core) == eager
    st = core.stats()
    assert st["cuda_graphs"]["replays"] == st["decode_dispatches"] > 0
    assert st["cuda_graphs"]["captures"] >= 1
    assert st["cuda_graphs"]["graph_iterations"] == [GRAPH_MODES[mode].get("decode_block", 1)]
    if mode == "mixed":
        assert st["mixed_steps"] > 0
    if mode == "verify":
        assert st["spec_proposed"] > 0


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_moe_engine_graph_replay_equals_eager(cuda_device, mode):
    """An MoE model's decode, decode-block, verify and mixed dispatches are
    each one captured graph (the sync-free expert form: no host read
    inside), replayed, and give the eager engine's tokens bit for bit."""
    eager = _serve(_graph_engine(cuda_device, False, moe=True, **GRAPH_MODES[mode]))
    core = _graph_engine(cuda_device, True, moe=True, **GRAPH_MODES[mode])
    assert _serve(core) == eager
    st = core.stats()
    assert st["cuda_graphs"]["replays"] == st["decode_dispatches"] > 0
    assert st["cuda_graphs"]["graph_iterations"] == [GRAPH_MODES[mode].get("decode_block", 1)]


def test_moe_decode_step_captured_equals_eager_bit_for_bit(cuda_device):
    """One MoE decode step of the model captured as a graph and replayed
    gives the eager step's logits and pools bit for bit."""
    from llmq_tpu_torch.models.transformer import Transformer

    cfg = ModelConfig.tiny(vocab_size=320, hidden_size=256, num_layers=2, num_heads=4,
                           num_kv_heads=2, intermediate_size=320, **MOE_GRAPH_CONFIG)
    model = Transformer(cfg, init_params(cfg, torch.Generator().manual_seed(3),
                                         torch.bfloat16)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    S, page, pps = 4, 16, 4
    pools = make_kv_pages(cfg, 1 + S * pps, page, torch.bfloat16, device=cuda_device)
    for p in pools:
        p.copy_(torch.randn(p.shape, generator=g, device=cuda_device).to(p.dtype))
    tok = torch.randint(1, 320, (S,), generator=g, device=cuda_device, dtype=torch.int32)
    ctx = torch.tensor([5, 17, 40, 0], dtype=torch.int32, device=cuda_device)
    bt = torch.arange(1, 1 + S * pps, dtype=torch.int32, device=cuda_device).reshape(S, pps)
    active = ctx > 0
    start = [p.clone() for p in pools]
    eager = model.decode(tok, ctx, *pools, bt, active)
    eager_pools = [p.clone() for p in pools]
    for p, s0 in zip(pools, start):
        p.copy_(s0)
    model.decode(tok, ctx, *pools, bt, active)  # warm-up
    for p, s0 in zip(pools, start):
        p.copy_(s0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = model.decode(tok, ctx, *pools, bt, active)
    for p, s0 in zip(pools, start):
        p.copy_(s0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert all(torch.equal(a, b) for a, b in zip(pools, eager_pools))


def test_moe_router_ties_on_the_card_pick_the_lower_expert(cuda_device):
    """Exactly tied router logits: the card picks the lower expert ids, as
    ``lax.top_k`` and the CPU path do, and both expert forms agree with
    the CPU's output."""
    from llmq_tpu_torch.models import transformer as tt

    cfg = ModelConfig.tiny(hidden_size=64, num_experts=8, num_experts_per_tok=3,
                           moe_intermediate_size=32, model_type="qwen3_moe",
                           norm_topk_prob=True)
    lp = {k: v[0].clone() for k, v in
          tt.init_params(cfg, torch.Generator().manual_seed(1))["layers"].items()}
    lp["router"][:, [2, 4, 6]] = lp["router"][:, [1]]
    x = torch.randn((40, 64), generator=torch.Generator().manual_seed(2))
    x[:8] = 0.0  # every logit equal
    on_card = {k: v.to(cuda_device) for k, v in lp.items()}
    _, cpu_e = tt.moe_route(x, lp["router"], cfg)
    _, card_e = tt.moe_route(x.to(cuda_device), on_card["router"], cfg)
    assert torch.equal(card_e.cpu(), cpu_e)
    assert card_e[:8].tolist() == [[0, 1, 2]] * 8
    ref = tt._moe_mlp(x, lp, cfg, frozenset(), False)
    for sync_free in (False, True):
        got = tt._moe_mlp(x.to(cuda_device), on_card, cfg, frozenset(), sync_free)
        torch.testing.assert_close(got.cpu(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode,wrapper,per_layer", [
    ("decode", paged_decode_attention_cuda, 1), ("block", paged_decode_attention_cuda, 4),
    ("verify", paged_prefill_attention_cuda, 2),
])
def test_engine_graph_launch_counts_per_replay(cuda_device, mode, wrapper, per_layer):
    """A replay launches no wrapper, so the graph adds the launches its
    capture counted: the layers times the iterations of the block, on the
    tensor-core route, and nothing else."""
    core = _graph_engine(cuda_device, True, **GRAPH_MODES[mode])
    _serve(core, GRAPH_REQUESTS[:2])
    kind = "verify" if mode == "verify" else "decode"
    before = (wrapper.launches, *_routes(wrapper), paged_decode_attention_cuda.launches)
    for _ in range(3):
        core._dispatch_block(kind)
    torch.cuda.synchronize()
    n = 3 * per_layer * core.model_config.num_layers
    after = (wrapper.launches, *_routes(wrapper), paged_decode_attention_cuda.launches)
    assert after[:3] == (before[0] + n, before[1] + n, before[2])
    if wrapper is not paged_decode_attention_cuda:
        assert after[3] == before[3]  # verify blocks never launch K1


def test_engine_graph_recaptures_after_stop_capacity_grows(cuda_device):
    """A request with more stop ids than the state holds widens a leaf:
    the engine drains, resyncs at the new shape and captures again, and
    its tokens still equal the eager engine's."""
    wide = [("w", "stop ids", dict(max_tokens=8, stop_token_ids=tuple(range(300, 312))))]
    outs = []
    for graphs in (False, True):
        core = _graph_engine(cuda_device, graphs)
        first = _serve(core, GRAPH_REQUESTS[:1])
        captures = core.stats()["cuda_graphs"]
        outs.append((first, _serve(core, wide)))
        assert core._stop_capacity == 16
    assert outs[0] == outs[1]
    assert core.stats()["cuda_graphs"]["captures"] == captures["captures"] + 1


def test_engine_graph_capture_failure_raises(cuda_device, monkeypatch):
    """A capture that fails (here: a host read of a device value inside
    the step, which a stream capture forbids) raises out of the step; the
    dispatch is never run eagerly instead."""
    core = _graph_engine(cuda_device, True)
    decode = core.model.decode

    def reads_the_host(*args):
        out = decode(*args)
        out.sum().item()
        return out

    monkeypatch.setattr(core.model, "decode", reads_the_host)
    core.add_request("r", prompt="hello", params=None)
    with pytest.raises(RuntimeError):
        for _ in range(10):
            core.step()
    assert core.decode_dispatches == 0 and core.stats()["cuda_graphs"]["replays"] == 0


# --- the request-state plane (M11): snapshots under captured graphs -------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e5m2], ids=["bf16", "e5m2"])
def test_snapshot_gather_and_in_place_insert_are_bit_exact(cuda_device, dtype):
    """``pages_to_host`` reads a card pool's pages as raw bits, and
    ``pages_from_host`` writes them into other pages of another pool in
    place: same bits, same storage."""
    from llmq_tpu_torch.engine.snapshot import pages_from_host, pages_to_host

    gen = torch.Generator().manual_seed(3)
    pool = torch.randn((3, 12, 16, 2, 128), generator=gen).to(dtype).to(cuda_device)
    raw = torch.int16 if dtype == torch.bfloat16 else torch.uint8
    src = torch.tensor([7, 2, 9], device=cuda_device)
    host = pages_to_host(pool, src)
    want = pool.view(raw)[:, src.cpu()].cpu().numpy()
    assert np.array_equal(host.view(want.dtype), want)
    dst = torch.zeros_like(pool)
    ptr = dst.data_ptr()
    pages_from_host(dst, torch.tensor([1, 5, 11], device=cuda_device), host)
    torch.cuda.synchronize()
    assert dst.data_ptr() == ptr
    assert torch.equal(dst.view(raw)[:, [1, 5, 11]], pool.view(raw)[:, [7, 2, 9]])
    untouched = [i for i in range(12) if i not in (1, 5, 11)]
    assert not dst.view(raw)[:, untouched].any()


def test_snapshot_restore_under_captured_graphs_keeps_the_pools(cuda_device):
    """Extract a request mid-decode and insert it back into the same
    engine: the pools keep their storage, no graph is captured again, and
    the replays after the restore give the eager engine's tokens."""
    from llmq_tpu_torch.engine.sampling import SamplingParams

    req = [("r", "hello world hello world hello", dict(max_tokens=24))]
    want = _serve(_graph_engine(cuda_device, False), req)
    core = _graph_engine(cuda_device, True)
    core.add_request("r", prompt=req[0][1], params=SamplingParams(
        temperature=0.0, ignore_eos=True, max_tokens=24))
    while "r" not in core.scheduler.running or len(core.scheduler.running["r"].output_ids) < 6:
        core.step()
    ptrs = (core.k_pages.data_ptr(), core.v_pages.data_ptr())
    captures = core.stats()["cuda_graphs"]["captures"]
    snap = core.extract_request("r")
    core.insert_request(type(snap).from_bytes(snap.to_bytes()))
    outs = {}
    while core.has_work:
        outs.update({o.rid: (o.token_ids, o.finish_reason) for o in core.step()})
    st = core.stats()
    assert outs == want
    assert (core.k_pages.data_ptr(), core.v_pages.data_ptr()) == ptrs
    assert st["cuda_graphs"]["captures"] == captures and st["kv_restores"] == 1
    assert st["cuda_graphs"]["replays"] == st["decode_dispatches"]


def test_swap_preemption_under_captured_graphs_equals_recompute(cuda_device):
    """On a pool that must preempt, swap preemption under captured graphs
    gives recompute's tokens, with pages swapped out and restored."""
    reqs = [(f"p{i}", f"request {i} " + "ab" * (6 + 3 * i), dict(max_tokens=40))
            for i in range(3)]
    rec = _graph_engine(cuda_device, True, num_pages=12)
    want = _serve(rec, reqs)
    assert rec.scheduler.preemptions > 0
    swap = _graph_engine(cuda_device, True, num_pages=12, preempt_mode="swap")
    assert _serve(swap, reqs) == want
    st = swap.stats()
    assert st["swap_preempts"] >= 1 and st["kv_restores"] >= 1
    assert st["cuda_graphs"]["replays"] == st["decode_dispatches"]


# --- the prefix-KV plane (M11b): the host tier under captured graphs ------------


def _host_tier_serve(core, prompts):
    """Serve ``prompts`` one after the other (greedy, 8 tokens), flushing
    the device prefix cache to the host tier after the first."""
    outs = {}
    for i, (rid, prompt) in enumerate(prompts):
        outs.update(_serve(core, [(rid, prompt, dict(max_tokens=8))]))
        if i == 0:
            core.flush_prefix_to_host()
    return outs


HOST_TIER = dict(prefill_chunk_size=32, enable_prefix_caching=True, prefix_host_gb=0.01)
TEMPLATE_PROMPTS = [("a", "t" * 64 + " first tail"), ("b", "t" * 64 + " second tail")]


def test_prefix_promote_under_captured_graphs_keeps_the_pools(cuda_device):
    """The second prompt's template pages come back from the host tier,
    written into the pools in place: the pools keep their storage, no graph
    is captured again, and the tokens equal the eager engine's."""
    want = _host_tier_serve(_graph_engine(cuda_device, False, **HOST_TIER), TEMPLATE_PROMPTS)
    core = _graph_engine(cuda_device, True, **HOST_TIER)
    first = _host_tier_serve(core, TEMPLATE_PROMPTS[:1])
    ptrs = (core.k_pages.data_ptr(), core.v_pages.data_ptr())
    captures = core.stats()["cuda_graphs"]["captures"]
    outs = {**first, **_serve(core, [(TEMPLATE_PROMPTS[1][0], TEMPLATE_PROMPTS[1][1],
                                      dict(max_tokens=8))])}
    st = core.stats()
    assert outs == want
    assert st["prefix_promotes"] == 4 and st["prefix_demotes"] >= 4  # 64 template positions
    assert (core.k_pages.data_ptr(), core.v_pages.data_ptr()) == ptrs
    assert st["cuda_graphs"]["captures"] == captures
    assert st["cuda_graphs"]["replays"] == st["decode_dispatches"]


def test_prefix_demote_promote_round_trip_is_bit_exact(cuda_device):
    """A template page's bits on the card, demoted to the host and promoted
    into another page, are the same bits (bf16 pools, raw views)."""
    from llmq_tpu_torch.engine.snapshot import pages_to_host

    core = _graph_engine(cuda_device, True, **HOST_TIER)
    _serve(core, [(TEMPLATE_PROMPTS[0][0], TEMPLATE_PROMPTS[0][1], dict(max_tokens=8))])
    cached = dict(core.scheduler._prefix_cache)
    before = {h: (pages_to_host(core.k_pages, torch.tensor([p], device=cuda_device)),
                  pages_to_host(core.v_pages, torch.tensor([p], device=cuda_device)))
              for h, p in cached.items()}
    core.flush_prefix_to_host()
    promoted = []
    promote = core._promote_host_pages

    def spy(admitted):
        promoted.extend((p, h) for s in admitted for p, h, _ in (s.host_restore or ()))
        promote(admitted)

    core._promote_host_pages = spy
    _serve(core, [(TEMPLATE_PROMPTS[1][0], TEMPLATE_PROMPTS[1][1], dict(max_tokens=8))])
    assert len(promoted) == 4
    for page, h in promoted:
        idx = torch.tensor([page], device=cuda_device)
        assert np.array_equal(pages_to_host(core.k_pages, idx), before[h][0])
        assert np.array_equal(pages_to_host(core.v_pages, idx), before[h][1])


def test_torch_worker_under_chaos_on_the_card_equals_its_memory_serve(cuda_device):
    """M6's first part on the card: a ``TorchWorker`` over
    ``chaos+memory://`` (connection kills, duplicate deliveries) answers
    every job with the token ids the same worker gives over plain
    ``memory://``; the session reconnected. f32, the exact routes."""
    import asyncio
    import json

    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.broker.memory import reset_namespace
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.engine.engine import AsyncEngine, EngineConfig, EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    cfg = ModelConfig.tiny(vocab_size=320, hidden_size=256, num_layers=2, num_heads=4,
                           num_kv_heads=2, intermediate_size=320)  # head_dim 64

    jobs = [Job(id=f"g{i}", prompt=f"card chaos {i} " * (1 + i % 3), temperature=0.0,
                max_tokens=6, ignore_eos=True) for i in range(10)]

    async def serve(ns, url, engine):
        plain = BrokerManager(Config(broker_url=f"memory://{ns}", max_redeliveries=1000))
        await plain.connect()
        await plain.setup_queue_infrastructure("gq")
        for job in jobs:
            await plain.publish_job("gq", job)
        worker = TorchWorker("gq", engine, concurrency=8, config=Config(
            broker_url=url, max_redeliveries=1000, reconnect_base_delay_s=0.01,
            reconnect_max_delay_s=0.05, result_digest=True))
        task = asyncio.create_task(worker.run())
        got = {}
        while len(got) < len(jobs):
            assert not task.done()
            msg = await plain.broker.get("gq.results")
            if msg is None:
                await asyncio.sleep(0.01)
                continue
            r = json.loads(msg.body)
            got.setdefault(r["id"], r["token_ids"])
            await msg.ack()
        reconnects = worker.broker.session_stats.reconnects
        worker.request_shutdown()
        await asyncio.wait_for(task, 60)
        await plain.disconnect()
        reset_namespace(ns)
        return got, reconnects

    runs = []
    for ns, url in (("card-plain", "memory://card-plain"),
                    ("card-chaos", "chaos+memory://card-chaos?kill_every=7&dup_every=3&seed=5")):
        # An engine a worker: a worker's drain hands its engine off.
        engine = AsyncEngine(EngineCore(
            cfg, init_params(cfg, torch.Generator().manual_seed(0), torch.float32),
            ByteTokenizer(), device=cuda_device, engine_config=EngineConfig(
                max_num_seqs=8, max_model_len=128, page_size=16, num_pages=80,
                kv_dtype="float32")))
        try:
            runs.append(asyncio.run(serve(ns, url, engine)))
        finally:
            engine.shutdown()
    (plain_tokens, _), (chaos_tokens, reconnects) = runs
    assert chaos_tokens == plain_tokens and reconnects >= 1


def _card_worker_engine(device, **fields):
    from llmq_tpu_torch.engine.engine import AsyncEngine, EngineConfig, EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = ModelConfig.tiny(vocab_size=320, hidden_size=256, num_layers=2, num_heads=4,
                           num_kv_heads=2, intermediate_size=320)
    ecfg = EngineConfig(**{**dict(max_num_seqs=8, max_model_len=384, page_size=16,
                                  num_pages=160, kv_dtype="float32"), **fields})
    return AsyncEngine(EngineCore(
        cfg, init_params(cfg, torch.Generator().manual_seed(0), torch.float32),
        ByteTokenizer(), device=device, engine_config=ecfg))


def test_prefix_pages_ship_between_two_workers_on_the_card(cuda_device):
    """M6's second part on the card (phase 15 (a)'s road, f32, exact
    routes): worker A serves a templated job and advertises its chain;
    worker B, empty, fetches A's pages before it prefills the same prompt,
    promotes them, prefills only the tail, and gives A's token ids."""
    import asyncio

    from llmq_tpu_torch.broker.memory import reset_namespace
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    tier = dict(prefill_chunk_size=32, enable_prefix_caching=True, prefix_host_gb=0.05)
    job = Job(id="t0", prompt=("You are a terse assistant; answer in one line. " * 7)[:300]
              + " Q: the tail?", temperature=0.0, max_tokens=8, ignore_eos=True)
    url = "memory://card-peers"

    async def main():
        workers = []
        for wid in ("card-a", "card-b"):
            w = TorchWorker("pq", _card_worker_engine(cuda_device, **tier), worker_id=wid,
                            config=Config(broker_url=url, prefix_affinity=True))
            await w.initialize()
            w.running = True
            await w._start_extra_consumers()
            workers.append(w)
        a, b = workers
        out_a = await a._process_job(job)
        await a._publish_heartbeat()
        out_b = await b._process_job(job)
        st = b.engine.core.stats()
        for w in workers:
            await w.broker.disconnect()
            w.engine.shutdown()
        reset_namespace("card-peers")
        return out_a, out_b, st, b.prefix_chunks_fetched

    out_a, out_b, st, fetched = asyncio.run(main())
    pages = (len(job.prompt) - 1) // 16
    assert fetched == pages and st["prefix_promotes"] == pages
    assert st["prefill_tokens"] == len(job.prompt) - 16 * pages
    assert list(out_b.token_ids) == list(out_a.token_ids)


def test_prefill_worker_ships_to_a_decode_peer_on_the_card(cuda_device):
    """M6's second part on the card (phase 15 (b)'s road, f32, exact
    routes): with a decode worker beating, a prefill worker offers every
    job to it directly; none takes ``<q>.decode``, and the token ids equal
    a unified engine's."""
    import asyncio
    import json

    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.broker.memory import reset_namespace
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.engine.sampling import SamplingParams
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    jobs = [Job(id=f"h{i}", prompt=f"hand me off {i} " * (1 + i % 3), temperature=0.0,
                max_tokens=8, ignore_eos=True) for i in range(6)]
    url = "memory://card-adopt"

    async def main():
        plain = BrokerManager(Config(broker_url=url))
        await plain.connect()
        dec, pre = (TorchWorker("aq", _card_worker_engine(cuda_device), worker_id=f"card-{r}",
                                config=Config(broker_url=url, worker_role=r, result_digest=True))
                    for r in ("decode", "prefill"))
        tasks = [asyncio.create_task(dec.run())]
        while "card-decode" not in await plain.get_worker_health("aq"):
            await asyncio.sleep(0.01)
        tasks.append(asyncio.create_task(pre.run()))
        for job in jobs:
            await plain.publish_job("aq", job)
        got = {}
        while len(got) < len(jobs):
            msg = await plain.broker.get("aq.results")
            if msg is None:
                await asyncio.sleep(0.01)
                continue
            r = json.loads(msg.body)
            got[r["id"]] = r["token_ids"]
            await msg.ack()
        for w in (pre, dec):
            w.request_shutdown()
        await asyncio.wait_for(asyncio.gather(*tasks), 60)
        await plain.disconnect()
        for w in (pre, dec):
            w.engine.shutdown()
        reset_namespace("card-adopt")
        return got, (pre.handoffs_shipped, pre.handoffs_fallback, dec.jobs_adopted)

    got, counts = asyncio.run(main())
    unified = _card_worker_engine(cuda_device)
    try:
        want = {j.id: list(unified.generate_sync(
            rid=j.id, prompt=j.prompt, timeout=60,
            params=SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)).token_ids)
            for j in jobs}
    finally:
        unified.shutdown()
    assert counts == (len(jobs), 0, len(jobs))
    assert got == want
