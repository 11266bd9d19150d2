"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card
and skips without one (so on a CPU-only machine these count as skipped).
On a GPU machine: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerances: 2e-5 in f32, 3e-2 in bf16, as for the Pallas kernels.
"""

import numpy as np
import pytest
import torch

from llmq_tpu_torch.ops import attention as plain
from llmq_tpu_torch.ops.cuda_attention import (
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
    paged_decode_attention_v2_cuda,
    paged_decode_attention_v3_cuda,
    paged_prefill_attention_cuda,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "n_heads,n_kv,d,window,softcap",
    [(4, 4, 64, None, None), (8, 4, 128, 13, None), (16, 2, 128, None, 50.0),
     (8, 4, 256, 64, 50.0), (14, 2, 64, 7, 30.0)],
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
     (8, 4, 128, 130, 9, None), (8, 4, 256, 70, None, 50.0), (6, 3, 64, 65, 11, 15.0)],
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
    out = flash_prefill_attention_cuda(q, k, v, len_t, **kw)
    ref = plain.full_prefill_attention(q, k, v, lengths=len_t, **kw)
    torch.cuda.synchronize()
    for b, n in enumerate(lengths):
        torch.testing.assert_close(out[b, :n].float(), ref[b, :n].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert (out[b, n:] == 0).all()  # padding rows: zeros


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
    out = paged_prefill_attention_cuda(
        q, kp, vp, bt, torch.tensor(starts, dtype=torch.int32, device=cuda_device),
        torch.tensor(valids, dtype=torch.int32, device=cuda_device), **kw)
    ref = plain.paged_prefill_attention(q, kp, vp, bt, positions, **kw)
    torch.cuda.synchronize()
    assert paged_prefill_attention_cuda.launches == before + 1
    for r, n in enumerate(valids):
        torch.testing.assert_close(out[r, :n].float(), ref[r, :n].float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        assert (out[r, n:] == 0).all()  # padding queries: zeros


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
    before = paged_decode_attention_v2_cuda.launches
    out = paged_decode_attention_v2_cuda(q, kp, vp, bt, cl, scale=d**-0.5, layer=1)
    ref = plain.paged_decode_attention(q, kp, vp, bt, cl, scale=d**-0.5, layer=1)
    torch.cuda.synchronize()
    assert paged_decode_attention_v2_cuda.launches == before + 1
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
    out = paged_decode_attention_v2_cuda(q, kp, vp, bt, cl, **kw)
    ref = plain.paged_decode_attention(q, kp, vp, bt, cl, **kw)
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
    before = paged_decode_attention_v3_cuda.launches
    out, k_out, v_out = paged_decode_attention_v3_cuda(q, kp, vp, k_new, v_new, bt, cl, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention_v3_cuda.launches == before + 1
    assert k_out is kp and v_out is vp
    live = cl > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert (out[~live] == 0).all()
    assert torch.equal(kp[:, 1:], kp_ref[:, 1:]) and torch.equal(vp[:, 1:], vp_ref[:, 1:])
