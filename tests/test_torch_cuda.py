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
