"""Plain PyTorch versions of the weight-only quantized matmul kernels.

Port of the function that ``llmq_tpu/ops/pallas_matmul.py`` computes:

- :func:`int8_matmul` — K6 (``int8_matmul_pallas`` :145):
  ``(x @ q) * scale`` with one scale per output channel;
- :func:`int4_matmul` — K7 (``int4_matmul_pallas`` :219): ``x @ w`` with
  ``w = (unpack(q) - zero) * scale`` per group of contraction rows.

Both multiply in the activation dtype and accumulate in f32, as the TPU
kernels do (an int8 value is exact in bf16 and a bf16 x bf16 product is
exact in f32, so an f32 product of the upcast operands is the same
arithmetic), and return ``x.dtype``. The sum is the kernels': an f32
product per tile of ``TILE_K`` contraction rows, the tiles added with
Kahan compensation (the TPU kernels' ``_kahan_add`` across K blocks), so
it stays within the TPU kernel tests' f64 tolerances where one plain f32
product would not. K6 applies its scale once, in f32, after the
contraction. They are the CPU path of the port and the oracle
the CUDA kernels ``csrc/int8_matmul.cu`` and ``csrc/int4_matmul.cu`` are
held against. They are not the dequantize-then-dot fallback of
``models/quant.py::matmul``, which scales in the activation dtype after
the dot, as the JAX package's XLA path does.

The int4 layout helpers live here too, so the models and the kernels'
plain versions share one definition of the affine math
(``models/quant.py`` re-exports them under the JAX package's names).
"""

from __future__ import annotations

import torch

TILE_K = 32  # contraction rows per tile, as csrc/quant_matmul.cuh (kBK)


def unpack_int4(qp: torch.Tensor) -> torch.Tensor:
    """``uint8[..., K//2, N] -> int32[..., K, N]``: even contraction rows
    sit in the low nibble, odd rows in the high one."""
    lo = (qp & 0xF).to(torch.int32)
    hi = (qp >> 4).to(torch.int32)
    stacked = torch.stack([lo, hi], dim=-2)  # [..., K//2, 2, N]
    return stacked.reshape(*qp.shape[:-2], qp.shape[-2] * 2, qp.shape[-1])


def dequantize_int4_parts(
    qp: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """The one affine-dequant definition (``llmq_tpu/models/quant.py``
    :119): unpack, subtract the group's zero-point and scale, all in f32,
    then cast to ``dtype``."""
    q = unpack_int4(qp).float()
    k = q.shape[-2]
    groups = scale.shape[-2]
    group = k // groups
    qg = q.reshape(*q.shape[:-2], groups, group, q.shape[-1])
    deq = (qg - zero.float()[..., :, None, :]) * scale.float()[..., :, None, :]
    return deq.reshape(q.shape).to(dtype)


def _kahan_matmul(x32: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
    """``x32[M, K] @ w32[K, N]`` in f32, summed as the kernels sum it: one
    f32 product per ``TILE_K`` contraction rows, the partial products
    added in order with Kahan compensation."""
    acc = torch.zeros((x32.shape[0], w32.shape[1]), dtype=torch.float32, device=x32.device)
    comp = torch.zeros_like(acc)
    for k0 in range(0, x32.shape[1], TILE_K):
        y = x32[:, k0:k0 + TILE_K] @ w32[k0:k0 + TILE_K] - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x[M, K] @ q[K, N]) * scale[N]`` in ``x.dtype``: the compensated
    f32 contraction of the upcast operands, then the scale in f32."""
    return (_kahan_matmul(x.float(), q.float()) * scale.float()).to(x.dtype)


def int4_matmul(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor
) -> torch.Tensor:
    """``x[M, K] @ dequant(q[K/2, N], scale[G, N], zero[G, N])`` in
    ``x.dtype``: the weight rebuilt in f32 and rounded to ``x.dtype``,
    then the compensated f32 contraction."""
    w = dequantize_int4_parts(q, scale, zero, x.dtype)
    return _kahan_matmul(x.float(), w.float()).to(x.dtype)
