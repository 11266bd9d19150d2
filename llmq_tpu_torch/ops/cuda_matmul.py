"""Wrappers of the hand-written CUDA weight-only matmul kernels.

- :func:`int8_matmul_cuda` — K6, ``csrc/int8_matmul.cu``, the port of
  ``pallas_matmul.py::int8_matmul_pallas``;
- :func:`int4_matmul_cuda` — K7, ``csrc/int4_matmul.cu``, the port of
  ``pallas_matmul.py::int4_matmul_pallas``.

As in ``ops/cuda_attention.py``: CUDA tensors only, each wrapper launches
its kernel on the current stream or raises (no fallback), the choice
between a kernel and its plain version (``ops/matmul.py``) is made in
``ops/dispatch.py``, and each wrapper carries a plain-int ``launches``
counter, incremented once per call that launches the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from llmq_tpu_torch.ops import _build

TILE_N = 64  # output columns per block (csrc/quant_matmul.cuh kBN)
TILE_K = 32  # contraction rows per tile (kBK)
MIN_TILES_PER_SPLIT = 4
MAX_SPLITS = 32
_DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_INT8 = ("int8_matmul", "llmq_int8_matmul", [_P] * 5 + [_I] * 6 + [_P])
_INT4 = ("int4_matmul", "llmq_int4_matmul", [_P] * 6 + [_I] * 7 + [_P])


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def matmul_splits(M: int, N: int, K: int, device: torch.device) -> int:
    """K runs per output tile: enough blocks for two per SM, each run at
    least ``MIN_TILES_PER_SPLIT`` K tiles long. A function of shapes only."""
    bm = 16 if M <= 16 else 64
    blocks = -(-N // TILE_N) * -(-M // bm)
    tiles = -(-K // TILE_K)
    if tiles == 0:
        return 1
    want = -(-2 * _build.sm_count(device) // max(1, blocks))
    splits = max(1, min(want, tiles // MIN_TILES_PER_SPLIT, MAX_SPLITS))
    return -(-tiles // -(-tiles // splits))  # no empty run


def _check_x(name: str, x: torch.Tensor, K: int) -> int:
    _require(x.is_cuda, f"{name} takes CUDA tensors")
    _require(x.dim() == 2 and x.shape[1] == K, f"x {tuple(x.shape)}; want [M, {K}]")
    _require(x.dtype in _DTYPES, f"x dtype {x.dtype}; want f32 or bf16")
    _require(x.is_contiguous(), f"{name} takes a contiguous x")
    return x.shape[0]


def _scratch(splits: int, M: int, N: int, device: torch.device):
    if splits == 1:
        return None
    return torch.empty(splits * M * N, dtype=torch.float32, device=device)


def int8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K6: ``(x[M, K] @ q[K, N]) * scale[N]`` in ``x.dtype``; q int8,
    scale f32 or bf16."""
    _require(q.dim() == 2 and q.dtype == torch.int8,
             f"q {tuple(q.shape)} {q.dtype}; want int8 [K, N]")
    K, N = q.shape
    M = _check_x("int8_matmul_cuda", x, K)
    _require(scale.shape == (N,) and scale.dtype in _DTYPES,
             f"scale {tuple(scale.shape)} {scale.dtype}; want f32/bf16 [{N}]")
    for t in (q, scale):
        _require(t.device == x.device and t.is_contiguous(), "q, scale: contiguous, on x's device")
    fn = _build.function(*_INT8)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    splits = matmul_splits(M, N, K, x.device)
    part = _scratch(splits, M, N, x.device)
    code = fn(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16), M, N, K, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("int8_matmul", code)
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0


def int4_matmul_cuda(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor
) -> torch.Tensor:
    """K7: ``x[M, K] @ ((unpack(q) - zero) * scale)`` in ``x.dtype``; q
    uint8 ``[K/2, N]``, scale and zero ``[G, N]`` in one dtype, f32 or
    bf16, with ``G`` dividing ``K``."""
    _require(q.dim() == 2 and q.dtype == torch.uint8,
             f"q {tuple(q.shape)} {q.dtype}; want packed uint8 [K/2, N]")
    K, N = 2 * q.shape[0], q.shape[1]
    M = _check_x("int4_matmul_cuda", x, K)
    G = scale.shape[0] if scale.dim() == 2 else 0
    _require(scale.dim() == 2 and scale.shape[1] == N and zero.shape == scale.shape
             and G > 0 and K % G == 0,
             f"scale {tuple(scale.shape)} zero {tuple(zero.shape)}; want [G, {N}], G | {K}")
    _require(scale.dtype in _DTYPES and zero.dtype == scale.dtype,
             f"scale {scale.dtype} zero {zero.dtype}; want one of f32/bf16")
    for t in (q, scale, zero):
        _require(t.device == x.device and t.is_contiguous(),
                 "q, scale, zero: contiguous, on x's device")
    fn = _build.function(*_INT4)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    splits = matmul_splits(M, N, K, x.device)
    part = _scratch(splits, M, N, x.device)
    code = fn(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16), M, N, K, K // G,
        splits, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("int4_matmul", code)
    int4_matmul_cuda.launches += 1
    return out


int4_matmul_cuda.launches = 0
