"""Wrappers of the hand-written CUDA weight-only matmul kernels.

- :func:`int8_matmul_cuda` — K6, the port of
  ``pallas_matmul.py::int8_matmul_pallas``;
- :func:`int4_matmul_cuda` — K7, the port of
  ``pallas_matmul.py::int4_matmul_pallas``.

Each has two routes, chosen by the activation dtype alone
(:func:`int8_route`, :func:`int4_route`): bf16 activations (whatever the
scales' dtype) run on the tensor cores (``csrc/int8_matmul_tc.cu``,
``csrc/int4_matmul_tc.cu`` over ``csrc/quant_tc.cuh``, launch plans from
:func:`int8_tc_plan`, :func:`int4_tc_plan`); f32 activations run the
exact CUDA-core kernels (``csrc/int8_matmul.cu``, ``csrc/int4_matmul.cu``
over ``csrc/quant_matmul.cuh``), which the f32 parity checks need. Each
wrapper counts its routes' launches (``tensor_core_launches``,
``exact_launches``) beside ``launches``.

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
_INT4_TC = ("int4_matmul_tc", "llmq_int4_matmul_tc", [_P] * 6 + [_I] * 8 + [_P])
_INT8_TC = ("int8_matmul_tc", "llmq_int8_matmul_tc", [_P] * 5 + [_I] * 7 + [_P])

#: K6 / K7 routes (:func:`int8_route`, :func:`int4_route`)
TENSOR_CORE, EXACT = "tensor_core", "exact"

# The tensor-core routes' tiles (csrc/int4_matmul_tc.cu, int8_matmul_tc.cu):
# 64-row k-tiles; the decode kernels (kind 0) 16 x 256 output tiles of 256
# threads, two blocks an SM; the prefill kernels (kind 1) 128 x 128 tiles of
# two warpgroups (wgmma), one block an SM (their registers).
TC_TILE_K = 64
TC_DECODE_M, TC_DECODE_N = 16, 256
TC_PREFILL_M, TC_PREFILL_N = 128, 128
TC_DECODE_STAGES = (6, 4, 3, 2)  # ring depths the decode kernels are built for, deepest first
TC_PREFILL_STAGES = 6
SM_SHARED_BYTES = 227 * 1024  # what one Hopper SM gives its blocks
# A block's first copies take ~1 us to land: a split of one k-tile spends
# more time waiting than working (q/o_proj: 32 one-tile splits ran slower
# than 16 of two on the H100).
TC_MIN_TILES_PER_SPLIT = 2


def _tc_decode_stage_bytes(scale_itemsize: int) -> int:
    """Shared bytes of one int4_decode ring stage: 32 packed rows of the
    256-column tile at a 288-byte pitch, the 16 x 64 bf16 x tile, four
    scale rows and four zero rows (csrc DecLayout)."""
    return (32 * (TC_DECODE_N + 32) + TC_DECODE_M * TC_TILE_K * 2
            + 2 * 4 * TC_DECODE_N * scale_itemsize)


def tc_prefill_smem() -> int:
    """Shared bytes of an int4_prefill block (csrc PreLayout): two decoded
    64 x 128 bf16 weight tiles, six ring stages of the 128 x 64 bf16 x
    tile, the 32 packed rows (padded to 5 KB) and four scale / zero rows
    (4 KB), and 1 KB to align the tiles to wgmma's 1,024-byte swizzle."""
    frag = TC_TILE_K * TC_PREFILL_N * 2
    stage = TC_PREFILL_M * TC_TILE_K * 2 + 5 * 1024 + 4096
    return 2 * frag + TC_PREFILL_STAGES * stage + 1024


def tc8_decode_smem(stages: int) -> int:
    """Shared bytes of an int8_decode block (csrc dec_bytes): per ring
    stage the 64 x 256 int8 weight tile and the 16 x 64 bf16 x tile (no
    scale rows) and a TMA barrier, and 1 KB to align the tiles to the
    1,024-byte swizzle."""
    return stages * (TC_TILE_K * TC_DECODE_N + TC_DECODE_M * TC_TILE_K * 2 + 8) + 1024


def tc8_prefill_smem() -> int:
    """Shared bytes of an int8_prefill block (csrc kPreBytes): six ring
    stages of the 128 x 64 bf16 x tile and the 64 x 128 int8 weight tile,
    the Kahan compensations of the block's 128 x 128 sums (f32), a TMA
    barrier a stage, and 1 KB to align the tiles to the 1,024-byte swizzle."""
    stage = TC_PREFILL_M * TC_TILE_K * 2 + TC_TILE_K * TC_PREFILL_N
    return (TC_PREFILL_STAGES * (stage + 8) + TC_PREFILL_M * TC_PREFILL_N * 4 + 1024)


def int4_route(x_dtype: torch.dtype) -> str:
    """K7's route for activations of ``x_dtype``: :data:`TENSOR_CORE` for
    bf16 (the weights are rebuilt in f32 and rounded to bf16 either way,
    so the tensor cores multiply the plain version's values), else
    :data:`EXACT`. A choice by dtype, not a fallback: a tensor-core launch
    that fails raises."""
    return TENSOR_CORE if x_dtype == torch.bfloat16 else EXACT


def int8_route(x_dtype: torch.dtype) -> str:
    """K6's route for activations of ``x_dtype``: :data:`TENSOR_CORE` for
    bf16 (every int8 value is exact in bf16, so the tensor cores multiply
    the plain version's values), else :data:`EXACT`. A choice by dtype,
    not a fallback: a tensor-core launch that fails raises."""
    return TENSOR_CORE if x_dtype == torch.bfloat16 else EXACT


def _tc_plan(M: int, N: int, K: int, sms: int, decode_smem, prefill_smem: int) -> dict:
    """The launch plan of a tensor-core matmul route whose decode block
    takes ``decode_smem(stages)`` bytes and whose prefill block takes
    ``prefill_smem`` (see :func:`int4_tc_plan`)."""
    kind = 0 if M <= TC_DECODE_M else 1
    bm, bn = (TC_DECODE_M, TC_DECODE_N) if kind == 0 else (TC_PREFILL_M, TC_PREFILL_N)
    blocks = -(-N // bn) * -(-M // bm)
    tiles = -(-K // TC_TILE_K)
    per_sm = 2 if kind == 0 else 1
    want = max(1, min(per_sm * sms // max(1, blocks), tiles // TC_MIN_TILES_PER_SPLIT))
    splits = _build.split_count(tiles, want, MAX_SPLITS)
    per_split = -(-tiles // splits) if tiles else 0
    if kind == 1:
        return dict(kind=1, splits=splits, stages=TC_PREFILL_STAGES, smem=prefill_smem)
    resident = min(2, max(1, -(-blocks * splits // sms)))
    stages = TC_DECODE_STAGES[-1]
    for s in TC_DECODE_STAGES:
        if resident * decode_smem(s) <= SM_SHARED_BYTES and s <= max(2, per_split + 1):
            stages = s
            break
    return dict(kind=0, splits=splits, stages=stages, smem=decode_smem(stages))


def int4_tc_plan(M: int, N: int, K: int, sms: int, scale_itemsize: int = 2) -> dict:
    """Launch plan of K7's tensor-core route, a function of shapes and the
    SM count only: ``kind`` (0 = int4_decode for M <= 16, 1 =
    int4_prefill), ``splits`` (K runs of whole 64-row tiles, none empty,
    each at least two tiles long where K has them, as many as keep the
    grid within two decode blocks or one prefill block per SM) and
    ``stages`` (int4_decode's ring depth: the deepest whose blocks all fit
    an SM's shared memory together, no deeper than a split's tiles need;
    ``smem`` its bytes a block)."""
    stage = _tc_decode_stage_bytes(scale_itemsize)
    return _tc_plan(M, N, K, sms, lambda s: s * stage, tc_prefill_smem())


def int8_tc_plan(M: int, N: int, K: int, sms: int) -> dict:
    """Launch plan of K6's tensor-core route (int8_decode for M <= 16,
    int8_prefill above), by :func:`int4_tc_plan`'s rules: a decode stage
    carries twice K7's weight bytes and no scale rows."""
    return _tc_plan(M, N, K, sms, tc8_decode_smem, tc8_prefill_smem())


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
    scale f32 or bf16; on the route :func:`int8_route` gives x's dtype.
    Any shape and storage offset the exact route takes."""
    _require(q.dim() == 2 and q.dtype == torch.int8,
             f"q {tuple(q.shape)} {q.dtype}; want int8 [K, N]")
    K, N = q.shape
    M = _check_x("int8_matmul_cuda", x, K)
    _require(scale.shape == (N,) and scale.dtype in _DTYPES,
             f"scale {tuple(scale.shape)} {scale.dtype}; want f32/bf16 [{N}]")
    for t in (q, scale):
        _require(t.device == x.device and t.is_contiguous(), "q, scale: contiguous, on x's device")
    route = int8_route(x.dtype)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scale_bf16 = int(scale.dtype == torch.bfloat16)
    if route == TENSOR_CORE:
        fn = _build.function(*_INT8_TC)
        plan = int8_tc_plan(M, N, K, _build.sm_count(x.device))
        part = _scratch(plan["splits"], M, N, x.device)
        code = fn(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), scale_bf16, plan["kind"], M, N, K,
            plan["splits"], plan["stages"], stream,
        )
        _build.check(_INT8_TC[0], code)
    else:
        fn = _build.function(*_INT8)
        splits = matmul_splits(M, N, K, x.device)
        part = _scratch(splits, M, N, x.device)
        code = fn(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), int(x.dtype == torch.bfloat16),
            scale_bf16, M, N, K, splits, stream,
        )
        _build.check(_INT8[0], code)
    _build.count_launch(int8_matmul_cuda, route)
    return out


int8_matmul_cuda.launches = 0
int8_matmul_cuda.tensor_core_launches = 0
int8_matmul_cuda.exact_launches = 0


def int4_matmul_cuda(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor
) -> torch.Tensor:
    """K7: ``x[M, K] @ ((unpack(q) - zero) * scale)`` in ``x.dtype``; q
    uint8 ``[K/2, N]``, scale and zero ``[G, N]`` in one dtype, f32 or
    bf16, with ``G`` dividing ``K``; on the route :func:`int4_route` gives
    x's dtype. Any shape, group and storage offset the exact route takes."""
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
    route = int4_route(x.dtype)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == TENSOR_CORE:
        fn = _build.function(*_INT4_TC)
        plan = int4_tc_plan(M, N, K, _build.sm_count(x.device), scale.element_size())
        part = _scratch(plan["splits"], M, N, x.device)
        code = fn(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), int(scale.dtype == torch.bfloat16),
            plan["kind"], M, N, K, K // G, plan["splits"], plan["stages"], stream,
        )
        _build.check(_INT4_TC[0], code)
    else:
        fn = _build.function(*_INT4)
        splits = matmul_splits(M, N, K, x.device)
        part = _scratch(splits, M, N, x.device)
        code = fn(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16), M, N, K, K // G,
            splits, stream,
        )
        _build.check(_INT4[0], code)
    _build.count_launch(int4_matmul_cuda, route)
    return out


int4_matmul_cuda.launches = 0
int4_matmul_cuda.tensor_core_launches = 0
int4_matmul_cuda.exact_launches = 0
