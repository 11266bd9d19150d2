"""Wrappers of the hand-written CUDA weight-only matmul kernels.

- :func:`int8_matmul_cuda` — K6, ``csrc/int8_matmul.cu``, the port of
  ``pallas_matmul.py::int8_matmul_pallas``;
- :func:`int4_matmul_cuda` — K7, the port of
  ``pallas_matmul.py::int4_matmul_pallas``.

K7 has two routes, chosen by the activation dtype alone in
:func:`int4_route`: bf16 activations (whatever the scales' dtype) run on
the tensor cores (``csrc/int4_matmul_tc.cu``, launch plan from
:func:`int4_tc_plan`); f32 activations run the exact CUDA-core kernel
(``csrc/int4_matmul.cu`` over ``csrc/quant_matmul.cuh``), which the f32
parity checks need. K7 counts each route's launches
(``tensor_core_launches``, ``exact_launches``) beside ``launches``. K6
keeps its one CUDA-core route.

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

#: K7 routes (:func:`int4_route`)
TENSOR_CORE, EXACT = "tensor_core", "exact"

# The tensor-core route's tiles (csrc/int4_matmul_tc.cu): 64-row k-tiles;
# int4_decode (kind 0) 16 x 256 output tiles of 256 threads, two blocks an
# SM; int4_prefill (kind 1) 128 x 128 tiles of two warpgroups (wgmma), one
# block an SM (its registers).
TC_TILE_K = 64
TC_DECODE_M, TC_DECODE_N = 16, 256
TC_PREFILL_M, TC_PREFILL_N = 128, 128
TC_DECODE_STAGES = (6, 4, 3, 2)  # ring depths int4_decode is built for, deepest first
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


def int4_route(x_dtype: torch.dtype) -> str:
    """K7's route for activations of ``x_dtype``: :data:`TENSOR_CORE` for
    bf16 (the weights are rebuilt in f32 and rounded to bf16 either way,
    so the tensor cores multiply the plain version's values), else
    :data:`EXACT`. A choice by dtype, not a fallback: a tensor-core launch
    that fails raises."""
    return TENSOR_CORE if x_dtype == torch.bfloat16 else EXACT


def int4_tc_plan(M: int, N: int, K: int, sms: int, scale_itemsize: int = 2) -> dict:
    """Launch plan of K7's tensor-core route, a function of shapes and the
    SM count only: ``kind`` (0 = int4_decode for M <= 16, 1 =
    int4_prefill), ``splits`` (K runs of whole 64-row tiles, none empty,
    each at least two tiles long where K has them, as many as keep the
    grid within two decode blocks or one prefill block per SM) and
    ``stages`` (int4_decode's ring depth: the deepest whose blocks all fit
    an SM's shared memory together, no deeper than a split's tiles need;
    ``smem`` its bytes a block)."""
    kind = 0 if M <= TC_DECODE_M else 1
    bm, bn = (TC_DECODE_M, TC_DECODE_N) if kind == 0 else (TC_PREFILL_M, TC_PREFILL_N)
    blocks = -(-N // bn) * -(-M // bm)
    tiles = -(-K // TC_TILE_K)
    per_sm = 2 if kind == 0 else 1
    want = max(1, min(per_sm * sms // max(1, blocks), tiles // TC_MIN_TILES_PER_SPLIT))
    splits = _build.split_count(tiles, want, MAX_SPLITS)
    per_split = -(-tiles // splits) if tiles else 0
    if kind == 1:
        return dict(kind=1, splits=splits, stages=TC_PREFILL_STAGES, smem=tc_prefill_smem())
    resident = min(2, max(1, -(-blocks * splits // sms)))
    stage = _tc_decode_stage_bytes(scale_itemsize)
    stages = TC_DECODE_STAGES[-1]
    for s in TC_DECODE_STAGES:
        if resident * s * stage <= SM_SHARED_BYTES and s <= max(2, per_split + 1):
            stages = s
            break
    return dict(kind=0, splits=splits, stages=stages, smem=stages * stage)


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
    int4_matmul_cuda.launches += 1
    if route == TENSOR_CORE:
        int4_matmul_cuda.tensor_core_launches += 1
    else:
        int4_matmul_cuda.exact_launches += 1
    return out


int4_matmul_cuda.launches = 0
int4_matmul_cuda.tensor_core_launches = 0
int4_matmul_cuda.exact_launches = 0
