"""Wrappers of the hand-written CUDA attention kernels (``ops/csrc``).

- :func:`paged_decode_attention_cuda` — K1, the port of
  ``pallas_attention.py::paged_decode_attention_pallas``.
- :func:`flash_prefill_attention_cuda` — K2, the port of
  ``pallas_attention.py::flash_prefill_attention_pallas``.
- :func:`paged_prefill_attention_cuda` — K3, the port of
  ``pallas_attention.py::paged_prefill_attention_pallas``.
- :func:`paged_decode_attention_v2_cuda` — K5, and
  :func:`paged_decode_attention_v3_cuda` — K4, the ports of
  ``pallas_attention.py::paged_decode_attention_pallas_v2`` / ``_v3``.

Every kernel has two routes, chosen by dtype alone in
:func:`attention_route`: bf16 queries over bf16 or float8_e5m2 K/V run on the tensor
cores (``csrc/paged_decode_tc.cu`` for K1, for K4 with its fused write
and for K5 with a chunk of pages a ring stage, launch plan from
:func:`decode_tc_plan`; ``csrc/flash_prefill_tc.cu`` and
``csrc/paged_prefill_tc.cu`` over ``csrc/attn_tc.cuh``); f32 queries, or
an f32 pool, run the exact CUDA-core kernels (``csrc/paged_decode.cu``,
``csrc/flash_prefill.cu``, ``csrc/paged_prefill.cu``,
``csrc/paged_decode_v2.cu`` for K4 and K5).
Each route counts its own launches (``tensor_core_launches``,
``exact_launches``) beside the wrapper's ``launches``.

Pools may be f32, bf16 or float8_e5m2 (K2 reads fresh K/V in the
compute dtype and has no pool). The wrappers take CUDA tensors only: each launches its kernel on the
current stream or raises — there is no fallback. The choice between a
kernel and its plain PyTorch version (``ops/attention.py``) is made in
one place, ``ops/dispatch.py``, by the device of the tensors. Each
wrapper carries a plain-int ``launches`` counter, incremented once per
kernel launch and nowhere else, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from llmq_tpu_torch.ops import _build

WINDOW_DISABLED = 1 << 30
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16  # query heads per KV head the decode kernel holds
DECODE_TILE = 32  # keys per tile of the decode kernel
MAX_SPLITS = 32
MAX_PAGES_PER_CHUNK = 4  # the TPU kernel's pages_per_chunk default
SM_SHARED_BYTES = 228 * 1024  # shared memory of one Hopper SM (1 KB of it per block reserved)
_DTYPES = (torch.float32, torch.bfloat16)
#: pool dtype -> the kernels' kv_dtype code (an fp8 pool widens exactly)
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e5m2: 2}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "paged_decode": ("llmq_paged_decode", [_P] * 7 + [_I] * 11 + [_F, _F, _I, _P]),
    "paged_decode_tc": ("llmq_paged_decode_tc",
                        [_P] * 10 + [_I] * 10 + [_F, _F, _I, _I, _I, _P]),
    "flash_prefill": ("llmq_flash_prefill", [_P] * 5 + [_I] * 5 + [_L] * 12 + [_I, _F, _F, _P]),
    "flash_prefill_tc": ("llmq_flash_prefill_tc",
                         [_P] * 5 + [_I] * 5 + [_L] * 12 + [_I, _F, _F, _P]),
    "paged_prefill": ("llmq_paged_prefill", [_P] * 7 + [_I] * 11 + [_L] * 3 + [_I, _F, _F, _P]),
    "paged_prefill_tc": ("llmq_paged_prefill_tc",
                         [_P] * 7 + [_I] * 10 + [_L] * 3 + [_I, _F, _F, _P]),
    "paged_decode_v2": ("llmq_paged_decode_v2", [_P] * 9 + [_I] * 13 + [_F, _F, _I, _P]),
}


#: routes of the attention kernels (:func:`attention_route`)
TENSOR_CORE, EXACT = "tensor_core", "exact"
_TC_KV = (torch.bfloat16, torch.float8_e5m2)

# K1's, K4's and K5's tensor-core route (csrc/paged_decode_tc.cu): 4 warps a
# block, each walking every fourth 16-key tile of the block's span through
# its own ring of raw K/V rows, 1 to 3 stages deep, a stage 1 tile (K1, K4)
# or 1-2 (K5).
DECODE_TC_TILE = 16
DECODE_TC_WARPS = 4
DECODE_TC_STAGES = (1, 2, 3)  # ring depths the kernel is built for
DECODE_TC_MAX_TPS = 2  # tiles a warp's stage may hold (a stage's lookups: one lane a key)


def _kernel(name: str):
    return _build.function(name, *_SIGNATURES[name])


_counters: Dict[Tuple[Optional[int], int], torch.Tensor] = {}


def _split_counters(n: int, device: torch.device) -> torch.Tensor:
    """``n`` int32 zeros on ``device`` for K1's tensor-core route: its spans
    count themselves in, and the last one resets its counter, so the
    buffer is zero again after every launch. Kept per (device, ``n``) and
    never freed: a captured CUDA graph holds its address."""
    buf = _counters.get((device.index, n))
    if buf is None:
        buf = _counters[(device.index, n)] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf




def attention_route(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The route of the attention kernels K1-K5 for queries of
    ``q_dtype`` over K/V of ``kv_dtype`` (K2: q's own dtype):
    :data:`TENSOR_CORE` for bf16 queries over bf16 or float8_e5m2 K/V (an
    e5m2 value widens exactly to bf16), else :data:`EXACT`: f32 queries,
    or an f32 pool, which promotes the math to f32 — a precision bf16
    tensor cores cannot hold. A choice by dtype, not a fallback: a
    tensor-core launch that fails raises."""
    return TENSOR_CORE if q_dtype == torch.bfloat16 and kv_dtype in _TC_KV else EXACT


def _check_rows_aligned(name: str, **tensors) -> None:
    """The tensor-core kernels copy 16-byte words: each tensor's base and
    its batch, time and head strides must be 16-byte aligned."""
    for what, t in tensors.items():
        item = t.element_size()
        _require(t.data_ptr() % 16 == 0 and all(s * item % 16 == 0 for s in t.stride()[:3]),
                 f"{name}: {what} rows must be 16-byte aligned for the tensor-core route "
                 f"(data_ptr % 16 = {t.data_ptr() % 16}, strides {tuple(t.stride())} of "
                 f"{item}-byte elements)")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _window(sliding_window: Optional[int]) -> int:
    return WINDOW_DISABLED if sliding_window is None else min(int(sliding_window), 2**31 - 1)


def _softcap(softcap: Optional[float]) -> float:
    return 0.0 if softcap is None else float(softcap)




def _tc_split_target(num_seqs: int, n_kv: int, max_ctx: int, sms: int) -> int:
    """K1's tensor-core route: spans of at least one 16-key tile for each
    of its 4 warps, and no more blocks than two per SM."""
    want = max(1, 2 * sms // max(1, num_seqs * n_kv))
    return max(1, min(want, -(-max_ctx // (DECODE_TC_TILE * DECODE_TC_WARPS))))


def decode_splits(
    num_seqs: int, n_kv: int, max_ctx: int, device: torch.device, tile: int = DECODE_TILE
) -> int:
    """Blocks per (sequence, KV head) for a decode kernel: enough for two
    blocks per SM, never more than the page map has key tiles of ``tile``
    keys. A function of shapes only, so every layer of a step launches the
    same grid."""
    sms = _build.sm_count(device)
    want = -(-2 * sms // max(1, num_seqs * n_kv))
    return max(1, min(want, -(-max_ctx // tile), MAX_SPLITS))


def decode_tc_smem(head_dim: int, kv_itemsize: int, stages: int, tiles_per_stage: int = 1) -> int:
    """Shared bytes of a tensor-core decode block (csrc Layout): the
    group's 16 bf16 query rows, then the larger of the warps' rings (per
    stage ``tiles_per_stage`` raw K and V tiles of 16 rows) and the
    end-of-loop merge (each warp's f32 acc and (m, l) per row, and per row
    the warps' weights and sum), and a flag."""
    ring = (DECODE_TC_WARPS * stages * tiles_per_stage * 2 * DECODE_TC_TILE * head_dim
            * kv_itemsize)
    merge = 4 * (DECODE_TC_WARPS * MAX_GROUP * (head_dim + 2) + MAX_GROUP * (DECODE_TC_WARPS + 1))
    return MAX_GROUP * head_dim * 2 + max(ring, merge) + 16  # + the last-span flag


def decode_tc_plan(num_seqs: int, n_kv: int, max_ctx: int, head_dim: int, kv_itemsize: int,
                   sms: int, tiles_per_stage: int = 1) -> dict:
    """Launch plan of the tensor-core decode route, a function of shapes,
    the SM count and the tiles a ring stage holds only: ``splits`` (spans
    of at least one 16-key tile for each of the 4 warps, no more blocks
    than two per SM, none empty for a row that fills the page map; the
    same for every ``tiles_per_stage``) and ``stages`` (the per-warp ring
    depth: one more than a warp's stages, at most 3, cut while the grid's
    blocks per SM do not fit its shared memory together; ``smem`` its
    bytes a block)."""
    tiles = max(1, -(-max_ctx // DECODE_TC_TILE))
    splits = _build.split_count(tiles, _tc_split_target(num_seqs, n_kv, max_ctx, sms),
                                MAX_SPLITS)
    warp_tiles = -(-(-(-tiles // splits)) // DECODE_TC_WARPS)
    warp_stages = -(-warp_tiles // tiles_per_stage)
    resident = min(3, max(1, -(-num_seqs * n_kv * splits // sms)))
    stages = min(warp_stages + 1, DECODE_TC_STAGES[-1])

    def smem(n: int) -> int:
        return decode_tc_smem(head_dim, kv_itemsize, n, tiles_per_stage)

    while stages > 1 and resident * (smem(stages) + 1024) > SM_SHARED_BYTES:
        stages -= 1
    return dict(splits=splits, stages=stages, smem=smem(stages), tiles_per_stage=tiles_per_stage)


def decode_tc_tiles_per_stage(num_seqs: int, n_kv: int, page_size: int, pages_per_seq: int,
                              head_dim: int, kv_itemsize: int, sms: int) -> int:
    """K5's ring stage on the tensor-core route: 16-key tiles a warp's
    stage holds, so that the 4 warps' stage together is the chunk of
    whole pages, ``pages_per_chunk`` of them (sized to the blocks an SM
    must hold at K1's split plan, each with a double buffer of chunks), at
    most :data:`DECODE_TC_MAX_TPS` tiles. Where no double buffer of 128
    keys fits (bf16 rows of 256 bytes beside another block, the main
    path's shape), that is 1: K1's plan, which the H100 ran faster than a
    single-buffered chunk (PERF.md §6)."""
    splits = decode_tc_plan(num_seqs, n_kv, pages_per_seq * page_size, head_dim, kv_itemsize,
                            sms)["splits"]
    resident = -(-num_seqs * n_kv * splits // sms)
    ppc = pages_per_chunk(page_size, head_dim, kv_itemsize, resident, tensor_core=True)
    block_tiles = ppc * page_size // DECODE_TC_TILE
    return max(1, min(DECODE_TC_MAX_TPS, block_tiles // DECODE_TC_WARPS))


def pages_per_chunk(page_size: int, head_dim: int, kv_itemsize: int, blocks_per_sm: int,
                    tensor_core: bool = False) -> int:
    """Pages the v2/v3 decode kernel stages per step: as many (1 to the TPU
    kernel's 4) as let ``blocks_per_sm`` blocks share one SM's shared
    memory, so a grid of that many blocks per SM runs in one wave. On the
    exact route a block holds its f32 query rows and softmax state, then
    per staged key two stages of K and V rows (pitch head_dim + 16 bytes)
    and one f32 score per query head; on the tensor-core route its bf16
    query rows, then per staged key two stages (the TPU kernel's double
    buffer) of one K and one V row of the pool."""
    if tensor_core:
        fixed = MAX_GROUP * head_dim * 2 + 16 + 1024
        per_page = page_size * 2 * 2 * head_dim * kv_itemsize
    else:
        fixed = 4 * MAX_GROUP * (head_dim + 3) + 1024
        per_page = page_size * (4 * (head_dim * kv_itemsize + 16) + 4 * MAX_GROUP)
    budget = SM_SHARED_BYTES // max(1, blocks_per_sm) - fixed
    return max(1, min(MAX_PAGES_PER_CHUNK, budget // per_page))


def _check_dtypes(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    _require(q.dtype in _DTYPES and k_pages.dtype in _KV_CODES
             and v_pages.dtype == k_pages.dtype,
             f"dtypes q={q.dtype} pools={k_pages.dtype}/{v_pages.dtype}; want q f32/bf16 and "
             "pools f32/bf16/float8_e5m2")


def _check_decode(
    name: str,
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    layer: int,
) -> None:
    """The decode kernels' shared argument checks (K1, K5, K4)."""
    _require(q.is_cuda, f"{name} takes CUDA tensors")
    _require(k_pages.dim() == 5, "k_pages must be a layer-stacked [L, P, page, n_kv, d] pool")
    S, n_heads, d = q.shape
    L, P, page_size, n_kv, d_kv = k_pages.shape
    _require(v_pages.shape == k_pages.shape, "k_pages and v_pages differ in shape")
    _require(d == d_kv and d in HEAD_DIMS, f"head_dim {d} (pool {d_kv}); want one of {HEAD_DIMS}")
    _require(n_heads % n_kv == 0 and n_heads // n_kv <= MAX_GROUP,
             f"{n_heads} query heads over {n_kv} KV heads (group <= {MAX_GROUP})")
    _check_dtypes(q, k_pages, v_pages)
    _require(block_tables.dtype == torch.int32 and context_lens.dtype == torch.int32,
             "block_tables and context_lens must be int32")
    _require(block_tables.shape[0] == S and context_lens.shape == (S,), "batch mismatch")
    for t in (k_pages, v_pages, block_tables, context_lens):
        _require(t.device == q.device, "all tensors must be on q's device")
    for t in (q, k_pages, v_pages, block_tables, context_lens):
        _require(t.is_contiguous(), f"{name} takes contiguous tensors")
    _require(0 <= int(layer) < L, f"layer {layer} outside the {L}-layer pool")


def _decode_tc(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: Optional[torch.Tensor],
    v_new: Optional[torch.Tensor],
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int],
    softcap: Optional[float],
    tiles_per_stage: int = 1,
) -> torch.Tensor:
    """Launch of ``csrc/paged_decode_tc.cu``: K1, or K4 when ``k_new`` is
    given (the pools are written in place), or K5 with ``tiles_per_stage``
    > 1 (the same arithmetic as K1's at the same plan)."""
    S, n_heads, d = q.shape
    _, P, page_size, n_kv, _ = k_pages.shape
    pps = block_tables.shape[1]
    rows = (q, k_pages, v_pages) + ((k_new, v_new) if k_new is not None else ())
    _require(all(t.data_ptr() % 16 == 0 for t in rows),
             "the tensor-core decode route copies 16-byte words; q, the pools and the new "
             "K/V rows must be 16-byte aligned")
    plan = decode_tc_plan(S, n_kv, pps * page_size, d, k_pages.element_size(),
                          _build.sm_count(q.device), tiles_per_stage)
    splits = plan["splits"]
    fn = _kernel("paged_decode_tc")
    out = torch.empty_like(q)
    part = (  # a partial row: acc, m and l, padded to 16 bytes
        torch.empty(S * n_heads * splits * (d + 4), dtype=torch.float32, device=q.device)
        if splits > 1 else None
    )
    code = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if k_new is None else k_new.data_ptr(), None if v_new is None else v_new.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        _split_counters(S * n_kv, q.device).data_ptr() if splits > 1 else None,
        _KV_CODES[k_pages.dtype], S, n_heads, n_kv, d, P, page_size, pps, int(layer),
        _window(sliding_window), float(scale), _softcap(softcap), splits, plan["stages"],
        tiles_per_stage, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("paged_decode_tc", code)
    return out


def _check_new_rows(name: str, q: torch.Tensor, k_pages: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> None:
    """K4's new rows: contiguous ``[S, n_kv, d]`` in q's dtype on q's device."""
    S, _, d = q.shape
    n_kv = k_pages.shape[3]
    for t in (k_new, v_new):
        _require(t.shape == (S, n_kv, d) and t.dtype == q.dtype and t.device == q.device
                 and t.is_contiguous(),
                 f"{name}: k_new/v_new must be contiguous [{S}, {n_kv}, {d}] {q.dtype} on q's "
                 "device")


def paged_decode_attention_cuda(
    q: torch.Tensor,  # [S, n_heads, d]
    k_pages: torch.Tensor,  # [L, P, page_size, n_kv, d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_seq] int32
    context_lens: torch.Tensor,  # [S] int32, INCLUDING the new token
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """K1: paged decode attention over a layer-stacked page pool, on the
    route :func:`attention_route` gives the q and pool dtypes."""
    _check_decode("paged_decode_attention_cuda", q, k_pages, v_pages, block_tables,
                  context_lens, layer)
    route = attention_route(q.dtype, k_pages.dtype)
    if route == TENSOR_CORE:
        out = _decode_tc(q, k_pages, v_pages, None, None, block_tables, context_lens,
                         scale=scale, layer=layer, sliding_window=sliding_window,
                         softcap=softcap)
        _build.count_launch(paged_decode_attention_cuda, route)
        return out
    S, n_heads, d = q.shape
    _, P, page_size, n_kv, _ = k_pages.shape
    pps = block_tables.shape[1]
    splits = decode_splits(S, n_kv, pps * page_size, q.device)
    fn = _kernel("paged_decode")
    out = torch.empty_like(q)
    part = (  # a partial row: acc, m and l
        torch.empty(S * n_heads * splits * (d + 2), dtype=torch.float32, device=q.device)
        if splits > 1 else None
    )
    code = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        int(q.dtype == torch.bfloat16), _KV_CODES[k_pages.dtype],
        S, n_heads, n_kv, d, P, page_size, pps, int(layer),
        _window(sliding_window), float(scale), _softcap(softcap), splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("paged_decode", code)
    _build.count_launch(paged_decode_attention_cuda, route)
    return out


paged_decode_attention_cuda.launches = 0
paged_decode_attention_cuda.tensor_core_launches = 0
paged_decode_attention_cuda.exact_launches = 0


def flash_prefill_attention_cuda(
    q: torch.Tensor,  # [B, T, n_heads, d]
    k: torch.Tensor,  # [B, T, n_kv, d]
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """K2: causal flash attention over a right-padded prompt bucket, on
    the route :func:`attention_route` gives q's dtype. Rows past a row's
    length come back as zeros on the card (the plain version leaves
    finite garbage there); callers never read them."""
    _require(q.is_cuda, "flash_prefill_attention_cuda takes CUDA tensors")
    B, T, n_heads, d = q.shape
    _require(k.shape[:2] == (B, T) and v.shape == k.shape and k.shape[3] == d,
             f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    n_kv = k.shape[2]
    _require(d in HEAD_DIMS, f"head_dim {d}; want one of {HEAD_DIMS}")
    _require(n_heads % n_kv == 0, f"{n_heads} query heads over {n_kv} KV heads")
    _require(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
             f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}; want one of f32/bf16")
    _require(lengths.dtype == torch.int32 and lengths.shape == (B,) and lengths.is_contiguous(),
             "lengths must be a contiguous int32 [B] tensor")
    for t in (k, v, lengths):
        _require(t.device == q.device, "all tensors must be on q's device")
    for t in (q, k, v):
        _require(t.stride(3) == 1, "the head dimension must be contiguous")
    route = attention_route(q.dtype, k.dtype)
    name = "flash_prefill_tc" if route == TENSOR_CORE else "flash_prefill"
    if route == TENSOR_CORE:
        _check_rows_aligned("flash_prefill_attention_cuda", q=q, k=k, v=v)
    fn = _kernel(name)
    out = torch.empty((B, T, n_heads, d), dtype=q.dtype, device=q.device)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, T, n_heads, n_kv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        _window(sliding_window), float(scale), _softcap(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(name, code)
    _build.count_launch(flash_prefill_attention_cuda, route)
    return out


flash_prefill_attention_cuda.launches = 0
flash_prefill_attention_cuda.tensor_core_launches = 0
flash_prefill_attention_cuda.exact_launches = 0


def _paged_decode_v2(
    name: str,
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: Optional[torch.Tensor],
    v_new: Optional[torch.Tensor],
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int],
    softcap: Optional[float],
) -> torch.Tensor:
    """Checks and launch of ``csrc/paged_decode_v2.cu``, the exact route
    of K4 (``k_new`` given: the pools are written in place) and K5."""
    _check_decode(name, q, k_pages, v_pages, block_tables, context_lens, layer)
    S, n_heads, d = q.shape
    _, P, page_size, n_kv, _ = k_pages.shape
    _require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
             "the v2/v3 decode kernels stage 16-byte rows: pools must be 16-byte aligned")
    fused = k_new is not None
    if fused:
        _check_new_rows(name, q, k_pages, k_new, v_new)
    fn = _kernel("paged_decode_v2")
    pps = block_tables.shape[1]
    # The grid at one page per chunk sets the blocks an SM must hold; the
    # chunk grows only as far as they all still fit.
    splits = decode_splits(S, n_kv, pps * page_size, q.device, tile=page_size)
    blocks_per_sm = -(-S * n_kv * splits // _build.sm_count(q.device))
    ppc = pages_per_chunk(page_size, d, k_pages.element_size(), blocks_per_sm)
    splits = decode_splits(S, n_kv, pps * page_size, q.device, tile=ppc * page_size)
    out = torch.empty_like(q)
    part = (
        torch.empty(S * n_heads * splits * (d + 2), dtype=torch.float32, device=q.device)
        if splits > 1 else None
    )
    code = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_new.data_ptr() if fused else None, v_new.data_ptr() if fused else None,
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        int(q.dtype == torch.bfloat16), _KV_CODES[k_pages.dtype], int(fused),
        S, n_heads, n_kv, d, P, page_size, pps, ppc, int(layer),
        _window(sliding_window), float(scale), _softcap(softcap), splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("paged_decode_v2", code)
    return out


def paged_decode_attention_v2_cuda(
    q: torch.Tensor,  # [S, n_heads, d]
    k_pages: torch.Tensor,  # [L, P, page_size, n_kv, d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_seq] int32
    context_lens: torch.Tensor,  # [S] int32, INCLUDING the new token
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """K5: K1's contract, staged a chunk of ``pages_per_chunk`` pages at a
    time, on the route :func:`attention_route` gives the q and pool dtypes
    (tensor cores: ``csrc/paged_decode_tc.cu``, a ring stage of the block
    a chunk of pages, :func:`decode_tc_tiles_per_stage`; exact:
    ``csrc/paged_decode_v2.cu``, a cp.async double buffer of chunks)."""
    name = "paged_decode_attention_v2_cuda"
    kw = dict(scale=scale, layer=layer, sliding_window=sliding_window, softcap=softcap)
    route = attention_route(q.dtype, k_pages.dtype)
    if route == TENSOR_CORE:
        _check_decode(name, q, k_pages, v_pages, block_tables, context_lens, layer)
        S, _, d = q.shape
        page_size, n_kv = k_pages.shape[2], k_pages.shape[3]
        tps = decode_tc_tiles_per_stage(S, n_kv, page_size, block_tables.shape[1], d,
                                        k_pages.element_size(), _build.sm_count(q.device))
        out = _decode_tc(q, k_pages, v_pages, None, None, block_tables, context_lens,
                         tiles_per_stage=tps, **kw)
    else:
        out = _paged_decode_v2(name, q, k_pages, v_pages, None, None, block_tables,
                               context_lens, **kw)
    _build.count_launch(paged_decode_attention_v2_cuda, route)
    return out


paged_decode_attention_v2_cuda.launches = 0
paged_decode_attention_v2_cuda.tensor_core_launches = 0
paged_decode_attention_v2_cuda.exact_launches = 0


def paged_decode_attention_v3_cuda(
    q: torch.Tensor,  # [S, n_heads, d]
    k_pages: torch.Tensor,  # [L, P, page_size, n_kv, d] — written in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [S, n_kv, d] in q's dtype — this step's rows
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_seq] int32
    context_lens: torch.Tensor,  # [S] int32, INCLUDING the new token
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: K1's contract plus the store of each active row's new K/V at
    position ``ctx − 1`` (the caller must not have written it), on the
    route :func:`attention_route` gives the q and pool dtypes (tensor
    cores: ``csrc/paged_decode_tc.cu``; exact: ``csrc/paged_decode_v2.cu``).
    Returns (out, k_pages, v_pages), the pools updated in place."""
    kw = dict(scale=scale, layer=layer, sliding_window=sliding_window, softcap=softcap)
    route = attention_route(q.dtype, k_pages.dtype)
    if route == TENSOR_CORE:
        name = "paged_decode_attention_v3_cuda"
        _check_decode(name, q, k_pages, v_pages, block_tables, context_lens, layer)
        _check_new_rows(name, q, k_pages, k_new, v_new)
        out = _decode_tc(q, k_pages, v_pages, k_new, v_new, block_tables, context_lens, **kw)
    else:
        out = _paged_decode_v2("paged_decode_attention_v3_cuda", q, k_pages, v_pages, k_new,
                               v_new, block_tables, context_lens, **kw)
    _build.count_launch(paged_decode_attention_v3_cuda, route)
    return out, k_pages, v_pages


paged_decode_attention_v3_cuda.launches = 0
paged_decode_attention_v3_cuda.tensor_core_launches = 0
paged_decode_attention_v3_cuda.exact_launches = 0


def paged_prefill_attention_cuda(
    q: torch.Tensor,  # [B, C, n_heads, d]
    k_pages: torch.Tensor,  # [L, P, page_size, n_kv, d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, pages_per_seq] int32
    chunk_start: torch.Tensor,  # [B] int32 absolute position of query 0
    num_valid: torch.Tensor,  # [B] int32 valid queries (a leading run)
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """K3: a chunk of queries per row against the paged cache, which
    already holds the chunk's K/V, on the route :func:`attention_route`
    gives the q and pool dtypes. Query rows past ``num_valid`` come back
    as zeros (the plain version leaves a finite average); callers never
    read them."""
    _require(q.is_cuda, "paged_prefill_attention_cuda takes CUDA tensors")
    _require(k_pages.dim() == 5, "k_pages must be a layer-stacked [L, P, page, n_kv, d] pool")
    B, C, n_heads, d = q.shape
    L, P, page_size, n_kv, d_kv = k_pages.shape
    _require(v_pages.shape == k_pages.shape, "k_pages and v_pages differ in shape")
    _require(d == d_kv and d in HEAD_DIMS, f"head_dim {d} (pool {d_kv}); want one of {HEAD_DIMS}")
    _require(n_heads % n_kv == 0, f"{n_heads} query heads over {n_kv} KV heads")
    _check_dtypes(q, k_pages, v_pages)
    for t in (block_tables, chunk_start, num_valid):
        _require(t.dtype == torch.int32 and t.is_contiguous() and t.device == q.device,
                 "block_tables, chunk_start and num_valid must be contiguous int32 on q's device")
    _require(block_tables.shape[0] == B and chunk_start.shape == (B,)
             and num_valid.shape == (B,), "batch mismatch")
    for t in (k_pages, v_pages):
        _require(t.device == q.device and t.is_contiguous(), "pools: contiguous, on q's device")
    _require(q.stride(3) == 1, "the head dimension must be contiguous")
    _require(0 <= int(layer) < L, f"layer {layer} outside the {L}-layer pool")
    route = attention_route(q.dtype, k_pages.dtype)
    if route == TENSOR_CORE:
        _check_rows_aligned("paged_prefill_attention_cuda", q=q, k_pages=k_pages,
                            v_pages=v_pages)
        _require(k_pages.numel() // d < 2**31,
                 "paged_prefill_attention_cuda: the tensor-core route indexes pool rows "
                 f"with 32-bit integers; this pool has {k_pages.numel() // d} rows")
        name, dtypes = "paged_prefill_tc", (_KV_CODES[k_pages.dtype],)
    else:
        name, dtypes = "paged_prefill", (int(q.dtype == torch.bfloat16), _KV_CODES[k_pages.dtype])
    fn = _kernel(name)
    out = torch.empty((B, C, n_heads, d), dtype=q.dtype, device=q.device)
    code = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        chunk_start.data_ptr(), num_valid.data_ptr(), out.data_ptr(), *dtypes,
        B, C, n_heads, n_kv, d, P, page_size, block_tables.shape[1], int(layer),
        *q.stride()[:3], _window(sliding_window), float(scale), _softcap(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(name, code)
    _build.count_launch(paged_prefill_attention_cuda, route)
    return out


paged_prefill_attention_cuda.launches = 0
paged_prefill_attention_cuda.tensor_core_launches = 0
paged_prefill_attention_cuda.exact_launches = 0
