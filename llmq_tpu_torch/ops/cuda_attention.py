"""Wrappers of the hand-written CUDA attention kernels (``ops/csrc``).

- :func:`paged_decode_attention_cuda` — K1, ``csrc/paged_decode.cu``,
  the port of ``pallas_attention.py::paged_decode_attention_pallas``.
- :func:`flash_prefill_attention_cuda` — K2, ``csrc/flash_prefill.cu``,
  the port of ``pallas_attention.py::flash_prefill_attention_pallas``.

The wrappers take CUDA tensors only: each launches its kernel on the
current stream or raises — there is no fallback. The choice between a
kernel and its plain PyTorch version (``ops/attention.py``) is made in
one place, ``ops/dispatch.py``, by the device of the tensors. Each
wrapper carries a plain-int ``launches`` counter, incremented once per
kernel launch and nowhere else, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from llmq_tpu_torch.ops import _build

WINDOW_DISABLED = 1 << 30
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16  # query heads per KV head the decode kernel holds
DECODE_TILE = 32  # keys per tile of the decode kernel
MAX_SPLITS = 32
_DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "paged_decode": ("llmq_paged_decode", [_P] * 7 + [_I] * 11 + [_F, _F, _I, _P]),
    "flash_prefill": ("llmq_flash_prefill", [_P] * 5 + [_I] * 6 + [_L] * 12 + [_I, _F, _F, _P]),
}
_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load(name)
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = lib.llmq_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[name] = fn
        _fns[name + ".err"] = err
    return fn


def _check(name: str, code: int) -> None:
    if code != 0:
        msg = _fns[name + ".err"](code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _window(sliding_window: Optional[int]) -> int:
    return WINDOW_DISABLED if sliding_window is None else min(int(sliding_window), 2**31 - 1)


def _softcap(softcap: Optional[float]) -> float:
    return 0.0 if softcap is None else float(softcap)


def decode_splits(num_seqs: int, n_kv: int, max_ctx: int, device: torch.device) -> int:
    """Blocks per (sequence, KV head) for the decode kernel: enough for two
    blocks per SM, never more than the page map has key tiles. A function
    of shapes only, so every layer of a step launches the same grid."""
    sms = _sm_count(device)
    want = -(-2 * sms // max(1, num_seqs * n_kv))
    return max(1, min(want, -(-max_ctx // DECODE_TILE), MAX_SPLITS))


def _sm_count(device: torch.device) -> int:
    key = ("sms", device.index)
    n = _fns.get(key)
    if n is None:
        n = _fns[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


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
    """K1: paged decode attention over a layer-stacked page pool."""
    _require(q.is_cuda, "paged_decode_attention_cuda takes CUDA tensors")
    _require(k_pages.dim() == 5, "k_pages must be a layer-stacked [L, P, page, n_kv, d] pool")
    S, n_heads, d = q.shape
    L, P, page_size, n_kv, d_kv = k_pages.shape
    _require(v_pages.shape == k_pages.shape, "k_pages and v_pages differ in shape")
    _require(d == d_kv and d in HEAD_DIMS, f"head_dim {d} (pool {d_kv}); want one of {HEAD_DIMS}")
    _require(n_heads % n_kv == 0 and n_heads // n_kv <= MAX_GROUP,
             f"{n_heads} query heads over {n_kv} KV heads (group <= {MAX_GROUP})")
    _require(q.dtype in _DTYPES and k_pages.dtype in _DTYPES and v_pages.dtype == k_pages.dtype,
             f"dtypes q={q.dtype} pools={k_pages.dtype}/{v_pages.dtype}; want f32 or bf16")
    _require(block_tables.dtype == torch.int32 and context_lens.dtype == torch.int32,
             "block_tables and context_lens must be int32")
    _require(block_tables.shape[0] == S and context_lens.shape == (S,), "batch mismatch")
    for t in (k_pages, v_pages, block_tables, context_lens):
        _require(t.device == q.device, "all tensors must be on q's device")
    for t in (q, k_pages, v_pages, block_tables, context_lens):
        _require(t.is_contiguous(), "paged decode takes contiguous tensors")
    layer = int(layer)
    _require(0 <= layer < L, f"layer {layer} outside the {L}-layer pool")
    fn = _kernel("paged_decode")
    out = torch.empty_like(q)
    splits = decode_splits(S, n_kv, block_tables.shape[1] * page_size, q.device)
    part = (
        torch.empty(S * n_heads * splits * (d + 2), dtype=torch.float32, device=q.device)
        if splits > 1 else None
    )
    code = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        int(q.dtype == torch.bfloat16), int(k_pages.dtype == torch.bfloat16),
        S, n_heads, n_kv, d, P, page_size, block_tables.shape[1], layer,
        _window(sliding_window), float(scale), _softcap(softcap), splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check("paged_decode", code)
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0


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
    """K2: causal flash attention over a right-padded prompt bucket.
    Rows past a row's length come back as zeros on the card (the plain
    version leaves finite garbage there); callers never read them."""
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
    fn = _kernel("flash_prefill")
    out = torch.empty((B, T, n_heads, d), dtype=q.dtype, device=q.device)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, T, n_heads, n_kv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        _window(sliding_window), float(scale), _softcap(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check("flash_prefill", code)
    flash_prefill_attention_cuda.launches += 1
    return out


flash_prefill_attention_cuda.launches = 0
