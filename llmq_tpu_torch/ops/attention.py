"""Plain PyTorch attention + paged-KV functions.

Port of ``llmq_tpu/ops/attention.py``: the same functions, arguments,
layouts and arithmetic, written with torch ops. They are the CPU path of
the port and the oracle the CUDA kernels in ``ops/csrc`` are held
against (``chip_smoke.py``, ``tests/test_torch_ops.py``).

KV cache layout (paged, layer-stacked):
    k_pages, v_pages: [L, P, page_size, n_kv, head_dim] (or [P, ...])
    block_tables:     [num_seqs, pages_per_seq] int32 — logical→physical
    context_lens:     [num_seqs] int32 — INCLUDING the new token
Page 0 is scratch: padded or inactive positions (position −1) write there.

Unlike the JAX reference, the KV writes update the pools IN PLACE (an
``index_put_``) and return the same tensors: the engine holds one pool
for its whole life instead of threading new arrays through every step.

Pools may be float8_e5m2 (``kv_dtype="fp8"``): writes cast to the pool
dtype (round to nearest even, overflow to ±inf, as JAX's cast), reads
upcast to the query dtype (:func:`_compute_dtype`). The gathers and
scatters move a 1-byte pool's elements as raw bytes (:func:`_bits`), so
they need no float8 support from the indexing kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _compute_dtype(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> torch.dtype:
    """Dtype the attention math runs in, given the query dtype and the KV
    storage dtype: narrow (1-byte) pools upcast to the query dtype, a pool
    wider than the query promotes (an f32 pool under a bf16 query keeps
    its precision)."""
    q_size = torch.empty((), dtype=q_dtype).element_size()
    kv_size = torch.empty((), dtype=kv_dtype).element_size()
    if kv_size == 1:
        return q_dtype
    if q_size == 1:
        return kv_dtype
    return torch.promote_types(q_dtype, kv_dtype)


def is_byte_pool(dtype: torch.dtype) -> bool:
    """A 1-byte float pool (float8_e5m2)."""
    return dtype.is_floating_point and torch.empty((), dtype=dtype).element_size() == 1


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte float tensor as its raw bytes (same shape); others as is."""
    return t.view(torch.uint8) if is_byte_pool(t.dtype) else t


def _gather_pages(pages: torch.Tensor, bt: torch.Tensor, mul: torch.dtype) -> torch.Tensor:
    """``pages[bt]`` ([S, pages_per_seq, page, n_kv, d]) in ``mul``."""
    return _bits(pages)[bt].view(pages.dtype).to(mul)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[..., n_kv, d] → [..., n_kv*n_rep, d] (GQA key/value head expansion)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def full_prefill_attention(
    q: torch.Tensor,  # [B, T, n_heads, head_dim]
    k: torch.Tensor,  # [B, T, n_kv_heads, head_dim]
    v: torch.Tensor,  # [B, T, n_kv_heads, head_dim]
    *,
    scale: float,
    lengths: Optional[torch.Tensor] = None,  # [B] valid prompt lengths
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention over a full (possibly right-padded) prompt."""
    B, T, n_heads, _ = q.shape
    n_rep = n_heads // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = _softcap(scores, softcap)
    pos = torch.arange(T, device=q.device)
    q_pos = pos[:, None]
    k_pos = pos[None, :]
    mask = k_pos <= q_pos
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos - sliding_window)
    if lengths is not None:
        mask = mask[None, :, :] & (k_pos[None, :, :] < lengths[:, None, None])
        mask = mask[:, None, :, :]
    else:
        mask = mask[None, None, :, :]
    scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def paged_decode_attention(
    q: torch.Tensor,  # [S, n_heads, head_dim] — one new token per sequence
    k_pages: torch.Tensor,  # [P, page_size, n_kv, head_dim] or [L, P, ...]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_seq] int32
    context_lens: torch.Tensor,  # [S] int32 — INCLUDING the new token
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    layer: Optional[int] = None,  # required when pages are stacked
) -> torch.Tensor:
    """Decode-step attention reading K/V through the page table: gathers
    each sequence's pages into a contiguous [S, max_ctx] view and does a
    masked softmax (the CUDA kernel computes the same without the gather)."""
    if k_pages.dim() == 5:
        if layer is None:
            raise ValueError("stacked pages need a layer index")
        k_pages = k_pages[layer]
        v_pages = v_pages[layer]
    S, n_heads, head_dim = q.shape
    page_size = k_pages.shape[1]
    pages_per_seq = block_tables.shape[1]
    max_ctx = pages_per_seq * page_size
    n_kv = k_pages.shape[2]
    n_rep = n_heads // n_kv

    out_dtype = q.dtype
    mul = _compute_dtype(q.dtype, k_pages.dtype)
    bt = block_tables.long()
    k = repeat_kv(_gather_pages(k_pages, bt, mul).reshape(S, max_ctx, n_kv, head_dim), n_rep)
    v = repeat_kv(_gather_pages(v_pages, bt, mul).reshape(S, max_ctx, n_kv, head_dim), n_rep)
    q = q.to(mul)

    scores = torch.einsum("shd,skhd->shk", q, k) * scale
    scores = _softcap(scores, softcap)
    k_pos = torch.arange(max_ctx, device=q.device)[None, :]
    mask = k_pos < context_lens[:, None]
    if sliding_window is not None:
        mask = mask & (k_pos >= context_lens[:, None] - sliding_window)
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1).to(mul)
    return torch.einsum("shk,skhd->shd", weights, v).to(out_dtype)


def paged_prefill_attention(
    q: torch.Tensor,  # [B, C, n_heads, head_dim] — a chunk of query positions
    k_pages: torch.Tensor,  # [P, page_size, n_kv, head_dim] or [L, P, ...]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, pages_per_seq] int32
    q_positions: torch.Tensor,  # [B, C] absolute positions (−1 = padding)
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    layer: Optional[int] = None,  # required when pages are stacked
) -> torch.Tensor:
    """Chunked-prefill attention: C query positions per row against the
    paged KV cache, which must already hold the chunk's own K/V (the same
    write-then-attend order as the decode step). The causal frontier is
    per token and absolute: the query at position ``p`` attends cached
    keys ``[max(0, p+1−window), p]``.

    A padding query (position −1) attends nothing: its row is a finite
    average of the gathered values that no caller reads. The kernel (K3)
    writes zeros there instead; both sides compare valid rows only."""
    if k_pages.dim() == 5:
        if layer is None:
            raise ValueError("stacked pages need a layer index")
        k_pages = k_pages[layer]
        v_pages = v_pages[layer]
    B, C, n_heads, head_dim = q.shape
    page_size = k_pages.shape[1]
    pages_per_seq = block_tables.shape[1]
    max_ctx = pages_per_seq * page_size
    n_kv = k_pages.shape[2]
    n_rep = n_heads // n_kv

    out_dtype = q.dtype
    mul = _compute_dtype(q.dtype, k_pages.dtype)
    bt = block_tables.long()
    k = repeat_kv(_gather_pages(k_pages, bt, mul).reshape(B, max_ctx, n_kv, head_dim), n_rep)
    v = repeat_kv(_gather_pages(v_pages, bt, mul).reshape(B, max_ctx, n_kv, head_dim), n_rep)
    q = q.to(mul)

    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = _softcap(scores, softcap)
    k_pos = torch.arange(max_ctx, device=q.device)[None, None, :]
    q_pos = q_positions[:, :, None]
    mask = (k_pos <= q_pos) & (q_pos >= 0)
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos - sliding_window)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1).to(mul)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v).to(out_dtype)


def paged_decode_attention_fused_write(
    q: torch.Tensor,  # [S, n_heads, head_dim]
    k_pages: torch.Tensor,  # [L, P, page_size, n_kv, head_dim]
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [S, n_kv, head_dim] — this step's fresh K/V rows
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [S, pages_per_seq] int32
    context_lens: torch.Tensor,  # [S] int32 — INCLUDING the new token
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused-write decode kernel (K4): store each
    active row's new K/V at position ``ctx − 1`` (inactive rows, ctx == 0,
    go to the scratch page), then attend. Returns (out, k_pages, v_pages),
    the pools updated in place."""
    positions = torch.where(context_lens > 0, context_lens - 1, -1)[:, None]
    write_kv_pages(k_pages, v_pages, k_new[:, None], v_new[:, None], block_tables,
                   positions, layer)
    out = paged_decode_attention(q, k_pages, v_pages, block_tables, context_lens,
                                 scale=scale, sliding_window=sliding_window,
                                 softcap=softcap, layer=layer)
    return out, k_pages, v_pages


def write_prompt_kv_pages(
    k_pages: torch.Tensor,  # [L, P, page_size, n_kv, d] (stacked only)
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, n_kv, d] — positions 0..T-1 per row
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, pages_per_seq]
    layer: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page-granular prefill KV write (whole pages, not token rows), in
    place. Requires a page-aligned bucket ``T``. Rows shorter than ``T``
    write garbage into the unread tail of their last page(s); padded rows
    carry an all-zero block table and land on scratch page 0."""
    B, T, n_kv, d = k_new.shape
    page_size = k_pages.shape[-3]
    if T % page_size:
        raise ValueError("bucket must be page-aligned for page writes")
    n_lp = T // page_size
    phys = block_tables[:, :n_lp].reshape(B * n_lp).long()
    _bits(k_pages)[layer, phys] = _bits(k_new.to(k_pages.dtype)).reshape(
        B * n_lp, page_size, n_kv, d)
    _bits(v_pages)[layer, phys] = _bits(v_new.to(v_pages.dtype)).reshape(
        B * n_lp, page_size, n_kv, d)
    return k_pages, v_pages


def mixed_query_grid(
    tokens: torch.Tensor,  # [S] current decode token per slot
    ctx: torch.Tensor,  # [S] context length − 1 per slot
    active: torch.Tensor,  # [S] bool — slot is decoding
    chunk_tokens: torch.Tensor,  # [C] piggybacked prefill segment tokens
    chunk_positions: torch.Tensor,  # [C] absolute positions (−1 = padding)
    slot: torch.Tensor,  # 0-dim int — the piggy sequence's slot
    max_kv_pos: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query grids of a mixed (decode + piggybacked prefill) dispatch:
    every decodable row is a one-query row ``[ctx, -1, ...]`` (empty when
    inactive or past the page map), and the piggy's slot, while it is still
    inactive, carries the prefill segment. Every row is a leading
    contiguous run, the chunked-prefill contract. Returns
    ``(q_tokens [S, C], q_positions [S, C], is_chunk [S])``."""
    S, C = tokens.shape[0], chunk_tokens.shape[0]
    base_tok = torch.zeros((S, C), dtype=tokens.dtype, device=tokens.device)
    base_tok[:, 0] = tokens
    base_pos = torch.full((S, C), -1, dtype=ctx.dtype, device=ctx.device)
    base_pos[:, 0] = torch.where(active & (ctx < max_kv_pos), ctx, -1)
    is_chunk = (torch.arange(S, device=tokens.device) == slot) & ~active
    q_tokens = torch.where(is_chunk[:, None], chunk_tokens[None, :].to(tokens.dtype), base_tok)
    q_positions = torch.where(is_chunk[:, None], chunk_positions[None, :].to(ctx.dtype),
                              base_pos)
    return q_tokens, q_positions, is_chunk


def kv_write_index(
    block_tables: torch.Tensor,  # [B, pages_per_seq]
    positions: torch.Tensor,  # [B, T] absolute positions (−1 = skip)
    page_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, in-page offset) per flattened position for
    :func:`write_kv_pages`; position −1 maps to (0, 0), the scratch page.
    The same for every layer, so a forward pass computes it once."""
    B, T = positions.shape
    pos = positions.reshape(B * T)
    valid = pos >= 0
    logical = torch.where(valid, torch.div(pos, page_size, rounding_mode="floor"), 0)
    # An index past the page map clamps, as the JAX gather does.
    logical = logical.clamp(max=block_tables.shape[1] - 1).long()
    offset = torch.where(valid, pos % page_size, 0).long()
    batch_idx = torch.arange(B, device=positions.device).repeat_interleave(T)
    physical = block_tables[batch_idx, logical]
    physical = torch.where(valid, physical, 0).long()
    return physical, offset


def write_kv_pages(
    k_pages: torch.Tensor,  # [P, page_size, n_kv, d] or [L, P, ...]
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, n_kv, d]
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, pages_per_seq]
    positions: torch.Tensor,  # [B, T] absolute token positions (−1 = skip)
    layer: Optional[int] = None,  # required when pages are stacked
    *,
    index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter fresh K/V into their pages, in place. Padded/inactive
    entries (position −1) go to the scratch page 0. ``index`` is a
    precomputed :func:`kv_write_index` result."""
    B, T, n_kv, d = k_new.shape
    physical, offset = index if index is not None else kv_write_index(
        block_tables, positions, k_pages.shape[-3]
    )
    k_flat = _bits(k_new.reshape(B * T, n_kv, d).to(k_pages.dtype))
    v_flat = _bits(v_new.reshape(B * T, n_kv, d).to(v_pages.dtype))
    kb, vb = _bits(k_pages), _bits(v_pages)
    if k_pages.dim() == 5:
        if layer is None:
            raise ValueError("stacked pages need a layer index")
        kb[layer, physical, offset] = k_flat
        vb[layer, physical, offset] = v_flat
    else:
        kb[physical, offset] = k_flat
        vb[physical, offset] = v_flat
    return k_pages, v_pages
