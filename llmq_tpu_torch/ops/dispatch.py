"""Attention dispatch: the CUDA kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors.

Port of ``llmq_tpu/ops/dispatch.py`` (``prefill_attention`` :67,
``decode_attention`` :381). The model calls these two functions, and
this is the one place where a kernel or its plain version is chosen: by
the device of the tensors and by nothing else (no environment switch, no
fallback). A CUDA tensor goes to the wrapper in ``ops/cuda_attention``,
which launches its kernel or raises; a CPU tensor goes to the plain
version in ``ops/attention``. Tensor parallelism (the JAX ``shard_map``
over heads) comes with ROADMAP M13.
"""

from __future__ import annotations

from typing import Optional

import torch

from llmq_tpu_torch.ops import attention as plain
from llmq_tpu_torch.ops.cuda_attention import (
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
)


def prefill_attention(
    q: torch.Tensor,  # [B, T, n_heads, d]
    k: torch.Tensor,  # [B, T, n_kv, d]
    v: torch.Tensor,
    *,
    scale: float,
    lengths: Optional[torch.Tensor] = None,  # [B] int32
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    if lengths is None:
        lengths = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32, device=q.device)
    attend = flash_prefill_attention_cuda if q.is_cuda else plain.full_prefill_attention
    return attend(q, k, v, lengths=lengths, scale=scale, sliding_window=sliding_window,
                  softcap=softcap)


def decode_attention(
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
    attend = paged_decode_attention_cuda if q.is_cuda else plain.paged_decode_attention
    return attend(q, k_pages, v_pages, block_tables, context_lens, scale=scale, layer=layer,
                  sliding_window=sliding_window, softcap=softcap)
