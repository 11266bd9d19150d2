"""Kernel dispatch: the CUDA kernels for CUDA tensors, the plain PyTorch
versions for CPU tensors.

Port of ``llmq_tpu/ops/dispatch.py`` (``prefill_attention`` :67,
``chunked_prefill_attention`` :119, ``decode_kernel_plan`` :193,
``verify_kernel_plan`` :219, ``mixed_kernel_plan`` :245,
``decode_attention_fused_write`` :322, ``decode_attention`` :381,
``logit_guard_stats`` :482), plus
the weight-only matmuls that ``llmq_tpu/models/quant.py::matmul`` sends
to ``ops/pallas_matmul.py``. The model calls these functions, and this
is the one place where a kernel or its plain version is chosen: by the
device of the tensors and by nothing else (no fallback). A CUDA tensor
goes to the wrapper in ``ops/cuda_attention`` or ``ops/cuda_matmul``,
which launches its kernel or raises; a CPU tensor goes to the plain
version in ``ops/attention`` or ``ops/matmul``.

Which decode kernel runs on the card is ``LLMQ_DECODE_KERNEL`` (v1 = K1,
v2 = K5, v3 = K4 with the fused KV write), read once by
:func:`resolve_decode_kernel` when the model is built, as the JAX package
resolves it once at trace time. Whether a 2-D quantized weight goes
through its kernel at all is ``LLMQ_INT8_MATMUL`` / ``LLMQ_INT4_MATMUL``
(``pallas``, the JAX package's value), read once by
:func:`resolve_quant_matmul`. Tensor parallelism (the JAX
``shard_map`` over heads) comes with ROADMAP M13.
"""

from __future__ import annotations

import math
import os
from typing import FrozenSet, Optional, Tuple

import torch

from llmq_tpu_torch.ops import attention as plain
from llmq_tpu_torch.ops import matmul as plain_matmul
from llmq_tpu_torch.ops.cuda_attention import (
    flash_prefill_attention_cuda,
    paged_decode_attention_cuda,
    paged_decode_attention_v2_cuda,
    paged_decode_attention_v3_cuda,
    paged_prefill_attention_cuda,
)
from llmq_tpu_torch.ops.cuda_matmul import int4_matmul_cuda, int8_matmul_cuda

DECODE_KERNELS = ("v1", "v2", "v3")
#: weight-only rung -> the variable that sends its products to the kernel
QUANT_MATMUL_ENV = {"int8": "LLMQ_INT8_MATMUL", "int4": "LLMQ_INT4_MATMUL"}


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


def chunked_prefill_attention(
    q: torch.Tensor,  # [B, C, n_heads, d]
    k_pages: torch.Tensor,  # [L, P, page, n_kv, d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, pages_per_seq] int32
    q_positions: torch.Tensor,  # [B, C] absolute positions (−1 = padding)
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Chunk-of-queries attention against the paged cache (chunked
    prefill): K3 on the card, the plain gather-and-mask version on the CPU.

    CONTRACT: each row's valid positions are a LEADING CONTIGUOUS run
    (``q_positions[b] = [s, s+1, ..., s+n−1, −1, ...]``, which is how the
    engine's chunk loop builds them); the kernel takes the run as
    (start, count) and cannot represent gaps."""
    if not q.is_cuda:
        return plain.paged_prefill_attention(
            q, k_pages, v_pages, block_tables, q_positions, scale=scale,
            sliding_window=sliding_window, softcap=softcap, layer=layer,
        )
    num_valid = (q_positions >= 0).sum(dim=1, dtype=torch.int32)
    chunk_start = torch.where(num_valid > 0, q_positions[:, 0], 0).to(torch.int32)
    return paged_prefill_attention_cuda(
        q, k_pages, v_pages, block_tables, chunk_start, num_valid, scale=scale, layer=layer,
        sliding_window=sliding_window, softcap=softcap,
    )


def resolve_decode_kernel() -> str:
    """``LLMQ_DECODE_KERNEL`` (v1 | v2 | v3; empty or unset means v1, as the
    ``VAR= cmd`` shell idiom expects). Any other value raises."""
    kern = (os.environ.get("LLMQ_DECODE_KERNEL") or "v1").lower()
    if kern not in DECODE_KERNELS:
        raise ValueError(f"LLMQ_DECODE_KERNEL={kern!r} (want v1|v2|v3)")
    return kern


def decode_kernel_plan(kernel: str, device: torch.device) -> Tuple[str, bool]:
    """(kernel name, fused_write) for a model built under ``kernel`` whose
    tensors lie on ``device``. ``fused_write`` (v3, K4) means the decode
    kernel stores the step's new K/V row itself, so the model must skip
    ``write_kv_pages`` and call :func:`decode_attention_fused_write`. CPU
    tensors run the plain versions with the separate write, as the JAX
    package's non-Pallas branch does."""
    if device.type != "cuda":
        return "plain", False
    return kernel, kernel == "v3"


def verify_kernel_plan(device: torch.device) -> Tuple[str, bool]:
    """(kernel name, fused_write) of the speculative verify step: Q =
    spec_tokens + 1 queries a row against the paged cache is the chunked
    prefill shape, so K3 (``chunked_prefill``) on the card and its plain
    version on the CPU; never a fused write, since each candidate attends
    its predecessors' fresh K/V."""
    return ("chunked_prefill" if device.type == "cuda" else "plain"), False


def mixed_kernel_plan(device: torch.device) -> Tuple[str, bool]:
    """(kernel name, fused_write) of the mixed step: the [S, C] grid of one
    query a decode row and one prompt segment meets the same contract as
    verify, so the same plan."""
    return verify_kernel_plan(device)


def decode_attention_fused_write(
    q: torch.Tensor,  # [S, n_heads, d]
    k_pages: torch.Tensor,  # [L, P, page, n_kv, d] — written in place
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [S, n_kv, d] — this step's fresh K/V rows
    v_new: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,  # [S] INCLUDING the new token
    *,
    scale: float,
    layer: int,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """v3 decode: attention and the new rows' KV write in one launch (K4);
    only valid when :func:`decode_kernel_plan` returned ``fused_write``.
    Returns (out, k_pages, v_pages)."""
    attend = (paged_decode_attention_v3_cuda if q.is_cuda
              else plain.paged_decode_attention_fused_write)
    return attend(q, k_pages, v_pages, k_new, v_new, block_tables, context_lens,
                  scale=scale, layer=layer, sliding_window=sliding_window, softcap=softcap)


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
    kernel: str = "v1",
) -> torch.Tensor:
    """Decode attention after the new rows were written: K1 (v1) or K5 (v2;
    v3's write-free form, as in the JAX package) on the card."""
    if not q.is_cuda:
        attend = plain.paged_decode_attention
    elif kernel == "v1":
        attend = paged_decode_attention_cuda
    else:
        attend = paged_decode_attention_v2_cuda
    return attend(q, k_pages, v_pages, block_tables, context_lens, scale=scale, layer=layer,
                  sliding_window=sliding_window, softcap=softcap)


def resolve_quant_matmul() -> FrozenSet[str]:
    """The rungs ("int8", "int4") whose variable in :data:`QUANT_MATMUL_ENV`
    is ``pallas``: their 2-D products go through K6 / K7 (on the card) or
    the kernels' plain versions (on the CPU). Any other value leaves the
    dequantize-then-matmul path, as in the JAX package."""
    return frozenset(rung for rung, var in QUANT_MATMUL_ENV.items()
                     if os.environ.get(var, "").lower() == "pallas")


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x[M, K] @ q[K, N]) * scale[N]``: K6 on the card."""
    mm = int8_matmul_cuda if x.is_cuda else plain_matmul.int8_matmul
    return mm(x.contiguous(), q, scale)


def int4_matmul(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor
) -> torch.Tensor:
    """``x[M, K] @ dequant(q, scale, zero)``: K7 on the card."""
    mm = int4_matmul_cuda if x.is_cuda else plain_matmul.int4_matmul
    return mm(x.contiguous(), q, scale, zero)


def logit_guard_stats(logits: torch.Tensor, mask: torch.Tensor, *, max_abs: float,
                      min_entropy: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The numerics guard over one dispatch's logits (JAX :482): returns
    ``(stats f32[3], bad bool[rows])``, ``stats`` = [nonfinite count, max
    |logit|, min row entropy in nats] over the masked rows, ``bad`` each
    masked row that trips a check (any non-finite value; ``|logit| >
    max_abs`` when ``max_abs > 0``; softmax entropy below ``min_entropy``
    when ``min_entropy > 0``). Rows outside ``mask`` count 0 / max 0 /
    entropy +inf and are never flagged. Plain tensor reductions with no
    host sync: the engine runs them inside its dispatches (the captured
    graphs included), the thresholds fixed when the engine is built, as
    JAX traces them."""
    z = logits.float()
    row_mask = mask[:, None]
    finite = torch.isfinite(z)
    nonfinite_rows = (~finite & row_mask).sum(dim=1).float()
    zf = torch.where(finite, z, 0.0)
    absmax_rows = torch.where(row_mask, zf.abs(), 0.0).amax(dim=1)
    # Stable entropy over the finite entries: H = logsumexp(z) - sum(p z);
    # a non-finite entry weighs 0, so one NaN cannot poison this lane too.
    m = torch.where(finite, zf, -math.inf).amax(dim=1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ez = torch.where(finite, torch.exp(zf - m), 0.0)
    sz = ez.sum(dim=1).clamp(min=1e-30)
    ent = (torch.log(sz) + m[:, 0]) - (ez * zf).sum(dim=1) / sz
    ent_masked = torch.where(mask, ent, math.inf)
    bad = mask & (nonfinite_rows > 0)
    if max_abs > 0:
        bad = bad | (mask & (absmax_rows > max_abs))
    if min_entropy > 0:
        bad = bad | (mask & (ent_masked < min_entropy))
    stats = torch.stack([
        nonfinite_rows.sum(),
        torch.where(mask, absmax_rows, 0.0).amax(),
        ent_masked.amin(),
    ])
    return stats, bad
