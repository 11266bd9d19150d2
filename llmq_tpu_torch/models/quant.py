"""Weight-only int8 and int4 quantization (``dtype="int8"|"int4"``).

Port of ``llmq_tpu/models/quant.py``: the same representation, the same
rounding and the same switches.

A quantized weight is a plain dict (the JAX package's pytree leaf):

- int8, symmetric per output channel: ``{"q": int8[..., in, out],
  "scale": f[..., out]}``, ``w ≈ q * scale``. Embeddings quantize per
  row (the lookup axis): ``q[ids] * scale[ids]``.
- int4, asymmetric per group of ``group`` contraction rows (AWQ style):
  ``{"q": uint8[..., in/2, out], "scale": f[..., groups, out],
  "zero": f[..., groups, out]}``, ``w ≈ (unpack(q) - zero) * scale``; two
  4-bit codes per byte along the contraction axis, the even row in the
  low nibble. The embedding and the LM head stay on the int8 rung.

The scale dtype is the model's compute dtype (what the products and
lookups return). Rounding is half-to-even (``torch.round``, as
``jnp.round``), and a division by a constant is a multiplication by its
f32 reciprocal, as XLA folds it in the jitted functions through which the
JAX package always quantizes (``quantize_params``, ``init_params``, the
loader); so the same f32 weights give the JAX package's trees bit for
bit.

:func:`matmul` sends a 2-D quantized weight to its kernel (K6 int8, K7
int4, through ``ops/dispatch``) when its rung is in ``kernels``: the set
of ``LLMQ_INT8_MATMUL=pallas`` / ``LLMQ_INT4_MATMUL=pallas`` that
``ops.dispatch.resolve_quant_matmul`` reads, once, when a model is
built. Otherwise it takes the dequantize-then-``torch.matmul`` path, the
counterpart of the JAX package's XLA fallback. The tensor-parallel
switches of the JAX module (``disable_pallas_matmul``,
``quantized_specs``) come with multi-GPU (ROADMAP M13).
"""

from __future__ import annotations

import math
from typing import Any, Dict, FrozenSet, Mapping, Optional

import torch

from llmq_tpu_torch.ops import dispatch
from llmq_tpu_torch.ops.matmul import dequantize_int4_parts, unpack_int4

__all__ = [
    "INT4_GROUP_SIZE", "QUANTIZED_LAYER_KEYS", "QUANTIZED_TOP_KEYS", "dequantize",
    "dequantize_int4_parts", "embed_lookup", "int4_group", "is_int4", "is_quantized",
    "matmul", "pack_int4", "quantize_array", "quantize_array_int4", "quantize_params",
    "tied_head_matmul", "unpack_int4",
]

Params = Dict[str, Any]

# Every large matmul operand, the 4-D expert stacks [L, E, in, out]
# included; norms, biases, the MoE router and the shared-expert gate stay
# in the compute dtype.
QUANTIZED_LAYER_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    "expert_gate_proj", "expert_up_proj", "expert_down_proj",
    "shared_gate_proj", "shared_up_proj", "shared_down_proj",
)
QUANTIZED_TOP_KEYS = ("embed", "lm_head")

#: Default int4 group: contraction rows per (scale, zero) pair.
INT4_GROUP_SIZE = 128

# x / 127 and x / 15 as XLA computes them under jit: x times the f32
# reciprocal of the constant.
_RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
_RECIP_15 = torch.tensor(1.0 / 15.0, dtype=torch.float32)


def is_quantized(w: Any) -> bool:
    return isinstance(w, Mapping) and "q" in w and "scale" in w


def is_int4(w: Any) -> bool:
    """True for the packed int4 dict (int8 has no zero-point)."""
    return is_quantized(w) and "zero" in w


def int4_group(k: int, group_size: int = INT4_GROUP_SIZE) -> int:
    """``group_size`` when it divides the contraction dim, else the gcd
    (tiny test models have K < 128)."""
    return group_size if k % group_size == 0 else math.gcd(k, group_size)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """4-bit codes ``[..., K, N] -> uint8[..., K//2, N]`` along the
    contraction axis: even rows in the low nibble, odd rows high."""
    lo = q[..., 0::2, :].to(torch.uint8)
    hi = q[..., 1::2, :].to(torch.uint8)
    return lo | (hi << 4)


def quantize_array_int4(
    w: torch.Tensor, *, group_size: int = INT4_GROUP_SIZE, scale_dtype=torch.float32
) -> Params:
    """Asymmetric int4 group quantization over the contraction
    (second-to-last) axis."""
    k = w.shape[-2]
    if k % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {k}")
    group = int4_group(k, group_size)
    groups = k // group
    w32 = w.float()
    wg = w32.reshape(*w32.shape[:-2], groups, group, w32.shape[-1])
    wmin = wg.amin(dim=-2)
    wmax = wg.amax(dim=-2)
    scale = (wmax - wmin) * _RECIP_15
    scale = torch.where(scale > 0, scale, 1.0)
    # Zero-points stay floats (integer-valued), so an all-positive group
    # may take a negative one: no [0, 15] clip.
    zero = torch.round(-wmin / scale)
    q = torch.round(wg / scale[..., :, None, :] + zero[..., :, None, :])
    q = q.clamp(0, 15).to(torch.uint8).reshape(w32.shape)
    return {"q": pack_int4(q), "scale": scale.to(scale_dtype), "zero": zero.to(scale_dtype)}


def quantize_array(w: torch.Tensor, *, axis: int, scale_dtype=torch.float32) -> Params:
    """Symmetric int8 quantization with the scale reduced over ``axis``
    (the contraction axis for weights, the feature axis for embeddings)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis)
    scale = torch.where(amax > 0, amax * _RECIP_127, 1.0)
    q = torch.round(w32 / scale.unsqueeze(axis))
    q = q.clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(scale_dtype)}


def matmul(x: torch.Tensor, w: Any, kernels: Optional[FrozenSet[str]] = None) -> torch.Tensor:
    """``x @ w`` for a plain or an int8/int4-quantized weight. ``kernels``
    is the set of rungs routed to their kernel (``None``: read the
    environment now, as the JAX package does at trace time)."""
    if kernels is None:
        kernels = dispatch.resolve_quant_matmul()
    if is_int4(w):
        if "int4" in kernels and w["q"].dim() == 2:
            lead = x.shape[:-1]
            out = dispatch.int4_matmul(x.reshape(-1, x.shape[-1]), w["q"], w["scale"], w["zero"])
            return out.reshape(*lead, out.shape[-1])
        # The zero-point does not commute with the dot: dequantize first.
        return x @ dequantize_int4_parts(w["q"], w["scale"], w["zero"], x.dtype)
    if is_quantized(w):
        if "int8" in kernels and w["q"].dim() == 2:
            lead = x.shape[:-1]
            out = dispatch.int8_matmul(x.reshape(-1, x.shape[-1]), w["q"], w["scale"])
            return out.reshape(*lead, out.shape[-1])
        s = w["scale"].to(x.dtype)
        if w["q"].dim() > 2:  # stacked: scale [..., N], out [..., M, N]
            s = s[..., None, :]
        return (x @ w["q"].to(x.dtype)) * s
    return x @ w


def dequantize(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """The full-precision weight of a plain or quantized leaf."""
    if is_int4(w):
        return dequantize_int4_parts(w["q"], w["scale"], w["zero"], dtype)
    if is_quantized(w):
        return w["q"].to(dtype) * w["scale"].to(dtype)[..., None, :]
    return w


def embed_lookup(w: Any, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of a plain or row-quantized table; a quantized
    table returns its scale's dtype (the compute dtype)."""
    flat = ids.reshape(-1)
    if is_quantized(w):
        rows = w["q"].index_select(0, flat).to(w["scale"].dtype)
        rows = rows * w["scale"].index_select(0, flat)[:, None]
    else:
        rows = w.index_select(0, flat)
    return rows.reshape(*ids.shape, rows.shape[-1])


def tied_head_matmul(h: torch.Tensor, embed: Any) -> torch.Tensor:
    """``h @ embed.T`` for a tied LM head; the table's per-row scale is the
    head's per-column scale. A plain product, as the JAX package computes
    it outside any kernel: a quantized table is converted whole to
    ``h.dtype`` on every call."""
    if is_quantized(embed):
        return (h @ embed["q"].t().to(h.dtype)) * embed["scale"].to(h.dtype)
    return h @ embed.t()


def quantize_params(
    params: Params,
    scale_dtype=torch.float32,
    *,
    donate: bool = False,
    bits: int = 8,
    group_size: int = INT4_GROUP_SIZE,
) -> Params:
    """A quantized copy of a parameter tree: the layer matmul weights on
    the int8 (``bits=8``) or int4 group (``bits=4``) rung, the embedding
    (per row) and an untied LM head on int8 either way.

    ``donate=True`` frees each full-precision leaf's storage in place
    (``Tensor.set_()``) once it is quantized, the counterpart of the JAX
    package's donated buffers: peak memory is then one tensor's full and
    quantized copies, not two trees. Those input leaves are empty
    afterwards."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def consume(w: torch.Tensor, out: Params) -> Params:
        if donate:
            w.set_()
        return out

    def quant_w(w):
        return consume(w, quantize_array(w, axis=-2, scale_dtype=scale_dtype))

    def quant_rows(w):
        return consume(w, quantize_array(w, axis=-1, scale_dtype=scale_dtype))

    def quant_w4(w):
        return consume(w, quantize_array_int4(w, group_size=group_size,
                                              scale_dtype=scale_dtype))

    quant_layer = quant_w4 if bits == 4 else quant_w
    out: Params = dict(params)
    layers = dict(params["layers"])
    for key in QUANTIZED_LAYER_KEYS:
        if key in layers:
            layers[key] = quant_layer(layers[key])
    out["layers"] = layers
    out["embed"] = quant_rows(params["embed"])
    if "lm_head" in params:
        out["lm_head"] = quant_w(params["lm_head"])
    return out
