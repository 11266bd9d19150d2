#!/usr/bin/env python3
"""Least H100 time of the weight-only quantized matmuls (K6 int8,
``ops/csrc/int8_matmul.cu``; K7 int4, ``ops/csrc/int4_matmul.cu``) at one
model's projection shapes.

    python3 tools/torch_kernel_bounds.py [--model qwen2.5-3b | llama3.1-8b | ...]

Arithmetic only, no device. For each projection of one layer of the
preset (``llmq_tpu_torch/models/presets.py``) and a row count M (16: a
decode step of 16 sequences; 1,024: a chunk dispatch of 4 x 256), the
bytes the function must move — bf16 activations in, the packed weight
and its scales in the serving path's scale dtype, bf16 (int8: one per
output channel; int4: scale and zero per 128-row group,
``models/quant.py`` defaults), bf16 output — over 3.35 TB/s, against its
2*M*K*N operations over the dense bf16 peak of 989 TFLOP/s (the kernels
multiply in the activation dtype). The larger time is the bound. Prints
one JSON line per (kernel, M) with the per-projection rows and the
layer's sum.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llmq_tpu_torch.models.presets import get_preset  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16 = 989e12  # dense, H100 SXM
INT4_GROUP = 128
SCALE_BYTES = 2  # bf16: the serving path's scale dtype is the compute dtype


def projections(name: str) -> dict:
    cfg = get_preset(name)
    H, I, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    return {
        "q_proj": (H, cfg.num_heads * d), "k_proj": (H, cfg.num_kv_heads * d),
        "v_proj": (H, cfg.num_kv_heads * d), "o_proj": (cfg.num_heads * d, H),
        "gate_proj": (H, I), "up_proj": (H, I), "down_proj": (I, H),
    }


def bound(kernel: str, M: int, K: int, N: int) -> dict:
    weight = K * N if kernel == "int8" else K * N // 2
    scales = SCALE_BYTES * N if kernel == "int8" else 2 * SCALE_BYTES * (K // INT4_GROUP) * N
    nbytes = 2 * M * K + weight + scales + 2 * M * N
    ops = 2 * M * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16 * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="qwen2.5-3b", help="a preset name")
    args = ap.parse_args()
    for kernel, source in (("int8", "llmq_tpu/ops/pallas_matmul.py:145"),
                           ("int4", "llmq_tpu/ops/pallas_matmul.py:219")):
        for M in (16, 1024):
            rows = {p: bound(kernel, M, K, N) for p, (K, N) in projections(args.model).items()}
            print(json.dumps(dict(
                kernel=kernel, replaces=source, model=args.model, M=M,
                layer_bound_ms=sum(r["bound_ms"] for r in rows.values()), projections=rows,
            )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
