#!/usr/bin/env python3
"""What bounds K6's tensor-core kernels, and K4's and K5's against K1's, on the card.

    python3 tools/torch_kernel_probe.py [--iters 50] [--probes decode,int8]

K6 (``llmq_tpu_torch/ops/csrc/int8_matmul_tc.cu``) is timed whole and
with parts of its loop removed: each variant is the source with one text
substitution (asserted to apply), built by ``nvcc`` into
``build/probe/`` (one process per variant, all started together), so it
keeps its launch, copies and barriers but for the removed part and
computes garbage. The variants of one shape are timed in turns, at
``chip_smoke.py`` phase 2's shapes (bf16, scales bf16): qwen2.5-3b
gate/up_proj and llama3.1-8b down_proj at M = 16 (decode kernel) and
1,024 (prefill kernel). The decode probe times, in turns, K1, K4
(``paged_decode_tc.cu`` with its fused write), K5 with its chunk of
pages a ring stage (``paged_decode_attention_v2_cuda``) and the same
kernel at K1's one tile a stage, at phase 2's qwen2.5-3b decode shape
(contexts up to 1,024) and at contexts up to 8,192, over a bf16 and an
e5m2 pool. Times are ``torch.profiler`` device time
per call, as in ``chip_smoke.py``. Prints one JSON line per measurement
and writes them to ``chiprun_out/kernel_probe.jsonl``. Needs one CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from llmq_tpu_torch.ops import _build  # noqa: E402
from llmq_tpu_torch.ops import cuda_matmul as cm  # noqa: E402

SOURCE = os.path.join(ROOT, "llmq_tpu_torch", "ops", "csrc", "int8_matmul_tc.cu")
PROBE_DIR = os.path.join(ROOT, "build", "probe")
OUT = os.path.join(ROOT, "chiprun_out", "kernel_probe.jsonl")

_PRE_WGMMA = """#pragma unroll
    for (int s = 0; s < kKT / 16; ++s)
      wgmma_m64n128_rs(acc, a[s], gmma_desc(x_s + s * 16, 16, 1024), !(first && s == 0));
"""
_PRE_WIDEN = [("    widen_a(0, a0);\n", ""), ("    widen_a(1, a1);\n", ""),
              ("      widen_a(j + 2, a_cur);\n", "")]
_PRE_TMA = """        tma_load_2d(st, &tmap_x, k0, m0, full + s);
        tma_load_2d(st + kPreX, &tmap_q, n0, k0, full + s);
"""
_DEC_TMA = """        tma_load_2d(st, &tmap_q, n0, k0, full + s);
        if (second) tma_load_2d(st + kDecHalf, &tmap_q, n0 + 128, k0, full + s);
        tma_load_2d(st + kDecW, &tmap_x, k0, m0, full + s);
"""
# variant -> [(text, replacement)]: what each removes
VARIANTS = {
    "whole": [],
    "prefill_no_widen": _PRE_WIDEN,
    "prefill_no_wgmma": [(_PRE_WGMMA, "")],
    "prefill_copies_only": _PRE_WIDEN + [(_PRE_WGMMA, "")],
    "prefill_no_copies": [(_PRE_TMA, ""),
                          ("mbar_expect_tx(full + s, kPreStage);", "mbar_expect_tx(full + s, 0);")],
    "decode_no_compute": [("    for (int s = 0; s < kKT / 16; ++s) {\n      uint32_t a[4];",
                           "    for (int s = 0; s < 0; ++s) {\n      uint32_t a[4];")],
    "decode_no_copies": [(_DEC_TMA, ""),
                         ("mbar_expect_tx(full + s, kDecStage - (second ? 0 : kDecHalf));",
                          "mbar_expect_tx(full + s, 0);")],
    "no_combine": [("  combine_kernel<TS><<<", "  if (false) combine_kernel<TS><<<")],
}
SHAPES = (("qwen2.5-3b gate/up_proj", 2048, 11008), ("llama3.1-8b down_proj", 14336, 4096))


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def device_ms(fn, iters: int) -> float:
    """Summed device time per call of ``fn()`` under ``torch.profiler``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        raise SystemExit("torch.profiler traced no device time")
    return busy_us / 1e3 / iters


def build_variants() -> dict:
    """Variant name -> its loaded library's entry point."""
    os.makedirs(PROBE_DIR, exist_ok=True)
    text = open(SOURCE).read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: the text to replace is not in the source once")
            src = src.replace(old, new)
        cu = os.path.join(PROBE_DIR, f"int8_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = cu[:-3] + ".so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib, cu]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(lib).llmq_int8_matmul_tc
        fn.argtypes = cm._INT8_TC[2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def probe_int8(fns: dict, iters: int) -> None:
    from llmq_tpu_torch.models import quant as qm

    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    for label, K, N in SHAPES:
        g = torch.Generator(device=dev).manual_seed(K + N)
        w = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
        qt = qm.quantize_array(w.bfloat16(), axis=-2, scale_dtype=torch.bfloat16)
        del w
        for M in (16, 1024):
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            plan = cm.int8_tc_plan(M, N, K, sms)
            out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            part = (torch.empty(plan["splits"] * M * N, dtype=torch.float32, device=dev)
                    if plan["splits"] > 1 else None)
            stream = torch.cuda.current_stream(dev).cuda_stream
            kind = "decode" if plan["kind"] == 0 else "prefill"
            names = [n for n in VARIANTS
                     if n == "whole" or n.startswith(kind) or (n == "no_combine" and part is not None)]

            def call(fn):
                code = fn(x.data_ptr(), qt["q"].data_ptr(), qt["scale"].data_ptr(),
                          out.data_ptr(), None if part is None else part.data_ptr(), 1,
                          plan["kind"], M, N, K, plan["splits"], plan["stages"], stream)
                if code:
                    raise SystemExit(f"launch failed: CUDA error {code}")

            times = {n: [] for n in names}
            for turn in (names, names[::-1]):
                for n in turn:
                    times[n].append(device_ms(lambda: call(fns[n]), iters))
            for n in names:
                emit(dict(kernel="int8_matmul", case=label, M=M, K=K, N=N, plan=plan, variant=n,
                          ms=sum(times[n]) / 2, ms_turns=times[n]))


def probe_decode(iters: int) -> None:
    """K1, K4, K5 (a chunk of pages a ring stage) and K5 at K1's plan (one
    tile a stage), all on the tensor-core route, at phase 2's qwen2.5-3b
    decode shape and at contexts up to 8,192."""
    from llmq_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    S, H, n_kv, d, L, page = 16, 16, 2, 128, 36, 32
    kw = dict(scale=d**-0.5)
    for max_ctx, layers in ((1024, L), (8192, 8)):
        pps = max_ctx // page
        g = torch.Generator(device=dev).manual_seed(1)
        ctx = torch.linspace(1, max_ctx, S, device=dev).to(torch.int32)
        bt = (1 + torch.randperm(S * pps, generator=g, device=dev)).reshape(S, pps).to(torch.int32)
        q = torch.randn((S, H, d), generator=g, device=dev).bfloat16()
        k_new = torch.randn((S, n_kv, d), generator=g, device=dev).bfloat16()
        v_new = torch.randn((S, n_kv, d), generator=g, device=dev).bfloat16()
        for kv_dtype in (torch.bfloat16, torch.float8_e5m2):
            shape = (layers, 1 + S * pps, page, n_kv, d)
            kp = torch.randn(shape, generator=g, device=dev).to(kv_dtype)
            vp = torch.randn(shape, generator=g, device=dev).to(kv_dtype)
            step = [0]

            def layer():  # each launch reads another layer: no L2 reuse
                step[0] += 1
                return step[0] % layers

            calls = {
                "paged_decode": lambda: ca.paged_decode_attention_cuda(
                    q, kp, vp, bt, ctx, layer=layer(), **kw),
                "paged_decode_v3": lambda: ca.paged_decode_attention_v3_cuda(
                    q, kp, vp, k_new, v_new, bt, ctx, layer=layer(), **kw),
                "paged_decode_v2": lambda: ca.paged_decode_attention_v2_cuda(
                    q, kp, vp, bt, ctx, layer=layer(), **kw),
                "paged_decode_v2_k1_plan": lambda: ca._decode_tc(
                    q, kp, vp, None, None, bt, ctx, layer=layer(), sliding_window=None,
                    softcap=None, tiles_per_stage=1, **kw),
            }
            tps = ca.decode_tc_tiles_per_stage(S, n_kv, page, pps, d, kp.element_size(),
                                               _build.sm_count(dev))
            plans = {"tiles_per_stage": tps, "k5": ca.decode_tc_plan(
                S, n_kv, max_ctx, d, kp.element_size(), _build.sm_count(dev), tps),
                "k1": ca.decode_tc_plan(S, n_kv, max_ctx, d, kp.element_size(),
                                        _build.sm_count(dev))}
            times = {name: [] for name in calls}
            for turn in (list(calls), list(calls)[::-1]):
                for name in turn:
                    times[name].append(device_ms(calls[name], iters))
            for name, ts in times.items():
                emit(dict(kernel=name, case="qwen2.5-3b", max_ctx=max_ctx,
                          kv_dtype=str(kv_dtype)[6:], route="tensor_core", plans=plans,
                          ms=sum(ts) / 2, ms_turns=ts))
            del kp, vp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50, help="timed launches per measurement")
    ap.add_argument("--probes", default="decode,int8", help="comma list: decode, int8")
    args = ap.parse_args()
    probes = set(args.probes.split(","))
    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    open(OUT, "w").close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit(dict(card=smi.splitlines()[0]))
    if "decode" in probes:
        probe_decode(args.iters)
    if "int8" in probes:
        probe_int8(build_variants(), args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
