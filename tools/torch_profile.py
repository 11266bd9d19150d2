#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one GPU.

    python3 tools/torch_profile.py [--preset qwen2.5-3b] [--rows 16] [--steps 10]
    python3 tools/torch_profile.py --prefix [--decode-kernel v3]
    python3 tools/torch_profile.py --dtype int8 | --dtype int4 --preset llama3.1-8b --kv-dtype fp8

Builds the port's engine on ``cuda`` (random bf16 weights from a seeded
generator), admits ``--rows`` greedy requests, runs a few decode steps to
warm up, then traces ``--steps`` engine steps with ``torch.profiler``
(CPU and CUDA activities). Prints one JSON line: host wall time per step,
device busy time per step (the sum of kernel times), the device's idle
share, the count of kernel launches per step, and the top kernels by
device time. The full table goes to ``chiprun_out/torch_profile.txt``.

The default requests are ~200-token prompts on the bucketed path. With
``--prefix`` the engine runs chunked prefill (chunks of 256) with the
prefix cache, the requests share a 1,024-token template with distinct
tails (as ``chip_smoke.py``'s prefix-cache phase), and a second JSON line
profiles one chunk dispatch of 4 x 256 positions at context 1,024
(``chiprun_out/torch_profile_chunk.txt``); without it, the second line
profiles one bucketed prefill dispatch of 4 x 200-token prompts in a
224-token bucket (``chiprun_out/torch_profile_prefill.txt``), the step
``chip_smoke.py``'s serve phase times. ``--decode-kernel`` sets
``LLMQ_DECODE_KERNEL`` for the engine (v1 = K1, v2 = K5, v3 = K4).
``--dtype int8|int4`` serves weight-only quantized weights with bf16
compute; unless ``LLMQ_INT8_MATMUL`` / ``LLMQ_INT4_MATMUL`` are set in the
environment, the tool sets both to ``pallas``, so the projections run
through K6 / K7. ``--kv-dtype fp8`` stores the KV pool as float8_e5m2.

For an MoE preset (``--preset qwen1.5-moe-a2.7b``) a third line splits the
decode step's device time (``moe_decode_split``): attention (K1's
kernels in the step's trace) and each stage of the MoE MLP timed alone on
layer 0 at the step's rows, times the layers: the router (logits,
softmax, top k), the dequantize of the three expert stacks, the expert
products of the sync-free form, the weighted combine and the shared
expert; the rest of the step (projections, norms, head, sampling) is
what remains (``chiprun_out/torch_profile_moe.txt``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llmq_tpu_torch.cli.worker import build_engine  # noqa: E402
from llmq_tpu_torch.engine.sampling import SamplingParams  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="qwen2.5-3b")
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--prefix", action="store_true",
                    help="chunked prefill + prefix cache, templated ~1,124-token prompts")
    ap.add_argument("--decode-kernel", choices=("v1", "v2", "v3"), default=None)
    ap.add_argument("--dtype", choices=("bfloat16", "int8", "int4"), default="bfloat16")
    ap.add_argument("--kv-dtype", choices=("bf16", "fp8"), default=None)
    args = ap.parse_args()
    if args.decode_kernel:
        os.environ["LLMQ_DECODE_KERNEL"] = args.decode_kernel
    if args.dtype != "bfloat16":
        for var in ("LLMQ_INT8_MATMUL", "LLMQ_INT4_MATMUL"):
            os.environ.setdefault(var, "pallas")
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    chunk = 256 if args.prefix else None
    engine = build_engine(f"preset://{args.preset}", device="cuda", dtype=args.dtype,
                          kv_dtype=args.kv_dtype,
                          max_num_seqs=args.rows, max_model_len=2048 if args.prefix else 512,
                          prefill_chunk_size=chunk, enable_prefix_caching=args.prefix)
    engine.shutdown()  # drive the core directly, on this thread
    core = engine.core
    params = SamplingParams(temperature=0.0, max_tokens=400, ignore_eos=True)
    for i in range(args.rows):
        if args.prefix:
            prompt = ("template of a templated batch job; " * 40)[:1024] + f" tail {i} " * 10
        else:
            prompt = ("profile the decode step of the port " * 6)[:200] + str(i)
        core.add_request(f"r{i}", prompt=prompt, params=params)
    while core.prefills < args.rows:
        core.step()
    for _ in range(5):
        core.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            core.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report("decode_step", prof, wall, args.steps, smi, args, core, "torch_profile.txt")
    if core.model_config.num_experts:
        moe_split(core, prof, args, smi)
    B, dev = 4, core.device
    if args.prefix:
        n_pages = (1024 + chunk) // core.cfg.page_size
        tok = torch.randint(1, 257, (B, chunk), device=dev, dtype=torch.int32)
        pos = torch.arange(1024, 1024 + chunk, device=dev, dtype=torch.int32).repeat(B, 1)
        last = torch.full((B,), chunk - 1, device=dev, dtype=torch.int32)
    else:
        n_pages = 8
        tok = torch.randint(1, 257, (B, 224), device=dev, dtype=torch.int32)
        lengths = torch.full((B,), 200, device=dev, dtype=torch.int32)
    bt = torch.arange(1, 1 + B * n_pages, device=dev, dtype=torch.int32).reshape(B, -1)
    bt = torch.nn.functional.pad(bt, (0, core._pages_per_seq - n_pages))

    def dispatch():
        if args.prefix:
            return core.model.prefill_chunk(tok, pos, core.k_pages, core.v_pages, bt, last)
        return core.model.prefill(tok, lengths, core.k_pages, core.v_pages, bt)

    dispatch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            dispatch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.prefix:
        report("chunk_dispatch_4x256_at_1024", prof, wall, args.steps, smi, args, core,
               "torch_profile_chunk.txt")
    else:
        report("prefill_dispatch_4x200", prof, wall, args.steps, smi, args, core,
               "torch_profile_prefill.txt")
    return 0


def _device_ms(fn, iters: int = 10) -> float:
    """Summed device time per call of ``fn()`` over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters


def moe_split(core, step_prof, args, smi) -> None:
    """The MoE decode step's device time by stage (see the module doc)."""
    from llmq_tpu_torch.models import quant as qm
    from llmq_tpu_torch.models import transformer as tt

    cfg, L, rows = core.model_config, core.model_config.num_layers, args.rows
    lp = core.model.layer_params(0)
    dtype = core.model.top["final_norm"].dtype
    x = torch.randn((rows, cfg.hidden_size), device=core.device, dtype=dtype)
    experts = ("expert_gate_proj", "expert_up_proj", "expert_down_proj")
    plain = dict(lp, **{k: qm.dequantize(lp[k], dtype) for k in experts})
    top_w, top_e = tt.moe_route(x, lp["router"], cfg)
    down, flat = tt._moe_sync_free(x, top_e, plain, cfg.activation)
    kernels = core.model.quant_kernels

    def combine():
        contrib = down * top_w.reshape(-1)[flat].to(down.dtype)[..., None]
        out = contrib[:, 0]
        for j in range(1, contrib.shape[1]):
            out = out + contrib[:, j]
        return out

    def shared():
        out = tt._mlp(x, {"gate_proj": lp["shared_gate_proj"], "up_proj": lp["shared_up_proj"],
                          "down_proj": lp["shared_down_proj"]}, cfg.activation, kernels)
        return torch.sigmoid(x @ lp["shared_expert_gate"]) * out

    stages = {
        "router": lambda: tt.moe_route(x, lp["router"], cfg),
        "dequantize": lambda: [qm.dequantize(lp[k], dtype) for k in experts],
        "expert_products": lambda: tt._moe_sync_free(x, top_e, plain, cfg.activation),
        "combine": combine,
    }
    if cfg.shared_expert_intermediate_size:
        stages["shared_expert"] = shared
    ms = {name: L * _device_ms(fn) for name, fn in stages.items()}
    events = step_prof.key_averages()
    step_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    attn_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "paged_decode" in e.key)
    ms["attention"] = attn_us / 1e3 / args.steps
    step_ms = step_us / 1e3 / args.steps
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "chiprun_out")
    with open(os.path.join(out_dir, "torch_profile_moe.txt"), "w") as f:
        f.write(smi + "\n")
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    print(json.dumps(dict(
        tool="torch_profile", what="moe_decode_split", card=smi, preset=args.preset,
        rows=rows, dtype=args.dtype, layers=L, step_device_ms=step_ms,
        stage_ms_per_step=ms, other_ms_per_step=step_ms - sum(ms.values()),
        timing="attention: K1's kernels in the traced steps; each MoE stage timed alone on "
               "layer 0 at the step's rows (torch.profiler device time), times the layers",
    )))


def report(what, prof, wall, steps, smi, args, core, table_name) -> None:
    """One JSON line for a profiled window of ``steps`` steps, and the
    full kernel table under ``chiprun_out/``."""
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, table_name), "w") as f:
        f.write(smi + "\n")
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    print(json.dumps(dict(
        tool="torch_profile", what=what, card=smi, preset=args.preset, rows=args.rows,
        steps=steps, prefix=args.prefix, decode_kernel=core.stats()["decode_kernel"],
        dtype=args.dtype, kv_dtype=core.stats()["kv_dtype"],
        quant_kernels=sorted(core.model.quant_kernels),
        wall_ms_per_step=wall * 1e3 / steps,
        device_busy_ms_per_step=busy_us / 1e3 / steps,
        device_idle_share=max(0.0, 1 - busy_us / 1e6 / wall),
        kernel_launches_per_step=launches / steps,
        top_kernels=[dict(name=e.key[:80], ms_per_step=e.self_device_time_total / 1e3 / steps,
                          calls_per_step=e.count / steps) for e in top],
    )))


if __name__ == "__main__":
    sys.exit(main())
