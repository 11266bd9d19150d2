#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one GPU.

    python3 tools/torch_profile.py [--preset qwen2.5-3b] [--rows 16] [--steps 10]

Builds the port's engine on ``cuda`` (random bf16 weights from a seeded
generator), admits ``--rows`` greedy requests with ~200-token prompts,
runs a few decode steps to warm up, then traces ``--steps`` engine steps
with ``torch.profiler`` (CPU and CUDA activities). Prints one JSON line:
host wall time per step, device busy time per step (the sum of kernel
times), the device's idle share, the count of kernel launches per step,
and the top kernels by device time. The full table goes to
``chiprun_out/torch_profile.txt``.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    engine = build_engine(f"preset://{args.preset}", device="cuda", dtype="bfloat16",
                          max_num_seqs=args.rows, max_model_len=512)
    engine.shutdown()  # drive the core directly, on this thread
    core = engine.core
    params = SamplingParams(temperature=0.0, max_tokens=400, ignore_eos=True)
    for i in range(args.rows):
        core.add_request(f"r{i}", prompt=("profile the decode step of the port " * 6)[:200] + str(i),
                         params=params)
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
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_profile.txt"), "w") as f:
        f.write(smi + "\n")
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    print(json.dumps(dict(
        tool="torch_profile", card=smi, preset=args.preset, rows=args.rows, steps=args.steps,
        wall_ms_per_step=wall * 1e3 / args.steps,
        device_busy_ms_per_step=busy_us / 1e3 / args.steps,
        device_idle_share=max(0.0, 1 - busy_us / 1e6 / wall),
        kernel_launches_per_step=launches / args.steps,
        top_kernels=[dict(name=e.key[:80], ms_per_step=e.self_device_time_total / 1e3 / args.steps,
                          calls_per_step=e.count / args.steps) for e in top],
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
