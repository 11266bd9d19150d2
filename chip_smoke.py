#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``llmq_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON line (a phase that fails exits non-zero):

1. ``nvidia-smi`` name and power limit (verbatim), then the build of every
   kernel under ``llmq_tpu_torch/ops/csrc`` with ``nvcc``, timed.
2. Each kernel against its plain PyTorch version on the card, on the same
   inputs, at the main path's shapes (qwen2.5-3b; the decode kernel also
   at gemma2-2b shapes with head_dim 256, softcap and window), in f32
   (tolerance 2e-5) and bf16 (3e-2; the decode kernel, whose math is f32
   as on the TPU, is also held within 1e-2 of the plain version run in
   f32 on the same bf16 values). Times: the kernel's, the plain
   version's and one PyTorch library call's device time per call in ms
   (``torch.profiler``: the summed time of every kernel and copy the call
   put on the card), the host span per call of back-to-back calls, and
   the least time the card could take (``bound_ms``).
3. The main path at full width: ``run_torch_worker`` serves 16 greedy
   jobs of qwen2.5-3b (36 layers, random weights from a seeded
   generator) over ``memory://``, 128 tokens each. Every kernel launch
   counter is set to 0 just before and read just after; each kernel must
   have launched, the decode kernel exactly 36 times per decode step.
4. f32 parity of the slice: the qwen2.5-3b widths at 2 layers with the
   same numpy-made weights, the port on ``cuda`` (kernels) against the
   port on ``cpu`` (plain versions): logits within 1e-4 and identical
   greedy tokens over 32 steps, with TF32 off.
5. ``{"kernels": [...]}``: one record per ported kernel.

The last line is ``{"ok": true, "device": {...}}``, printed only after
every phase ran and passed. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero before printing any
result.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, H100 SXM
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DECODE_F32_MATH_TOLERANCE = 1e-2  # bf16 K1 against the plain version in f32
ALL_PHASES = ("build", "kernels", "serve", "parity")
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def span_ms(fn, iters: int, warmup: int = 2) -> float:
    """Wall span per call of ``iters`` back-to-back ``fn(i)`` calls between
    two CUDA events: what a caller waits, the host's enqueue cost included."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn(i)``: the summed self device time of
    every kernel, copy and fill that ``iters`` calls put on the card, as
    ``torch.profiler`` traces them. The gaps in which the card waits for
    the host are left out."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        raise SystemExit("torch.profiler traced no device time")
    return busy_us / 1e3 / iters


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --- phase 2: kernels against their plain versions --------------------------


def check_decode(label, *, S, H, n_kv, d, L, page, max_ctx, dtype, softcap, window, iters, seed):
    from llmq_tpu_torch.ops import attention as plain
    from llmq_tpu_torch.ops.cuda_attention import paged_decode_attention_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    pps = max_ctx // page
    P = 1 + S * pps
    ctx = np.sort(rng.integers(1, max_ctx + 1, size=S))
    ctx[0], ctx[-1] = 0, max_ctx  # an inactive row and a full one
    bt = (1 + rng.permutation(S * pps)).reshape(S, pps).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, H, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((L, P, page, n_kv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((L, P, page, n_kv, d), generator=g, device=dev).to(dtype)
    bt_t = torch.from_numpy(bt).to(dev)
    ctx_t = torch.from_numpy(ctx.astype(np.int32)).to(dev)
    layer = L // 2
    scale = d ** -0.5
    kw = dict(scale=scale, sliding_window=window, softcap=softcap)
    out = paged_decode_attention_cuda(q, kp, vp, bt_t, ctx_t, layer=layer, **kw)
    ref = plain.paged_decode_attention(q, kp, vp, bt_t, ctx_t, layer=layer, **kw)
    torch.cuda.synchronize()
    # A ctx == 0 row is inactive: the kernel writes exact zeros, the plain
    # version a finite average (both never read). Compare the live rows.
    live_rows = ctx_t > 0
    err = (out[live_rows].float() - ref[live_rows].float()).abs().max().item()
    zero_row = out[0].float().abs().max().item()
    # The kernel's math is f32 whatever the storage (q, k and v upcast, as
    # in the TPU kernel); the plain version multiplies in bf16. So a bf16
    # run is also held, more tightly, against the plain version in f32 on
    # the same bf16 values: what is left is the output's rounding.
    f32_math_err = None
    if dtype != torch.float32:
        ref32 = plain.paged_decode_attention(
            q.float(), kp[layer:layer + 1].float(), vp[layer:layer + 1].float(),
            bt_t, ctx_t, layer=0, **kw)
        f32_math_err = (out[live_rows].float() - ref32[live_rows]).abs().max().item()
    # Times rotate over the layers: each launch reads another layer's
    # pages, so the 50 MB L2 holds none of them, as on the main path.
    def kernel(i):
        return paged_decode_attention_cuda(q, kp, vp, bt_t, ctx_t, layer=i % L, **kw)

    def plain_fn(i):
        return plain.paged_decode_attention(q, kp, vp, bt_t, ctx_t, layer=i % L, **kw)

    ms, host_ms = device_ms(kernel, iters), span_ms(kernel, iters)
    plain_ms = device_ms(plain_fn, max(3, iters // 10))
    # Library yardstick: SDPA over the same K/V gathered densely (per
    # layer, outside the timed region), a key mask for length and window.
    idx = bt_t.long()
    dense_k = [kp[i][idx].reshape(S, pps * page, n_kv, d).transpose(1, 2) for i in range(L)]
    dense_v = [vp[i][idx].reshape(S, pps * page, n_kv, d).transpose(1, 2) for i in range(L)]
    kpos = torch.arange(pps * page, device=dev)[None, :]
    keep = kpos < ctx_t[:, None].long()
    if window is not None:
        keep &= kpos >= ctx_t[:, None].long() - window
    mask = keep[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = device_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q4, dense_k[i % L], dense_v[i % L], attn_mask=mask, scale=scale, enable_gqa=True
    ), iters)
    # What the function must move: the live rows' queries in, every
    # output row out, each live key's K and V row once, the block-table
    # entries of the live pages and the context lengths.
    start = np.zeros_like(ctx) if window is None else np.maximum(ctx - window, 0)
    live = ctx - start
    live_pages = np.where(ctx > 0, (ctx - 1) // page - start // page + 1, 0)
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (
        (int((ctx > 0).sum()) + S) * H * d * item  # q of live rows in, out
        + 2 * int(live.sum()) * n_kv * d * item  # live K and V rows, once each
        + int(live_pages.sum()) * 4 + ctx.nbytes
    )
    ops = 4 * int(live.sum()) * H * d  # QK and PV multiply-adds
    b_ms, b_by = bound(nbytes, ops, dtype)
    rec = dict(
        phase="kernel_check", kernel="paged_decode", case=label, dtype=str(dtype)[6:],
        shape=dict(S=S, H=H, n_kv=n_kv, d=d, L=L, page=page, max_ctx=max_ctx,
                   window=window, softcap=softcap, layer=layer),
        max_abs_err=err, tolerance=TOLERANCE[dtype], ctx0_row_max=zero_row,
        max_abs_err_vs_f32_math=f32_math_err,
        tolerance_vs_f32_math=None if f32_math_err is None else DECODE_F32_MATH_TOLERANCE,
        ms=ms, host_span_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by, timing="torch.profiler device time per call",
    )
    emit(rec)
    if (not (err <= TOLERANCE[dtype]) or zero_row != 0.0
            or not (f32_math_err is None or f32_math_err <= DECODE_F32_MATH_TOLERANCE)):
        raise SystemExit(f"paged_decode {label} {dtype}: error {err}, against f32 math "
                         f"{f32_math_err}, ctx=0 row {zero_row}")
    return rec


def check_prefill(label, *, B, T, H, n_kv, d, lengths, dtype, softcap, window, iters, seed):
    from llmq_tpu_torch.ops import attention as plain
    from llmq_tpu_torch.ops.cuda_attention import flash_prefill_attention_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, H, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, T, n_kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, T, n_kv, d), generator=g, device=dev).to(dtype)
    len_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    kw = dict(scale=scale, sliding_window=window, softcap=softcap)
    out = flash_prefill_attention_cuda(q, k, v, len_t, **kw)
    ref = plain.full_prefill_attention(q, k, v, lengths=len_t, **kw)
    torch.cuda.synchronize()
    # Rows past a row's length are padding (never read): compare valid rows.
    err = max((out[b, :n].float() - ref[b, :n].float()).abs().max().item()
              for b, n in enumerate(lengths) if n)
    finite = bool(torch.isfinite(out.float()).all().item())
    def kernel(i):
        return flash_prefill_attention_cuda(q, k, v, len_t, **kw)

    ms, host_ms = device_ms(kernel, iters), span_ms(kernel, iters)
    plain_ms = device_ms(lambda i: plain.full_prefill_attention(
        q, k, v, lengths=len_t, **kw), max(3, iters // 4))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = device_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), iters)
    pairs = 0
    for n in lengths:
        qpos = np.arange(n)[:, None]
        kpos = np.arange(n)[None, :]
        m = kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        pairs += int(m.sum())
    # What the function must move: the valid rows' q, k and v once each,
    # the whole output (padding rows are written as zeros), the lengths.
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (sum(lengths) * (H + 2 * n_kv) * d + q.numel()) * item + B * 4
    ops = 4 * pairs * H * d  # QK and PV multiply-adds over the live pairs
    b_ms, b_by = bound(nbytes, ops, dtype)
    rec = dict(
        phase="kernel_check", kernel="flash_prefill", case=label, dtype=str(dtype)[6:],
        shape=dict(B=B, T=T, H=H, n_kv=n_kv, d=d, lengths=list(lengths),
                   window=window, softcap=softcap),
        max_abs_err=err, tolerance=TOLERANCE[dtype], finite=finite,
        ms=ms, host_span_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by, timing="torch.profiler device time per call",
    )
    emit(rec)
    if not (err <= TOLERANCE[dtype]) or not finite:
        raise SystemExit(f"flash_prefill {label} {dtype}: error {err}, finite {finite}")
    return rec


def phase_kernels(iters: int) -> dict:
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        rec = check_decode("qwen2.5-3b", S=16, H=16, n_kv=2, d=128, L=36, page=32,
                           max_ctx=1024, dtype=dtype, softcap=None, window=None,
                           iters=iters, seed=1)
        if dtype == torch.bfloat16:
            main["paged_decode"] = rec
        check_decode("gemma2-2b", S=16, H=8, n_kv=4, d=256, L=26, page=32, max_ctx=1024,
                     dtype=dtype, softcap=50.0, window=64, iters=iters, seed=2)
        lengths = [224, 200, 151, 37]
        rec = check_prefill("qwen2.5-3b", B=4, T=224, H=16, n_kv=2, d=128, lengths=lengths,
                            dtype=dtype, softcap=None, window=None, iters=iters, seed=3)
        if dtype == torch.bfloat16:
            main["flash_prefill"] = rec
        check_prefill("window+softcap", B=4, T=224, H=16, n_kv=2, d=128, lengths=lengths,
                      dtype=dtype, softcap=50.0, window=64, iters=iters, seed=4)
    return main


# --- phase 3: the main path at full width -----------------------------------


async def _submit(url: str, queue: str, jobs) -> None:
    from llmq_tpu_torch.broker.base import make_broker

    broker = make_broker(url)
    await broker.connect()
    for job in jobs:
        await broker.publish(queue, job.model_dump_json().encode(), message_id=job.id)
    await broker.close()


async def _receive(url: str, queue: str) -> list:
    from llmq_tpu_torch.broker.base import make_broker

    broker = make_broker(url)
    await broker.connect()
    results = []
    while (msg := await broker.get(queue + ".results")) is not None:
        results.append(json.loads(msg.body))
        await msg.ack()
    await broker.close()
    return results


def phase_serve(smi: str) -> dict:
    from llmq_tpu_torch.cli.worker import run_torch_worker
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.ops.cuda_attention import (
        flash_prefill_attention_cuda,
        paged_decode_attention_cuda,
    )

    n_jobs, gen, url, queue = 16, 128, "memory://chip-smoke", "smoke"
    base = ("Translate the following passage into French, keeping the tone formal and the "
            "terminology exact. The quarterly report shows steady growth in all regions; ")
    jobs = [
        Job(id=f"job-{i:02d}", prompt=(base + f"item {i} of {n_jobs}.")[:200],
            temperature=0.0, max_tokens=gen, ignore_eos=True, row=i, lang="fr")
        for i in range(n_jobs)
    ]
    asyncio.run(_submit(url, queue, jobs))
    paged_decode_attention_cuda.launches = 0
    flash_prefill_attention_cuda.launches = 0
    t0 = time.perf_counter()
    worker = run_torch_worker(
        "preset://qwen2.5-3b", queue, device="cuda", dtype="bfloat16",
        max_num_seqs=16, max_model_len=512, broker_url=url, max_jobs=n_jobs,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "paged_decode": paged_decode_attention_cuda.launches,
        "flash_prefill": flash_prefill_attention_cuda.launches,
    }
    results = asyncio.run(_receive(url, queue))
    core = worker.engine.core
    stats = core.stats()
    L = core.model_config.num_layers
    ids = [r["id"] for r in results]
    problems = []
    if len(results) != n_jobs or len(set(ids)) != n_jobs:
        problems.append(f"{len(results)} results, {len(set(ids))} unique ids")
    for r in results:
        if r["usage"]["completion_tokens"] != gen:
            problems.append(f"{r['id']}: {r['usage']}")
        if r.get("row") is None or r.get("lang") != "fr":
            problems.append(f"{r['id']}: extras not passed through")
    if launches["paged_decode"] <= 0 or launches["flash_prefill"] <= 0:
        problems.append(f"a kernel did not launch on the main path: {launches}")
    if launches["paged_decode"] != L * stats["decode_steps"]:
        problems.append(f"decode launches {launches['paged_decode']} != {L} x "
                        f"{stats['decode_steps']} decode steps")
    if launches["flash_prefill"] != L * stats["prefill_dispatches"]:
        problems.append(f"prefill launches {launches['flash_prefill']} != {L} x "
                        f"{stats['prefill_dispatches']} prefill dispatches")

    # Step rates of the same model on the card, synchronised, after the
    # counted run: one prefill of 4 x ~200-token prompts, one decode step
    # of 16 rows at context ~330.
    model, dev = core.model, core.device
    tok = torch.randint(1, 257, (4, 224), device=dev, dtype=torch.int32)
    lengths = torch.tensor([200, 200, 200, 200], device=dev, dtype=torch.int32)
    bt = torch.arange(1, 1 + 4 * 8, device=dev, dtype=torch.int32).reshape(4, 8)
    bt = torch.nn.functional.pad(bt, (0, core._pages_per_seq - 8))
    def prefill(i):
        return model.prefill(tok, lengths, core.k_pages, core.v_pages, bt)

    pre_ms, pre_dev_ms = span_ms(prefill, 5), device_ms(prefill, 3)
    S = 16
    dbt = torch.arange(1, 1 + S * 12, device=dev, dtype=torch.int32).reshape(S, 12)
    dbt = torch.nn.functional.pad(dbt, (0, core._pages_per_seq - 12))
    dtok = torch.randint(1, 257, (S,), device=dev, dtype=torch.int32)
    dctx = torch.full((S,), 330, device=dev, dtype=torch.int32)
    active = torch.ones((S,), device=dev, dtype=torch.bool)
    def decode(i):
        return model.decode(dtok, dctx, core.k_pages, core.v_pages, dbt, active)

    dec_ms, dec_dev_ms = span_ms(decode, 10), device_ms(decode, 5)
    gen_tokens = sum(r["usage"]["completion_tokens"] for r in results)
    prompt_tokens = sum(r["usage"]["prompt_tokens"] for r in results)
    rec = dict(
        phase="serve", model="preset://qwen2.5-3b", layers=L, jobs=len(results),
        gen_tokens=gen_tokens, prompt_tokens=prompt_tokens, wall_s=wall,
        serve_completion_tok_s=gen_tokens / wall,
        decode_tok_s=S / (dec_ms / 1e3), decode_step_ms=dec_ms,
        decode_step_device_ms=dec_dev_ms, decode_idle_share=max(0.0, 1 - dec_dev_ms / dec_ms),
        prefill_tok_s=800 / (pre_ms / 1e3), prefill_4x200_ms=pre_ms,
        prefill_4x200_device_ms=pre_dev_ms,
        launches=launches, decode_steps=stats["decode_steps"],
        prefill_dispatches=stats["prefill_dispatches"], card=smi, problems=problems,
    )
    emit(rec)
    if problems:
        raise SystemExit("serve phase failed: " + "; ".join(problems[:5]))
    worker.engine.core.model = None  # free the 3B weights before phase 4
    return launches


# --- phase 4: f32 parity of the slice, card against CPU ---------------------


def _numpy_params(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, L, H, I = cfg.head_dim_, cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def w(shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32) / np.float32(math.sqrt(fan_in)))

    layers = {
        "ln1": np.ones((L, H), np.float32), "ln2": np.ones((L, H), np.float32),
        "q_proj": w((L, H, cfg.num_heads * d), H),
        "k_proj": w((L, H, cfg.num_kv_heads * d), H),
        "v_proj": w((L, H, cfg.num_kv_heads * d), H),
        "o_proj": w((L, cfg.num_heads * d, H), cfg.num_heads * d),
        "gate_proj": w((L, H, I), H), "up_proj": w((L, H, I), H),
        "down_proj": w((L, I, H), I),
        # Nonzero biases, so the QKV-bias path is exercised too.
        "q_bias": w((L, cfg.num_heads * d), 16),
        "k_bias": w((L, cfg.num_kv_heads * d), 16),
        "v_bias": w((L, cfg.num_kv_heads * d), 16),
    }
    return {"embed": w((cfg.vocab_size, H), H), "layers": layers,
            "final_norm": np.ones((H,), np.float32)}


def phase_parity() -> dict:
    from llmq_tpu_torch.engine.engine import EngineConfig, EngineCore
    from llmq_tpu_torch.engine.sampling import SamplingParams
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models.convert import params_from_numpy
    from llmq_tpu_torch.models.presets import get_preset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_preset("qwen2.5-3b"), num_layers=2)
    tree = _numpy_params(cfg, seed=7)
    prompts = [
        "The capital of France is",
        "def fibonacci(n):\n    if n < 2:",
        "Once upon a time, in a kingdom by the sea, there lived",
        "Q: What is 12 times 12?\nA:",
    ]
    ecfg = dict(max_num_seqs=4, max_model_len=256, page_size=32, num_pages=64,
                kv_dtype="f32", min_prefill_bucket=32)
    outs, logits = {}, {}
    for dev in ("cuda", "cpu"):
        params = params_from_numpy(tree, device=dev)
        core = EngineCore(cfg, params, ByteTokenizer(), engine_config=EngineConfig(**ecfg),
                          device=dev)
        # Model-level logits: one prefill of the 4 prompts + one decode step.
        tok = ByteTokenizer()
        ids = [tok.encode(p) for p in prompts]
        T = 64
        tokens = torch.zeros((4, T), dtype=torch.int32)
        for r, row in enumerate(ids):
            tokens[r, : len(row)] = torch.tensor(row)
        lengths = torch.tensor([len(r) for r in ids], dtype=torch.int32)
        bt = torch.arange(1, 1 + 4 * 8, dtype=torch.int32).reshape(4, 8)
        args = [x.to(core.device) for x in (tokens, lengths, bt)]
        pre = core.model.prefill(args[0], args[1], core.k_pages, core.v_pages, args[2])
        nxt = pre.argmax(-1).to(torch.int32)
        dec = core.model.decode(nxt, args[1], core.k_pages, core.v_pages, args[2],
                                torch.ones(4, dtype=torch.bool, device=core.device))
        logits[dev] = (pre.cpu(), dec.cpu())
        core.k_pages.zero_()
        core.v_pages.zero_()
        params_s = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
        for i, p in enumerate(prompts):
            core.add_request(f"r{i}", prompt=p, params=params_s)
        done = {}
        while core.has_work:
            for o in core.step():
                done[o.rid] = o.token_ids
        outs[dev] = done
        del core, params
    err_pre = (logits["cuda"][0] - logits["cpu"][0]).abs().max().item()
    err_dec = (logits["cuda"][1] - logits["cpu"][1]).abs().max().item()
    same = outs["cuda"] == outs["cpu"] and all(len(v) == 32 for v in outs["cuda"].values())
    rec = dict(
        phase="parity_f32", config="qwen2.5-3b widths, 2 layers",
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        prefill_logits_max_abs_err=err_pre, decode_logits_max_abs_err=err_dec,
        tolerance=1e-4, greedy_tokens_identical=same,
        tokens_compared=sum(len(v) for v in outs["cuda"].values()),
    )
    emit(rec)
    if not (err_pre <= 1e-4 and err_dec <= 1e-4 and same):
        raise SystemExit("f32 parity failed")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of phases to run (default: all; a subset prints "
                         "no result line)")
    ap.add_argument("--iters", type=int, default=30, help="timed launches per kernel")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 2
    from llmq_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), count=torch.cuda.device_count()))
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, log in _build.build_logs.items():
            f.write(f"=== {name}\n{log}\n")
    emit(dict(phase="build", seconds=build_s, libraries=[os.path.basename(p) for p in paths.values()]))

    main_recs, launches = {}, {}
    if "kernels" in phases:
        main_recs = phase_kernels(args.iters)
    if "serve" in phases:
        launches = phase_serve(smi)
        torch.cuda.empty_cache()
    if "parity" in phases:
        phase_parity()
    if not phases >= set(ALL_PHASES):
        print("chip_smoke: phases skipped; no result line", file=sys.stderr)
        return 0
    kernels = []
    for name, source, replaces in (
        ("paged_decode", "llmq_tpu_torch/ops/csrc/paged_decode.cu",
         "llmq_tpu/ops/pallas_attention.py:168"),
        ("flash_prefill", "llmq_tpu_torch/ops/csrc/flash_prefill.cu",
         "llmq_tpu/ops/pallas_attention.py:1039"),
    ):
        rec = main_recs.get(name, {})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get(name), max_abs_err=rec.get("max_abs_err"),
            ms=rec.get("ms"), plain_ms=rec.get("plain_ms"), bound_ms=rec.get("bound_ms"),
            bound_by=rec.get("bound_by"), library_ms=rec.get("library_ms"),
        ))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
