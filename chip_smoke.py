#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``llmq_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON line (a phase that fails exits non-zero):

1. ``nvidia-smi`` name and power limit (verbatim), then the build of every
   kernel under ``llmq_tpu_torch/ops/csrc`` with ``nvcc`` (one process per
   source, all started together), timed.
2. Each kernel against its plain PyTorch version on the card, on the same
   inputs, in f32 (tolerance 2e-5) and bf16 (3e-2), at the main paths'
   shapes (qwen2.5-3b) and at gemma2-2b shapes (head_dim 256, softcap 50,
   window 64): K1 paged decode, K2 flash prefill, K3 chunked prefill
   (chunks of 256 at contexts 0 / 256 / 1040, a row with no valid query;
   every kernel runs bf16 on its tensor-core route and f32 on its exact
   route, and each check asserts the route its launch took),
   K5 chunked decode (whose bf16 output must equal K1's bit for bit on
   the same inputs, over bf16 and e5m2 pools) and K4 fused-write decode
   (whose pools must equal
   ``write_kv_pages`` + the plain decode bit for bit on pages >= 1). The
   decode kernels, whose math is f32 as on the TPU, are also held within
   1e-2 of the plain version run in f32 on the same bf16 values. K1, K3,
   K4 and K5 again over a float8_e5m2 pool (the plain version on the same
   pool; K4 stores one row past e5m2's range, which must give +-57,344
   and +-inf exactly as the plain cast does). K6 (int8) and K7 (int4)
   weight-only matmuls at qwen2.5-3b's projection shapes and
   llama3.1-8b's down_proj, M = 16 and 1,024, and K6 at llama3.1-8b's
   untied head (M = 16, K 4,096, N 128,256), and K3 at the speculative
   verify step's shape (16 rows of Q = 4 queries at contexts ~300-360)
   beside K1 at the same contexts: in f32 both the kernel and
   the plain version within 1e-5 / 1e-4 (K6) and 1e-4 (K7) of the f64
   product, in bf16 the kernel within 2e-2 of the plain version. Times:
   the kernel's, the plain version's and one PyTorch library call's
   device time per call in ms (``torch.profiler``: the summed time of
   every kernel and copy the call put on the card), the host span per
   call of back-to-back calls, and the least time the card could take
   (``bound_ms``). K6/K7's library call is cuBLAS on the weight
   dequantized to bf16 (no single PyTorch call computes their function).
3. The default path at full width: ``run_torch_worker`` serves 16 greedy
   jobs of qwen2.5-3b (36 layers, random weights from a seeded
   generator) over ``memory://``, 128 tokens each. Every kernel launch
   counter is set to 0 just before and read just after: K1 must launch 36
   times per decode step and K2 36 times per prefill dispatch, every K1
   and K2 launch on the tensor-core route. Every decode-type dispatch of
   phases 3-5 and 8-10 is a replay of a captured CUDA graph (the engine's
   count of replays must equal its dispatches); a replay adds the
   launches its graph's capture counted, and the decode iterations run
   eagerly on inactive rows before each capture (``warmup_steps``) count
   as steps. After the counted run each serve phase times one decode
   dispatch both ways: the model's eager decode step, and the engine's
   captured graph replayed (``captured_*``: host span, device time, idle
   share). Then the same jobs on a fresh engine of the same weights and
   settings, each prefilled alone: an engine pads the jobs waiting at a
   step to 4 prefill rows and a job waiting alone to 1 (as the JAX
   engine does), in bf16 the two shapes round apart, and a worker
   process takes its jobs as they arrive, so each job of a worker
   process may take either shape. Phases 9, 11 (d), 12 (c) and 13 (b)
   hold each of a worker process's results to the first tokens of phase
   3's run or of this solo run, and each solo row that parts from phase
   3's must part at a near-tie (the witness of phase 11 (b)); printed:
   how many results took each shape.
4. The prefix-cache path at full width: the same model with
   ``LLMQ_DECODE_KERNEL=v3``, ``prefill_chunk_size=256`` and
   ``enable_prefix_caching=True`` serves 16 greedy jobs sharing a
   ~1,024-token template with distinct tails, 64 tokens each. Counters as
   above: K3 launches 36 times per chunk dispatch and K4 36 times per
   decode step, all on the tensor-core route, K1, K2 and K5 never; the
   prefix cache must hit.
5. Quantized weights at full width, ``LLMQ_INT8_MATMUL=pallas
   LLMQ_INT4_MATMUL=pallas``: phase 3's workload served by qwen2.5-3b
   ``dtype="int8"`` (K6 launches 7 x 36 per dispatch) and by llama3.1-8b
   ``dtype="int4"`` with ``kv_dtype="fp8"`` (K7 7 x 32 per dispatch, K6
   once per dispatch for the untied int8 head, K1 over the e5m2 pool),
   with step rates; K1, K2, K6 and K7 on the tensor-core route only.
6. f32 parity, card against CPU, with TF32 off: the qwen2.5-3b widths at
   2 layers with the same numpy-made weights. The default path (bucketed
   prefill + K1) with f32 weights, with int8 and int4 weights (through K6
   / K7 on the card) and with an fp8 KV pool: logits within 1e-4 and
   identical greedy tokens over 32 steps, K1, K6 and K7 on their exact
   route only. Then the chunked + prefix-cache
   path under each of ``LLMQ_DECODE_KERNEL`` v1, v2 and v3: chunk and
   decode logits within 1e-4, identical tokens (greedy, and one seeded
   request at temperature 0.8 through the threefry sampler) and
   prefix-cache counters, every K4 and K5 launch on its exact route.
   Then the fused dispatch modes (``decode_block`` 4, ``spec_tokens`` 2,
   ``mixed_step`` on): verify and mixed-step logits within 1e-4, greedy
   tokens identical to the CPU's and to the mode's "off" run, a seeded
   request at temperature 0.8 identical to the CPU's, K3 on its exact
   route.
7. ``{"kernels": [...]}``: one record per ported kernel, each with the
   tensor-core route's bf16 time as ``ms`` and the exact route's f32
   time as ``exact_f32_ms``; K6's and K7's also their M = 1,024 time,
   library time and bound (``m1024_*``). K5's launches are phase 8's;
   K3's record adds its launches on phase 10's verify and mixed paths
   and its verify-shape times (``verify_shape_*``); K1's and K2's add
   their launches in phase 11 (a) (``snapshot_launches``); K1-K4's add
   their launches in phase 12 (``prefix_kv_launches``: K3, K4 in (a), K1,
   K2 in (c)'s in-process run), and phase 13 (a)'s
   (``failure_policy_launches``), phase 14's (``pipeline_launches``)
   and phase 15's (``peers_launches``: K3, K4 in (a), K1, K2 in (b)) and
   phase 16's (``gateway_launches``: K1, K2), phase 17's
   (``faults_launches``) and phase 18's (``moe_launches`` by dtype: K1,
   K2, K6; ``moe_shapes``: their times at the MoE's shapes). Printed
   last, after phases 8-18.
8. The checkpoint path at full width: phase 3's qwen2.5-3b weights (the
   same seed) written as an HF checkpoint (config.json, two safetensors
   shards and their index, HF names, [out, in] weights) under ``build/``
   and removed after; ``engine/weights.load_checkpoint`` must give
   ``ModelConfig.from_pretrained`` equal to the preset and every leaf
   bit for bit, and with ``quantize="int8"`` / ``"int4"`` the loader's
   block quantization applied to the whole tensors (load time, GB/s and
   the host's peak RSS growth printed), and a bf16 load that keeps the load
   ledger (``checksum_ledger``, one entry a leaf) timed beside the plain
   one. Phase 3's 16 jobs, 32 new tokens,
   served from the loaded tree through ``EngineCore`` under
   ``LLMQ_DECODE_KERNEL=v2``: K5 launches 36 times per decode step, all
   on the tensor-core route, K1 never; the tokens equal the first 32 of
   phase 3's.
9. tcp:// and the command line at full width: the port's
   ``BrokerServer`` in a process of its own on a free local port, phase
   3's 16 jobs (32 new tokens) published to it, ``python -m
   llmq_tpu_torch worker run preset://qwen2.5-3b`` in another process
   with ``LLMQ_BROKER_URL`` set; once the 16 results are read the worker
   gets SIGTERM and must exit 0; ids, ``usage.completion_tokens``, extras,
   text and token ids (``LLMQ_RESULT_DIGEST=1`` puts them on each result;
   random weights emit mostly ids past the byte tokenizer's 256, whose
   text is empty) must match the first 32 tokens of phase 3's or of its
   solo run's (see phase 3).
10. The fused dispatch modes at full width (qwen2.5-3b, 36 layers, bf16,
   phase 3's seeded weights, 16 jobs a serve through ``EngineCore``):
   phase 3's workload eagerly (``cuda_graphs=False``), tokens bit for bit
   phase 3's captured run's; ``decode_block=4``, tokens equal phase 3's
   and K1 4 x 36 launches a dispatch (plus its captured step times);
   ``spec_tokens=3`` (``spec_ngram=2``), drafts accepted, K3 36 launches
   a verify iteration and K1 none, jobs equal to phase 3's printed (K3's
   bf16 arithmetic is not K1's); ``mixed_step="on"`` with chunks of 256
   on phase 4's workload and settings, mixed steps taken, K3 and K4
   launches counted, jobs equal to phase 4's printed. All on the
   tensor-core routes.
11. The request-state plane at full width (qwen2.5-3b, bf16, phase 3's
   weights and 16 jobs, 128 tokens, through ``EngineCore``): (a) every
   row decodes to >= 40 tokens, ``extract_all``, the snapshot bytes codec
   both ways, ``insert_request`` back into the same engine, decode to
   the end: tokens equal phase 3's, the pools keep their storage and the
   graphs' capture count does not move, K1 and K2 counted as in phase 3;
   printed: snapshot bytes a row, the gather's and the in-place insert's
   ms and GB/s, codec ms; (b) a pool of 137 pages, so the rows must
   preempt, under recompute and under swap preemption: swap's tokens
   equal phase 3's (recompute's count printed: its re-prefill's bf16
   arithmetic is not the decode's), ``swap_preempts`` and
   ``kv_restores`` >= 1, fewer prefill tokens with swap; and in f32 at 2
   layers on the exact routes, recompute, swap and an uninterrupted run
   give the same tokens; (c) ``decode_block`` 4 and
   ``interactive_decode_block`` 1: one request arrives while the 16 rows
   decode, as batch and then as interactive: one priority preemption,
   its tokens equal its solo run's, the small block's graph captured and
   replayed; printed: its time to first token both ways; (d) phase 9's
   broker and a worker process, SIGTERM'd when the first result lands,
   then a second worker process: 16 unique results, texts and token ids
   equal phase 3's or its solo run's, at least one resumed from a
   snapshot (``resume_offset`` > 0), both processes exit 0 (logs ``handoff_worker*.log``).
12. The prefix-KV plane at full width (qwen2.5-3b, bf16, phase 3's
   weights, through ``EngineCore``): (a) phase 4's settings (v3, chunks
   of 256, the prefix cache) with a 1 GiB host prefix tier: phase 4's 16
   jobs in two waves of 8, every cached page flushed to the host tier
   between them, so the second wave promotes the template's 32 pages:
   tokens equal phase 4's, the pools keep their storage and the capture
   count does not move, K3 and K4 counted as in phase 4; printed: pages
   demoted and the ms a page, pages promoted, the promotion's ms and
   GB/s, prefill tokens against the same waves with the tier off; (b)
   the template's 32 pages exported as chunks from (a)'s engine and
   ingested into a second engine, whose serve of jobs 0-7 prefills only
   their tails and gives phase 4's tokens; printed: chunk bytes, export
   and ingest ms; (c) phase 9's broker, a ``worker run --role decode``
   and a ``--role prefill`` process serve phase 3's 16 jobs at 32 tokens:
   16 unique results, every job handed off (offered to the decode worker
   directly, or through ``<q>.decode`` when the offer is not answered in
   time) and adopted, both processes
   exit 0 on SIGTERM (logs ``disagg_*.log``); printed: the handoff
   latency (p50, p95), snapshot and payload bytes a job, the wall time to
   the 16th result. In process, the same path (prefill-only, then each
   snapshot adopted by ``insert_request``) in bf16, K2 and K1 counted:
   each worker row's token ids equal phase 3's, its solo run's, this
   run's or this run's with each job prefilled alone (a prefill worker
   takes a job that arrives by itself in a prefill of its own; worker
   processes under ``LLMQ_RESULT_DIGEST=1``), and each row of this run
   that parts from phase 3's tokens (of the solo adoption, from the solo
   run's) parts at a near-tie (the adopted row computes its last prompt
   position in a decode step);
   then in f32 at 2 layers on the exact routes, adoption gives the
   unified run's tokens, 16 of 16.
13. The failure policy (M6's first part) at full width (qwen2.5-3b,
   bf16, phase 3's weights and engine settings): (a) a ``TorchWorker``
   in this process over ``chaos+tcp://`` to phase 9's ``BrokerServer``
   process (a kill every 29th client operation, a duplicate every 7th
   delivery, ``quarantine_attempts=2``, ``job_timeout_s`` ~1.1 s, at most
   1/2.6 of a 448-token decode at the step measured after a warm-up):
   one slow job of 448 tokens alone, which must land on
   ``<q>.quarantine`` exactly once as ``timeout`` with
   ``x-delivery-count`` 2; a heartbeat read through the port's
   ``BrokerManager.get_worker_health`` with ``jobs_quarantined: 1``;
   then phase 3's 16 jobs at 32 tokens under the kills: 16 unique
   results whose token ids equal phase 3's first 32, nothing on
   ``<q>.failed``, at least one reconnect, K1 and K2 on the tensor-core
   route only, every decode dispatch a replay (log
   ``failure_policy_worker.log``); printed: kills, duplicates,
   reconnects, fenced settles, outbox parks and flushes, the jobs' wall
   time and tok/s beside phase 9's; (b) ``python -m llmq_tpu_torch worker
   run`` as a process over ``file://`` (a directory under ``build/``,
   removed after) with ``LLMQ_MAX_REDELIVERIES=7 LLMQ_JOB_TTL_MINUTES=5``:
   phase 3's 16 jobs and one unparseable body; each queue's TTL and cap
   in its ``meta.json`` as the reference declares them, the body on
   ``<q>.failed`` with the reference's headers, 16 results equal to the
   first 32 tokens of phase 3's or its solo run's, exit 0 on SIGTERM (log
   ``failure_policy_file.log``); printed: the time to the 16th result
   from the process's start, beside phase 9's. K1's and K2's records in
   the kernels line add their launches in (a)
   (``failure_policy_launches``).
14. The client and a two-stage pipeline at full width, every part a
   process of the port's command line: ``broker serve`` on a free local
   port; a pipeline file (JSON, under ``OUT_DIR``) of two ``tpu`` stages
   over ``preset://qwen2.5-3b`` (16 sequences, 512 positions; stage 1's
   prompt ``{text}``, stage 2's a template over ``{result}`` and
   ``{token_digest}``); a ``worker pipeline`` process per stage
   (``LLMQ_RESULT_DIGEST=1``); phase 3's 16 prompts as JSONL rows
   (greedy, 32 tokens) through ``submit -p`` and ``receive -p --limit
   16``; then SIGTERM, and each worker must exit 0. Checked: 16 unique
   ids and their extras; the token digest in each stage-2 prompt is that
   of the first 32 tokens of phase 3's run or of its solo run, and
   ``previous_result`` their text; each stage-2 prompt is the port's
   ``build_next_stage_job`` of that result; stage 2's token ids equal a
   run of the port's engine in this process on those prompts, all
   waiting at once or each prefilled alone, or part from the solo run at
   a near-tie (the witness of phase 11 (b)), and each solo row parts
   from the batch run at a near-tie; each stage worker's ``worker stats`` line shows K1 and K2
   launched on the tensor-core route only and no other kernel (logs
   ``pipeline_*.log``). Printed: the wall time from the start of
   ``submit`` to the 16th result, each stage's completion tok/s over its
   busy span. K1's and K2's records in the kernels line add each stage
   worker's launches (``pipeline_launches``).
15. The peers' plane (M6's second part) at full width (qwen2.5-3b, bf16,
   phase 3's weights), the workers in this process over phase 9's
   ``BrokerServer`` process, their heartbeats driven by hand
   (``_publish_heartbeat``) instead of the 30 s cadence (log
   ``peers_workers.log``): (a) phase 4's settings (v3, chunks of 256, the
   prefix cache) with a 1 GiB host tier and ``prefix_affinity``: worker A
   serves 8 of phase 4's templated jobs (32 tokens) from the shared queue
   and advertises its chains; an affinity submitter publishes the other
   8, which must all land on A's ``<q>.w.<id>`` and be served by A; then
   A leaves the shared queue (its KV server stays) and worker B, a fresh
   engine with empty caches, takes pfx-00's prompt from it: B must fetch
   A's pages before it prefills (``prefix_chunks_fetched`` > 0, as many
   promoted and hit, fewer prefill tokens than the prompt's) and give A's
   tokens for pfx-00, or part at a near-tie (the witness of phase 11
   (b)); K3 and K4 counted, tensor cores only; the fetch runs at the
   worker's default timeout, and beside it an engine of B's settings with
   empty caches times the local prefill of the same prompt; (b) phase 3's
   settings, the worker's default offer timeout: a
   ``decode`` worker, whose heartbeat must say so, then a ``prefill``
   worker serve phase 3's 16 jobs at 32 tokens: every job offered to the
   decode worker and adopted (``handoffs_shipped`` 16,
   ``handoffs_fallback`` 0, ``jobs_adopted`` 16, ``<q>.d.<id>`` and
   ``<q>.decode`` empty at the end), token ids equal to the first 32 of
   phase 3's or its solo run's, or parting at a near-tie; K2 and K1
   counted, tensor cores only. Printed: the handoff latency p50 / p95
   beside PR 10's ``<q>.decode`` road and the same jobs through
   ``<q>.decode`` in this call, the fetch's ms (its export and ingest
   apart) against the local prefill's, the walls. K1-K4's
   records in the kernels line add these launches (``peers_launches``).

16. The OpenAI gateway and the observability plane at full width, every
   part a process of the port's command line over tcp://: ``broker
   serve``; ``worker run CHECKPOINT`` (phase 3's seeded weights written as
   an HF checkpoint beside a tokenizer that gives every id text: ids up to
   256 are the byte tokenizer's, each later id reads "é"'s continuation
   byte, " <id>", "é"'s lead byte, so random weights split a character
   across every streamed flush; bf16, 16 sequences, 512 positions) with
   ``LLMQ_METRICS_PORT`` on a free port and ``LLMQ_TRACE_LOG`` at
   ``chiprun_out/gateway_trace.jsonl``; ``serve QUEUE --port P``. (a)
   Phase 3's 16 prompts, 32 tokens, greedy: 8 blocking and 8 streamed at
   once, then the other way round; each text must be non-empty and the
   first 32 tokens' text of phase 3's run or of its solo run (see phase
   3), each streamed text the same prompt's blocking text (unless the two
   took the two prefill shapes), and the streamed texts must hold at least
   one "é" joined across two tokens; after ``serve`` stops, the same 16
   jobs straight to the worker must give phase 3's or the solo run's
   first 32 token ids (``LLMQ_RESULT_DIGEST=1``); round 2's answers are
   split at the worker's ``claimed`` and ``finished`` sink stamps; (b) a
   streamed request
   of 512 tokens the client leaves after its first frame: the gateway cancels
   it on the worker's control queue, the pages go back to the pool
   (``llmq_engine_kv_page_utilization`` 0), the worker's stats line counts
   one ``jobs_cancelled`` and one ``cancelled`` result, the engine one
   cancellation; (c) ``/metrics`` carries ``llmq_ttft_seconds``,
   ``llmq_itl_seconds``, ``llmq_dispatch_seconds{kind=...}`` and
   ``llmq_broker_publish_seconds`` with counts at least the requests
   served; a chat completion, ``/v1/models`` and ``/healthz`` answer; (d)
   after ``serve`` stops (exit 0), ``trace trace-me -q QUEUE`` of a job
   submitted to the queue prints submitted, claimed, tokenized, admitted,
   prefill_start, first_token, decode, finished in order, and ``monitor
   top QUEUE --once`` shows the worker's row with nonzero tok/s and TTFT
   p50 once a heartbeat carries the serve. The worker exits 0 on SIGTERM;
   its stats line shows K1 and K2 on the tensor-core route only (logs
   ``gateway_*.log``). Printed: the client's TTFT p50 / p95 (request to
   first SSE frame) and the blocking latency p50 of each round (round 1
   meets a cold worker process), round 2's p50 road to the worker's
   claim, worker span and road back, the heartbeat's
   ``ttft_p50_ms`` and ``itl_p50_ms``. ``--phases gateway`` runs phase 3
   and this phase alone.

17. The fault planes (M12) at full width: qwen2.5-3b bf16 with phase 3's
   seeded weights, 16 of phase 3's jobs at 32 tokens through a
   ``TorchWorker`` (``build_engine`` + ``run``, as ``run_torch_worker``
   drives it) over ``memory://``, K2 then K1 on the tensor-core route,
   launches counted in each leg. Each leg's results must be 16 (one a
   job), each the first 32 token ids of phase 3's run or of its solo run,
   or parting from phase 3's at a near-tie (``_parting_witness``), and
   each rebuilt engine must have the first engine's ``num_pages``. (a) A
   ``DeviceFaultInjector`` raises a CUDA error on a decode dispatch: one
   rebuild; printed, its seconds split into extract / free / build /
   capture / re-insert. (b) The watchdog on: a dispatch hook queues
   ``torch.cuda._sleep`` on the engine's stream past the deadline (floor
   1 s after a warm-up), a real device stall inside the drain's
   ``event.synchronize()``; a thread reads ``last_dispatch_ok_age_s``
   past the deadline while the call is in flight, then
   ``HungDispatchError`` costs one rebuild; printed, the trip's latency
   past the deadline. (c) A first out-of-memory error on a decode
   dispatch is absorbed by the ladder (``shrink_runahead``), no rebuild.
   (d) ``logit_guard=on``: the tokens of guard off; the captured decode
   step's host span and device time with the guard and without; a
   transient NaN flip of the logit projection costs one rebuild, a
   sticky one quarantines one job as ``numerical_fault``. (e)
   ``audit_weights`` over the whole tree twice (both clean, timed), a
   finite weight flip named by the next, the canary clean and then
   failing after a NaN flip; one ``kv_spot_check`` mid-serve on the prefix
   path (v3, chunks of 256: K3 + K4). ``--phases build,serve,faults``
   runs phase 3 and this phase alone.

18. Mixture-of-experts serving (M14) at full width: qwen1.5-moe-a2.7b
   (24 layers, hidden 2048, 16 / 16 heads, 60 experts, top 4, a shared
   expert of 5,632, untied head; random weights from a seeded generator).
   (a) K1 and K2 at its attention shapes (a query group of 1, d 128) and
   K6 at its int8 weights' shapes (q/k/v/o 2,048 x 2,048, the shared
   expert's 2,048 x 5,632 and 5,632 x 2,048, the head 2,048 x 151,936; M =
   16) against their plain versions, f32 and bf16. (b) bf16 and (c) int8
   (``LLMQ_INT8_MATMUL=pallas``: K6 on the attention projections, the
   shared expert and the head; the expert stacks are dequantized a layer
   at a time, as in the JAX package): 16 of phase 3's jobs, 64 new tokens,
   through ``run_torch_worker`` over ``memory://``; K1 24 launches a decode
   step, K2 24 a prefill dispatch, K6 (int8) 7 x 24 + 1 a dispatch,
   nothing else, tensor cores only; every decode dispatch a graph replay;
   the same jobs on an eager engine (``cuda_graphs=False``) over the same
   weights give the same tokens or part at a near-tie (the witness of
   phase 11 (b)). Printed: tok/s, the decode step's host span, device time
   and idle share (eager and captured), weight GB, the transient the KV
   sizing reserves and the peak an eager decode step allocates. (d) f32
   parity at the preset's widths and 2 layers, TF32 off: the card's
   prefill and decode logits within 1e-4 of the port's CPU path, 16
   greedy tokens a prompt identical, K1 / K2 on their exact routes. (e)
   An HF-format qwen2_moe checkpoint (one tensor per expert, a tokenizer
   beside it) of seeded bf16 weights at the preset's widths and 2 layers
   under ``build/``, removed after: ``load_checkpoint`` gives the written
   tree bit for bit (load time printed), and a ``worker run CHECKPOINT``
   process over tcp:// serves 4 jobs whose token ids equal an in-process
   engine's over the loaded tree (log ``moe_checkpoint_worker.log``).
   ``--phases build,moe`` runs this phase alone. K1's, K2's and K6's
   records in the kernels line add (b)'s and (c)'s launches
   (``moe_launches``) and (a)'s bf16 times (``moe_shapes``).

The last line is ``{"ok": true, "device": {...}}``, printed only after
every phase ran and passed. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero before printing any
result.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, H100 SXM
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DECODE_F32_MATH_TOLERANCE = 1e-2  # bf16 K1 against the plain version in f32
ALL_PHASES = ("build", "kernels", "serve", "prefix", "quant", "parity", "checkpoint", "tcp",
              "fused", "snapshot", "prefix_kv", "failure_policy", "pipeline", "peers", "gateway",
              "faults", "moe")
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def emit(obj) -> None:
    """One JSON line on stdout, and the same line appended to
    ``chip_smoke.jsonl`` under ``OUT_DIR``: the whole run, for a caller
    that reads only the tail of stdout."""
    line = json.dumps(obj)
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "a") as f:
        f.write(line + "\n")


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


PROFILE_ATTEMPTS = 3  # a trace that records no device activity is taken again
EVENT_TIMED = []  # windows the profiler never traced, timed by CUDA events instead


def device_ms(fn, iters: int, warmup: int = 2, required: bool = True):
    """Device time per call of ``fn(i)``: the summed self device time of
    every kernel, copy and fill that ``iters`` calls put on the card, as
    ``torch.profiler`` traces them. The gaps in which the card waits for
    the host are left out. Now and then a trace comes back without any
    device activity (seen once in a few hundred traces on the H100, and
    once three times in a row); the window is then traced again, up to
    ``PROFILE_ATTEMPTS`` times. After that it returns None where not
    ``required``, else the span between CUDA events (``span_ms``, which
    counts the host's gaps too, so it can only read high), noted in
    ``EVENT_TIMED`` and in each record's ``timing`` (``device_timing``)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / 1e3 / iters
    if not required:
        return None
    EVENT_TIMED.append(getattr(fn, "__qualname__", repr(fn)))
    print(f"torch.profiler traced no device time in {PROFILE_ATTEMPTS} attempts; timed "
          f"between CUDA events instead", file=sys.stderr, flush=True)
    return span_ms(fn, iters, warmup=0)


def device_timing() -> str:
    """The ``timing`` of a record timed by ``device_ms``."""
    if not EVENT_TIMED:
        return "torch.profiler device time per call"
    return (f"torch.profiler device time per call, except {len(EVENT_TIMED)} window(s) so far "
            f"that it traced empty, timed between CUDA events (host gaps included)")


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --- phase 2: kernels against their plain versions --------------------------


def _decode_kernels():
    from llmq_tpu_torch.ops import cuda_attention as ca

    return {"v1": ("paged_decode", ca.paged_decode_attention_cuda),
            "v2": ("paged_decode_v2", ca.paged_decode_attention_v2_cuda),
            "v3": ("paged_decode_v3", ca.paged_decode_attention_v3_cuda)}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def _dense(pool: torch.Tensor, idx: torch.Tensor, dtype) -> torch.Tensor:
    """A layer's pages gathered densely through ``idx``, in ``dtype`` (an
    fp8 pool is gathered as bytes)."""
    raw = pool.view(torch.uint8) if pool.element_size() == 1 else pool
    return raw[idx].view(pool.dtype).to(dtype)


def check_decode(label, *, variant, S, H, n_kv, d, L, page, max_ctx, dtype, softcap, window,
                 iters, seed, kv_dtype=None, outputs=None):
    """K1 (v1), K5 (v2) or K4 (v3, with the fused write of the new rows)
    against the plain version on the same inputs; ``kv_dtype`` is the
    pools' dtype (default: ``dtype``). On an fp8 pool K4's check writes
    one row of values past e5m2's range (50,000-70,000): the pools must
    hold +-57,344 and +-inf where the plain cast puts them. The kernel's
    output goes into ``outputs[variant]`` where that dict is given."""
    from llmq_tpu_torch.ops import attention as plain
    from llmq_tpu_torch.ops.cuda_attention import attention_route

    name, fn = _decode_kernels()[variant]
    fused = variant == "v3"
    routed = name in ROUTED
    kv_dtype = kv_dtype or dtype
    overflow_row = 1 if fused and kv_dtype == torch.float8_e5m2 else None
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    pps = max_ctx // page
    P = 1 + S * pps
    ctx = np.sort(rng.integers(1, max_ctx + 1, size=S))
    ctx[0], ctx[-1] = 0, max_ctx  # an inactive row and a full one
    bt = (1 + rng.permutation(S * pps)).reshape(S, pps).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, H, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((L, P, page, n_kv, d), generator=g, device=dev).to(kv_dtype)
    vp = torch.randn((L, P, page, n_kv, d), generator=g, device=dev).to(kv_dtype)
    k_new = torch.randn((S, n_kv, d), generator=g, device=dev).to(dtype)
    v_new = torch.randn((S, n_kv, d), generator=g, device=dev).to(dtype)
    if overflow_row is not None:
        ramp = torch.linspace(5.0e4, 7.0e4, n_kv * d, device=dev).reshape(n_kv, d)
        sign = 1.0 - 2.0 * (torch.arange(d, device=dev) % 2)
        k_new[overflow_row] = (ramp * sign).to(dtype)
        v_new[overflow_row] = (-ramp * sign).to(dtype)
    bt_t = torch.from_numpy(bt).to(dev)
    ctx_t = torch.from_numpy(ctx.astype(np.int32)).to(dev)
    layer = L // 2
    scale = d ** -0.5
    kw = dict(scale=scale, sliding_window=window, softcap=softcap)
    pools_equal = overflow = None
    before = _route_counts(fn) if routed else None
    if fused:
        kp_p, vp_p = kp.clone(), vp.clone()  # the plain write goes here
        out, _, _ = fn(q, kp, vp, k_new, v_new, bt_t, ctx_t, layer=layer, **kw)
        ref, _, _ = plain.paged_decode_attention_fused_write(
            q, kp_p, vp_p, k_new, v_new, bt_t, ctx_t, layer=layer, **kw)
        torch.cuda.synchronize()
        # Page 0 is scratch: the plain scatter parks inactive rows there.
        pools_equal = _same_bits(kp[:, 1:], kp_p[:, 1:]) and _same_bits(vp[:, 1:], vp_p[:, 1:])
        if overflow_row is not None:
            stored = kp.float()
            overflow = dict(inf=int(torch.isinf(stored).sum()),
                            max_finite=int((stored.abs() == 57344.0).sum()))
        del kp_p, vp_p
    else:
        out = fn(q, kp, vp, bt_t, ctx_t, layer=layer, **kw)
        ref = plain.paged_decode_attention(q, kp, vp, bt_t, ctx_t, layer=layer, **kw)
    torch.cuda.synchronize()
    if outputs is not None:
        outputs[variant] = out.clone()
    route = attention_route(dtype, kv_dtype) if routed else None
    route_ok = _route_counts(fn)[route] == before[route] + 1 if routed else None
    # A ctx == 0 row is inactive: the kernel writes exact zeros, the plain
    # version a finite average (both never read). Compare the live rows.
    live_rows = ctx_t > 0
    if overflow_row is not None:  # its scores meet +-inf: not compared
        live_rows[overflow_row] = False
    err = (out[live_rows].float() - ref[live_rows].float()).abs().max().item()
    zero_row = out[0].float().abs().max().item()
    # The kernel's math is f32 whatever the storage (q, k and v upcast, as
    # in the TPU kernel); the plain version multiplies in bf16. So a bf16
    # run is also held, more tightly, against the plain version in f32 on
    # the same bf16 values (the pools as the kernel left them): what is
    # left is the output's rounding.
    f32_math_err = None
    if dtype != torch.float32:
        ref32 = plain.paged_decode_attention(
            q.float(), kp[layer:layer + 1].float(), vp[layer:layer + 1].float(),
            bt_t, ctx_t, layer=0, **kw)
        f32_math_err = (out[live_rows].float() - ref32[live_rows]).abs().max().item()
    # Times rotate over the layers: each launch reads another layer's
    # pages, so the 50 MB L2 holds none of them, as on the main path.
    if fused:
        def kernel(i):
            return fn(q, kp, vp, k_new, v_new, bt_t, ctx_t, layer=i % L, **kw)

        def plain_fn(i):
            return plain.paged_decode_attention_fused_write(
                q, kp, vp, k_new, v_new, bt_t, ctx_t, layer=i % L, **kw)
    else:
        def kernel(i):
            return fn(q, kp, vp, bt_t, ctx_t, layer=i % L, **kw)

        def plain_fn(i):
            return plain.paged_decode_attention(q, kp, vp, bt_t, ctx_t, layer=i % L, **kw)

    ms, host_ms = device_ms(kernel, iters), span_ms(kernel, iters)
    plain_ms = device_ms(plain_fn, max(3, iters // 10))
    # Library yardstick: SDPA over the same K/V gathered densely (per
    # layer, outside the timed region), a key mask for length and window.
    idx = bt_t.long()
    dense_k = [_dense(kp[i], idx, dtype).reshape(S, pps * page, n_kv, d).transpose(1, 2)
               for i in range(L)]
    dense_v = [_dense(vp[i], idx, dtype).reshape(S, pps * page, n_kv, d).transpose(1, 2)
               for i in range(L)]
    kpos = torch.arange(pps * page, device=dev)[None, :]
    keep = kpos < ctx_t[:, None].long()
    if window is not None:
        keep &= kpos >= ctx_t[:, None].long() - window
    mask = keep[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = device_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q4, dense_k[i % L], dense_v[i % L], attn_mask=mask, scale=scale, enable_gqa=True
    ), iters)
    del dense_k, dense_v
    # What the function must move: the live rows' queries in, every
    # output row out, each live key's K and V row once, the block-table
    # entries of the live pages and the context lengths; K4 also reads
    # the live rows' new K/V rows and writes them into the pool.
    start = np.zeros_like(ctx) if window is None else np.maximum(ctx - window, 0)
    live = ctx - start
    live_pages = np.where(ctx > 0, (ctx - 1) // page - start // page + 1, 0)
    item = torch.empty((), dtype=dtype).element_size()
    kv_item = torch.empty((), dtype=kv_dtype).element_size()
    active = int((ctx > 0).sum())
    nbytes = (
        (active + S) * H * d * item  # q of live rows in, out
        + 2 * int(live.sum()) * n_kv * d * kv_item  # live K and V rows, once each
        + int(live_pages.sum()) * 4 + ctx.nbytes
        + (2 * active * n_kv * d * (item + kv_item) if fused else 0)  # new rows in, stored
    )
    ops = 4 * int(live.sum()) * H * d  # QK and PV multiply-adds
    b_ms, b_by = bound(nbytes, ops, dtype)
    rec = dict(
        phase="kernel_check", kernel=name, case=label, dtype=str(dtype)[6:],
        kv_dtype=str(kv_dtype)[6:], route=route, route_as_expected=route_ok,
        shape=dict(S=S, H=H, n_kv=n_kv, d=d, L=L, page=page, max_ctx=max_ctx,
                   window=window, softcap=softcap, layer=layer),
        max_abs_err=err, tolerance=TOLERANCE[dtype], ctx0_row_max=zero_row,
        max_abs_err_vs_f32_math=f32_math_err,
        tolerance_vs_f32_math=None if f32_math_err is None else DECODE_F32_MATH_TOLERANCE,
        pools_bit_exact_pages_ge_1=pools_equal, overflow_row_values_stored=overflow,
        ms=ms, host_span_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by, timing=device_timing(),
    )
    emit(rec)
    if (not (err <= TOLERANCE[dtype]) or zero_row != 0.0 or pools_equal is False
            or not (f32_math_err is None or f32_math_err <= DECODE_F32_MATH_TOLERANCE)
            or (overflow is not None and not (overflow["inf"] and overflow["max_finite"]))
            or route_ok is False):
        raise SystemExit(f"{name} {label} {dtype}/{kv_dtype}: error {err}, against f32 math "
                         f"{f32_math_err}, ctx=0 row {zero_row}, pools equal {pools_equal}, "
                         f"overflow row {overflow}, {route} route launched {route_ok}")
    return rec


def check_k5_equals_k1(outs: dict, *, kv_dtype) -> None:
    """K5 on the tensor-core route stages a chunk of pages a ring stage
    but keeps K1's split plan and order of arithmetic: its bf16 output on
    the same inputs must equal K1's bit for bit."""
    for label, by_variant in outs.items():
        same = _same_bits(by_variant["v2"], by_variant["v1"])
        emit(dict(phase="kernel_check", kernel="paged_decode_v2", case=label,
                  kv_dtype=str(kv_dtype)[6:], check="bf16 output equals K1's bit for bit",
                  bit_exact=same))
        if not same:
            raise SystemExit(f"paged_decode_v2 {label}: bf16 output differs from K1's")


def check_paged_prefill(label, *, B, C, H, n_kv, d, L, page, starts, valids, dtype, softcap,
                        window, iters, seed, kv_dtype=None):
    """K3 against its plain version: a chunk of C queries per row at the
    given absolute starts, with num_valid valid queries each; the pools
    in ``kv_dtype`` (default: ``dtype``)."""
    from llmq_tpu_torch.ops import attention as plain
    from llmq_tpu_torch.ops.cuda_attention import attention_route, paged_prefill_attention_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    pps = -(-max(s0 + n for s0, n in zip(starts, valids)) // page)
    P = 1 + B * pps
    bt = (1 + rng.permutation(B * pps)).reshape(B, pps).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    kv_dtype = kv_dtype or dtype
    q = torch.randn((B, C, H, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((L, P, page, n_kv, d), generator=g, device=dev).to(kv_dtype)
    vp = torch.randn((L, P, page, n_kv, d), generator=g, device=dev).to(kv_dtype)
    positions = np.full((B, C), -1, np.int32)
    for r, (s0, n) in enumerate(zip(starts, valids)):
        positions[r, :n] = np.arange(s0, s0 + n)
    bt_t, pos_t = (torch.from_numpy(a).to(dev) for a in (bt, positions))
    start_t = torch.tensor(starts, dtype=torch.int32, device=dev)
    nv_t = torch.tensor(valids, dtype=torch.int32, device=dev)
    layer = L // 2
    scale = d ** -0.5
    kw = dict(scale=scale, sliding_window=window, softcap=softcap)
    route = attention_route(dtype, kv_dtype)
    before = _route_counts(paged_prefill_attention_cuda)
    out = paged_prefill_attention_cuda(q, kp, vp, bt_t, start_t, nv_t, layer=layer, **kw)
    ref = plain.paged_prefill_attention(q, kp, vp, bt_t, pos_t, layer=layer, **kw)
    torch.cuda.synchronize()
    route_ok = _route_counts(paged_prefill_attention_cuda)[route] == before[route] + 1
    # Query rows past num_valid are padding (zeros from the kernel, an
    # average from the plain version, never read): compare valid rows.
    err = max((out[b, :n].float() - ref[b, :n].float()).abs().max().item()
              for b, n in enumerate(valids) if n)
    pad_zero = all(bool((out[b, n:] == 0).all()) for b, n in enumerate(valids))

    def kernel(i):
        return paged_prefill_attention_cuda(q, kp, vp, bt_t, start_t, nv_t, layer=i % L, **kw)

    def plain_fn(i):
        return plain.paged_prefill_attention(q, kp, vp, bt_t, pos_t, layer=i % L, **kw)

    ms, host_ms = device_ms(kernel, iters), span_ms(kernel, iters)
    plain_ms = device_ms(plain_fn, max(3, iters // 10))
    # Library yardstick: SDPA over the rows' K/V gathered densely (per
    # layer, outside the timed region), with the causal + window frontier
    # of each query as a boolean mask.
    idx = bt_t.long()
    max_ctx = pps * page
    dense_k = [_dense(kp[i], idx, dtype).reshape(B, max_ctx, n_kv, d).transpose(1, 2)
               for i in range(L)]
    dense_v = [_dense(vp[i], idx, dtype).reshape(B, max_ctx, n_kv, d).transpose(1, 2)
               for i in range(L)]
    qpos = pos_t.long()[:, :, None]
    kpos = torch.arange(max_ctx, device=dev)[None, None, :]
    keep = (kpos <= qpos) & (qpos >= 0)
    if window is not None:
        keep &= kpos > qpos - window
    mask = keep[:, None]
    qt = q.transpose(1, 2)
    lib_ms = device_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, dense_k[i % L], dense_v[i % L], attn_mask=mask, scale=scale, enable_gqa=True
    ), iters)
    del dense_k, dense_v
    # What the function must move: the valid queries in, every output row
    # out, each row's live keys [first query - window + 1, last query] once
    # as K and V rows, their block-table entries, starts and counts.
    item = torch.empty((), dtype=dtype).element_size()
    live_keys = live_pages = pairs = 0
    for s0, n in zip(starts, valids):
        if not n:
            continue
        lo = 0 if window is None else max(0, s0 - window + 1)
        live_keys += s0 + n - lo
        live_pages += (s0 + n - 1) // page - lo // page + 1
        qp = np.arange(s0, s0 + n)[:, None]
        kp_ = np.arange(lo, s0 + n)[None, :]
        m = kp_ <= qp
        if window is not None:
            m &= kp_ > qp - window
        pairs += int(m.sum())
    kv_item = torch.empty((), dtype=kv_dtype).element_size()
    nbytes = ((sum(valids) + B * C) * H * d * item + 2 * live_keys * n_kv * d * kv_item
              + live_pages * 4 + 2 * B * 4)
    ops = 4 * pairs * H * d  # QK and PV multiply-adds over the live pairs
    b_ms, b_by = bound(nbytes, ops, dtype)
    rec = dict(
        phase="kernel_check", kernel="paged_prefill", case=label, dtype=str(dtype)[6:],
        kv_dtype=str(kv_dtype)[6:], route=route, route_as_expected=route_ok,
        shape=dict(B=B, C=C, H=H, n_kv=n_kv, d=d, L=L, page=page, starts=list(starts),
                   valids=list(valids), window=window, softcap=softcap, layer=layer),
        max_abs_err=err, tolerance=TOLERANCE[dtype], padding_rows_zero=pad_zero,
        ms=ms, host_span_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by, timing=device_timing(),
    )
    emit(rec)
    if not (err <= TOLERANCE[dtype]) or not pad_zero or not route_ok:
        raise SystemExit(f"paged_prefill {label} {dtype}/{kv_dtype}: error {err}, "
                         f"padding zero {pad_zero}, {route} route launched {route_ok}")
    return rec


def check_prefill(label, *, B, T, H, n_kv, d, lengths, dtype, softcap, window, iters, seed):
    from llmq_tpu_torch.ops import attention as plain
    from llmq_tpu_torch.ops.cuda_attention import attention_route, flash_prefill_attention_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, H, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, T, n_kv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, T, n_kv, d), generator=g, device=dev).to(dtype)
    len_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    kw = dict(scale=scale, sliding_window=window, softcap=softcap)
    route = attention_route(dtype, dtype)
    before = _route_counts(flash_prefill_attention_cuda)
    out = flash_prefill_attention_cuda(q, k, v, len_t, **kw)
    ref = plain.full_prefill_attention(q, k, v, lengths=len_t, **kw)
    torch.cuda.synchronize()
    route_ok = _route_counts(flash_prefill_attention_cuda)[route] == before[route] + 1
    # Rows past a row's length are padding (zeros, never read): compare valid rows.
    err = max((out[b, :n].float() - ref[b, :n].float()).abs().max().item()
              for b, n in enumerate(lengths) if n)
    finite = bool(torch.isfinite(out.float()).all().item())
    pad_zero = all(bool((out[b, n:] == 0).all()) for b, n in enumerate(lengths))
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
        route=route, route_as_expected=route_ok,
        shape=dict(B=B, T=T, H=H, n_kv=n_kv, d=d, lengths=list(lengths),
                   window=window, softcap=softcap),
        max_abs_err=err, tolerance=TOLERANCE[dtype], finite=finite, padding_rows_zero=pad_zero,
        ms=ms, host_span_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by, timing=device_timing(),
    )
    emit(rec)
    if not (err <= TOLERANCE[dtype]) or not finite or not pad_zero or not route_ok:
        raise SystemExit(f"flash_prefill {label} {dtype}: error {err}, finite {finite}, "
                         f"padding zero {pad_zero}, {route} route launched {route_ok}")
    return rec


# K6 / K7: tolerances against the f64 product (f32 activations) as
# tests/test_pallas_matmul.py holds the TPU kernels, and against the plain
# version in bf16.
QUANT_F64_TOLERANCE = {"int8": (1e-5, 1e-4), "int4": (1e-4, 1e-4)}  # (rtol, atol)
QUANT_BF16_TOLERANCE = 2e-2  # rtol and atol


def check_quant_matmul(label, *, kind, M, K, N, dtype, iters, seed, timed, timed_kernel=False):
    """K6 (``kind="int8"``) or K7 (``"int4"``) against its plain version on
    one weight quantized from seeded normals, scales in the activation
    dtype as the serving path makes them. f32: both held against the f64
    product at the TPU kernel tests' tolerances; bf16: the kernel against
    the plain version. Each check asserts the route its launch took. ``timed``
    adds device times and the bound; ``timed_kernel`` the kernel's time
    alone."""
    from llmq_tpu_torch.models import quant as qm
    from llmq_tpu_torch.ops import matmul as plain
    from llmq_tpu_torch.ops.cuda_matmul import (int4_matmul_cuda, int4_route, int8_matmul_cuda,
                                                int8_route)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    if kind == "int8":
        qt = qm.quantize_array(w.to(dtype), axis=-2, scale_dtype=dtype)
        parts = (qt["q"], qt["scale"])
        fn, plain_fn, route = int8_matmul_cuda, plain.int8_matmul, int8_route(dtype)
    else:
        qt = qm.quantize_array_int4(w.to(dtype), scale_dtype=dtype)
        parts = (qt["q"], qt["scale"], qt["zero"])
        fn, plain_fn, route = int4_matmul_cuda, plain.int4_matmul, int4_route(dtype)
    del w
    before = _route_counts(fn)
    out = fn(x, *parts)
    ref = plain_fn(x, *parts)
    torch.cuda.synchronize()
    route_ok = _route_counts(fn)[route] == before[route] + 1
    err = (out.float() - ref.float()).abs().max().item()
    rec = dict(phase="kernel_check", kernel=f"{kind}_matmul", case=label, dtype=str(dtype)[6:],
               route=route, route_as_expected=route_ok,
               shape=dict(M=M, K=K, N=N), max_abs_err=err)
    if dtype == torch.float32:
        if kind == "int8":
            exact = (x.double() @ qt["q"].double()) * qt["scale"].double()
        else:
            exact = x.double() @ qm.dequantize(qt, torch.float32).double()
        rtol, atol = QUANT_F64_TOLERANCE[kind]
        excess = {name: ((o.double() - exact).abs() - rtol * exact.abs()).max().item()
                  for name, o in (("kernel", out), ("plain", ref))}
        ok = all(e <= atol for e in excess.values())
        rec.update(vs_f64_excess_over_rtol=excess, rtol=rtol, atol=atol)
    else:
        excess = ((out.float() - ref.float()).abs() - QUANT_BF16_TOLERANCE * ref.float().abs())
        excess = excess.max().item()
        ok = excess <= QUANT_BF16_TOLERANCE
        rec.update(excess_over_rtol=excess, rtol=QUANT_BF16_TOLERANCE, atol=QUANT_BF16_TOLERANCE)
    ok = ok and bool(torch.isfinite(out.float()).all()) and route_ok
    if timed_kernel and not timed:
        rec.update(ms=device_ms(lambda i: fn(x, *parts), iters),
                   timing=device_timing())
    if timed:
        w_deq = qm.dequantize(qt, dtype)  # the library yardstick's weight, made once
        rec.update(
            ms=device_ms(lambda i: fn(x, *parts), iters),
            host_span_ms=span_ms(lambda i: fn(x, *parts), iters),
            plain_ms=device_ms(lambda i: plain_fn(x, *parts), 3),
            library_ms=device_ms(lambda i: torch.matmul(x, w_deq), iters),
            library="torch.matmul(x, w dequantized to the activation dtype): cuBLAS",
        )
        del w_deq
        # What the function must move: x in, the packed weight, its scales
        # (and zero-points) in the scale dtype, the output; against 2 M K N
        # operations at the activation dtype's dense peak.
        item = torch.empty((), dtype=dtype).element_size()
        nbytes = (M * K + M * N) * item + sum(t.numel() * t.element_size() for t in parts)
        rec.update(zip(("bound_ms", "bound_by"), bound(nbytes, 2 * M * K * N, dtype)))
        rec["timing"] = device_timing()
    emit(rec)
    if not ok:
        raise SystemExit(f"{kind}_matmul {label} {dtype}: {rec}")
    return rec


# (label, K, N): qwen2.5-3b's projections (q/o 2048 -> 2048, k/v 2048 ->
# 256, gate/up 2048 -> 11008, down 11008 -> 2048) and llama3.1-8b's
# down_proj (14336 -> 4096), a long contraction.
QUANT_SHAPES = (
    ("qwen2.5-3b q/o_proj", 2048, 2048),
    ("qwen2.5-3b k/v_proj", 2048, 256),
    ("qwen2.5-3b gate/up_proj", 2048, 11008),
    ("qwen2.5-3b down_proj", 11008, 2048),
    ("llama3.1-8b down_proj", 14336, 4096),
)
# llama3.1-8b's untied int8 head (4096 -> 128,256), K6 at a decode step.
LLAMA_HEAD = ("llama3.1-8b lm_head", 4096, 128256)
# Projections of one qwen2.5-3b layer per QUANT_SHAPES entry.
QWEN_LAYER_COUNT = {"qwen2.5-3b q/o_proj": 2, "qwen2.5-3b k/v_proj": 2,
                    "qwen2.5-3b gate/up_proj": 2, "qwen2.5-3b down_proj": 1}


def phase_quant_kernels(iters: int) -> dict:
    """K6 and K7 at every shape, M = 16 (decode) and 1,024 (prefill), f32
    and bf16, and K6 at llama3.1-8b's head (M = 16); per-layer sums of the
    bf16 qwen2.5-3b times. Returns the kernels line's records: K6 at
    qwen2.5-3b gate/up_proj, K7 at llama3.1-8b down_proj, each bf16 at M =
    16 and 1,024 and f32 at M = 16 on its exact route, and K6 at the head."""
    main, layer = {}, {}
    for kind in ("int8", "int4"):
        headline = "qwen2.5-3b gate/up_proj" if kind == "int8" else "llama3.1-8b down_proj"
        for M in (16, 1024):
            shapes = QUANT_SHAPES + ((LLAMA_HEAD,) if kind == "int8" and M == 16 else ())
            for i, (label, K, N) in enumerate(shapes):
                for dtype in (torch.float32, torch.bfloat16):
                    rec = check_quant_matmul(
                        label, kind=kind, M=M, K=K, N=N, dtype=dtype, iters=iters, seed=20 + i,
                        timed=dtype == torch.bfloat16,
                        timed_kernel=M == 16 and label == headline)
                    if dtype != torch.bfloat16:
                        if rec.get("ms") is not None:  # the exact route in f32
                            main[f"{kind}_matmul/exact"] = rec
                        continue
                    n = QWEN_LAYER_COUNT.get(label, 0)
                    if n:
                        acc = layer.setdefault((kind, M), dict(ms=0.0, plain_ms=0.0,
                                                               library_ms=0.0, bound_ms=0.0))
                        for key in acc:
                            acc[key] += n * rec[key]
                    if label == LLAMA_HEAD[0]:
                        main["int8_matmul/head"] = rec
                    if label != headline:
                        continue
                    main[f"{kind}_matmul" if M == 16 else f"{kind}_matmul/m1024"] = rec
    for (kind, M), acc in layer.items():
        emit(dict(phase="kernel_layer_sum", kernel=f"{kind}_matmul", model="qwen2.5-3b",
                  M=M, dtype="bfloat16", projections=7, **acc))
    return main


def phase_kernels(iters: int) -> dict:
    """Every kernel in f32 and bf16; the bf16 record at qwen2.5-3b shapes
    is the one the final kernels line reports (K1, K2, K3 and K7: the
    tensor-core route's, with the exact route's f32 record beside it)."""
    main = {}
    qwen = dict(S=16, H=16, n_kv=2, d=128, L=36, page=32, max_ctx=1024, softcap=None,
                window=None, iters=iters)
    gemma = dict(S=16, H=8, n_kv=4, d=256, L=26, page=32, max_ctx=1024, softcap=50.0,
                 window=64, iters=iters)
    chunk = dict(B=4, C=256, page=32, starts=[0, 256, 1040, 512], valids=[256, 256, 200, 0],
                 iters=iters)
    for dtype in (torch.float32, torch.bfloat16):
        outs = {"qwen2.5-3b": {}, "gemma2-2b": {}}
        for variant in ("v1", "v2", "v3"):  # the same inputs for the three
            rec = check_decode("qwen2.5-3b", variant=variant, dtype=dtype, seed=1,
                               outputs=outs["qwen2.5-3b"], **qwen)
            main[f"{rec['kernel']}/{rec['route']}"] = rec
            check_decode("gemma2-2b", variant=variant, dtype=dtype, seed=2,
                         outputs=outs["gemma2-2b"], **gemma)
        if dtype == torch.bfloat16:
            check_k5_equals_k1(outs, kv_dtype=dtype)
        lengths = [224, 200, 151, 37]
        rec = check_prefill("qwen2.5-3b", B=4, T=224, H=16, n_kv=2, d=128, lengths=lengths,
                            dtype=dtype, softcap=None, window=None, iters=iters, seed=3)
        main[f"flash_prefill/{rec['route']}"] = rec
        check_prefill("window+softcap", B=4, T=224, H=16, n_kv=2, d=128, lengths=lengths,
                      dtype=dtype, softcap=50.0, window=64, iters=iters, seed=4)
        rec = check_paged_prefill("qwen2.5-3b", H=16, n_kv=2, d=128, L=36, dtype=dtype,
                                  softcap=None, window=None, seed=8, **chunk)
        main[f"paged_prefill/{rec['route']}"] = rec
        check_paged_prefill("gemma2-2b", H=8, n_kv=4, d=256, L=26, dtype=dtype, softcap=50.0,
                            window=64, seed=9, **chunk)
        # fp8 (float8_e5m2) pools: every pool-reading kernel on the same
        # e5m2 pool as its plain version, at the f32 / bf16 tolerances.
        fp8 = torch.float8_e5m2
        outs = {"qwen2.5-3b fp8 pool": {}}
        for variant in ("v1", "v2", "v3"):
            check_decode("qwen2.5-3b fp8 pool", variant=variant, dtype=dtype, kv_dtype=fp8,
                         seed=5, outputs=outs["qwen2.5-3b fp8 pool"], **qwen)
        if dtype == torch.bfloat16:
            check_k5_equals_k1(outs, kv_dtype=fp8)
        check_paged_prefill("qwen2.5-3b fp8 pool", H=16, n_kv=2, d=128, L=36, dtype=dtype,
                            kv_dtype=fp8, softcap=None, window=None, seed=10, **chunk)
    main["paged_prefill/verify"] = check_verify_shape(iters)
    main.update(phase_quant_kernels(iters))
    return main


def check_verify_shape(iters: int) -> dict:
    """K3 at the speculative verify step's shape (phase 10's spec serve:
    16 rows of Q = spec_tokens + 1 = 4 queries at contexts ~300-360,
    qwen2.5-3b's heads, bf16) against its plain version and SDPA, beside
    K1 on pools of the same shape at the same contexts (one query a row,
    as a non-speculative step), to set K3's time per emitted token
    against K1's."""
    from llmq_tpu_torch.ops.cuda_attention import paged_decode_attention_cuda

    S, Q, H, n_kv, d, L, page = 16, 4, 16, 2, 128, 36, 32
    starts = [300 + 4 * i for i in range(S)]
    rec = check_paged_prefill("qwen2.5-3b verify, Q = 4", B=S, C=Q, H=H, n_kv=n_kv, d=d, L=L,
                              page=page, starts=starts, valids=[Q] * S, dtype=torch.bfloat16,
                              softcap=None, window=None, iters=iters, seed=12)
    dev = torch.device("cuda")
    pps = -(-(starts[-1] + Q) // page)
    g = torch.Generator(device=dev).manual_seed(13)
    kp = torch.randn((L, 1 + S * pps, page, n_kv, d), generator=g, device=dev).bfloat16()
    vp = torch.randn_like(kp)
    q = torch.randn((S, H, d), generator=g, device=dev).bfloat16()
    bt = torch.arange(1, 1 + S * pps, dtype=torch.int32, device=dev).reshape(S, pps)
    ctx = torch.tensor(starts, dtype=torch.int32, device=dev) + 1
    k1_ms = device_ms(lambda i: paged_decode_attention_cuda(q, kp, vp, bt, ctx, scale=d ** -0.5,
                                                            layer=i % L), iters)
    out = dict(rec, k1_same_contexts_ms=k1_ms)
    emit(dict(phase="verify_shape", k3_ms=rec["ms"], k3_library_ms=rec["library_ms"],
              k3_bound_ms=rec["bound_ms"], k1_same_contexts_ms=k1_ms,
              note="per emitted token: k3_ms / (tokens a row emits per verify iteration, "
                   "phase 10) against k1_ms"))
    return out


# --- phases 3 and 4: the serving paths at full width -------------------------

KERNEL_COUNTERS = {  # name in the kernels line -> (wrapper module, wrapper)
    "paged_decode": ("cuda_attention", "paged_decode_attention_cuda"),
    "flash_prefill": ("cuda_attention", "flash_prefill_attention_cuda"),
    "paged_prefill": ("cuda_attention", "paged_prefill_attention_cuda"),
    "paged_decode_v3": ("cuda_attention", "paged_decode_attention_v3_cuda"),
    "paged_decode_v2": ("cuda_attention", "paged_decode_attention_v2_cuda"),
    "int8_matmul": ("cuda_matmul", "int8_matmul_cuda"),
    "int4_matmul": ("cuda_matmul", "int4_matmul_cuda"),
}


def _wrapper(module: str, attr: str):
    import importlib

    return getattr(importlib.import_module(f"llmq_tpu_torch.ops.{module}"), attr)


# kernels with a tensor-core and an exact route
ROUTED = ("paged_decode", "flash_prefill", "paged_prefill", "paged_decode_v3", "paged_decode_v2",
          "int8_matmul", "int4_matmul")


def _route_counts(wrapper) -> dict:
    return {"tensor_core": wrapper.tensor_core_launches, "exact": wrapper.exact_launches}


def reset_launches() -> None:
    for module, attr in KERNEL_COUNTERS.values():
        _wrapper(module, attr).launches = 0
    for name in ROUTED:
        w = _wrapper(*KERNEL_COUNTERS[name])
        w.tensor_core_launches = w.exact_launches = 0


def read_launches() -> dict:
    return {name: _wrapper(*where).launches for name, where in KERNEL_COUNTERS.items()}


def read_routes() -> dict:
    return {name: _route_counts(_wrapper(*KERNEL_COUNTERS[name])) for name in ROUTED}


def route_problems(routes: dict, launches: dict, route: str = "tensor_core") -> list:
    """A bf16 serve must launch K1, K2, K3, K4, K6 and K7 only on their
    tensor-core route; an f32 run (``route="exact"``) only on their exact
    route."""
    other = "exact" if route == "tensor_core" else "tensor_core"
    return [f"{name}: {routes[name][other]} of {launches[name]} launches on the {other} route"
            for name in ROUTED
            if routes[name][other] or routes[name][route] != launches[name]]


def _warm(stats: dict, kind: str = "decode") -> int:
    """Iterations of ``kind`` the engine ran eagerly on inactive rows
    before capturing its graphs (``engine/graphs.py``): real launches,
    counted like any other."""
    return ((stats.get("cuda_graphs") or {}).get("warmup_steps") or {}).get(kind, 0)


def graph_problems(stats: dict) -> list:
    """On the card every decode-type dispatch must be a graph replay."""
    graphs = stats.get("cuda_graphs")
    if graphs is None:
        return ["the engine dispatched decode steps eagerly, not as CUDA graphs"]
    if graphs["replays"] != stats["decode_dispatches"]:
        return [f"{graphs['replays']} graph replays for {stats['decode_dispatches']} decode-type "
                "dispatches"]
    return []


def captured_rates(core, *, S: int, ctx: int) -> dict:
    """Host span, device time and idle share of one decode-type dispatch
    (``decode_block`` iterations) as the engine runs it: a replay of its
    captured graph through its own ``_dispatch_block``, ``S`` rows active
    from context ``ctx`` (their tables over fresh pages, greedy, no limit),
    after the counted run."""
    st, K = core._dev_state, core.cfg.decode_block
    kind = "verify" if core.cfg.spec_tokens else "decode"
    page = core.cfg.page_size
    n_pages = -(-(ctx + 24 * K * (core.cfg.spec_tokens + 1) + 1) // page)  # the timed replays'
    if 1 + S * n_pages > core.k_pages.shape[1] or n_pages > core._pages_per_seq:
        raise SystemExit(f"captured_rates: {S} x {n_pages} pages do not fit the engine's pool")
    values = {
        0: torch.randint(1, 257, (S,)), 1: torch.full((S,), ctx), 3: torch.ones(S, dtype=torch.bool),
        4: torch.zeros((S, 2)), 5: torch.zeros(S), 6: torch.zeros(S), 7: torch.zeros(S),
        8: torch.ones(S), 9: torch.full((S,), 1 << 30), 10: torch.zeros(S),
        11: torch.full(st[11].shape, -1),
    }
    for i, v in values.items():
        st[i].copy_(v.to(st[i].dtype))
    st[2].zero_()
    st[2][:, :n_pages] = torch.arange(1, 1 + S * n_pages, dtype=torch.int32).reshape(S, n_pages)
    core._mode, core._suppress = "greedy", False

    def dispatch(i):
        return core._dispatch_block(kind)

    span = span_ms(dispatch, 10)
    dev = device_ms(dispatch, 5, required=False)
    return dict(captured_step_ms=span, captured_step_device_ms=dev, captured_block=K,
                captured_idle_share=None if dev is None else max(0.0, 1 - dev / span),
                captured_timing="back-to-back replays of the engine's graph: span between "
                                "CUDA events, device time from torch.profiler")


@contextlib.contextmanager
def env(**values):
    """Environment variables while a model is built (the kernel switches
    are read then)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: both weight-only rungs through their kernels (K6, K7)
QUANT_KERNELS_ON = dict(LLMQ_INT8_MATMUL="pallas", LLMQ_INT4_MATMUL="pallas")


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


def _default_jobs(n_jobs: int, gen: int) -> list:
    """Phase 3's workload: ~200-character (ByteTokenizer: ~200-token)
    greedy prompts, ``gen`` new tokens each."""
    from llmq_tpu_torch.core.models import Job

    base = ("Translate the following passage into French, keeping the tone formal and the "
            "terminology exact. The quarterly report shows steady growth in all regions; ")
    return [
        Job(id=f"job-{i:02d}", prompt=(base + f"item {i} of {n_jobs}.")[:200],
            temperature=0.0, max_tokens=gen, ignore_eos=True, row=i, lang="fr")
        for i in range(n_jobs)
    ]


@contextlib.contextmanager
def recording_tokens(tokens: dict):
    """The token ids of each job a ``TorchWorker`` answers, by job id."""
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    build = TorchWorker._build_result

    def record(self, job, out, duration_ms, **kwargs):
        tokens[job.id] = list(out.token_ids)
        return build(self, job, out, duration_ms, **kwargs)

    TorchWorker._build_result = record
    try:
        yield tokens
    finally:
        TorchWorker._build_result = build


def phase_serve(smi: str) -> tuple:
    """Phase 3; returns the launch counts, each job's token ids and each
    job's token ids prefilled alone (``_solo_serve``)."""
    from llmq_tpu_torch.cli.worker import run_torch_worker

    n_jobs, gen, url, queue = 16, 128, "memory://chip-smoke", "smoke"
    asyncio.run(_submit(url, queue, _default_jobs(n_jobs, gen)))
    reset_launches()
    t0 = time.perf_counter()
    with env(LLMQ_DECODE_KERNEL="v1"), recording_tokens({}) as tokens:
        worker = run_torch_worker(
            "preset://qwen2.5-3b", queue, device="cuda", dtype="bfloat16",
            max_num_seqs=16, max_model_len=512, broker_url=url, max_jobs=n_jobs,
        )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_launches(), read_routes()
    results = asyncio.run(_receive(url, queue))
    core = worker.engine.core
    stats = core.stats()
    L = core.model_config.num_layers
    problems = _check_results(results, n_jobs, gen) + route_problems(routes, launches)
    if launches["paged_decode"] <= 0 or launches["flash_prefill"] <= 0:
        problems.append(f"a kernel did not launch on the main path: {launches}")
    problems += graph_problems(stats)
    if launches["paged_decode"] != L * (stats["decode_steps"] + _warm(stats)):
        problems.append(f"decode launches {launches['paged_decode']} != {L} x "
                        f"({stats['decode_steps']} decode steps + {_warm(stats)} warm-ups)")
    if launches["flash_prefill"] != L * stats["prefill_dispatches"]:
        problems.append(f"prefill launches {launches['flash_prefill']} != {L} x "
                        f"{stats['prefill_dispatches']} prefill dispatches")
    off_path = {k: n for k, n in launches.items() if k not in ("paged_decode", "flash_prefill")}
    if any(off_path.values()):
        problems.append(f"kernels off the default path launched: {off_path}")

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
    dec_ms, dec_dev_ms = _decode_rates(core, S=16, ctx=330)
    captured = captured_rates(core, S=16, ctx=330)
    gen_tokens = sum(r["usage"]["completion_tokens"] for r in results)
    prompt_tokens = sum(r["usage"]["prompt_tokens"] for r in results)
    rec = dict(
        **captured, cuda_graphs=stats["cuda_graphs"],
        phase="serve", model="preset://qwen2.5-3b", layers=L, decode_kernel=stats["decode_kernel"],
        jobs=len(results), gen_tokens=gen_tokens, prompt_tokens=prompt_tokens, wall_s=wall,
        serve_completion_tok_s=gen_tokens / wall,
        decode_tok_s=16 / (dec_ms / 1e3), decode_step_ms=dec_ms,
        decode_step_device_ms=dec_dev_ms, decode_idle_share=max(0.0, 1 - dec_dev_ms / dec_ms),
        prefill_tok_s=800 / (pre_ms / 1e3), prefill_4x200_ms=pre_ms,
        prefill_4x200_device_ms=pre_dev_ms,
        launches=launches, routes=routes, decode_steps=stats["decode_steps"],
        prefill_dispatches=stats["prefill_dispatches"], card=smi, problems=problems,
    )
    emit(rec)
    if problems:
        raise SystemExit("serve phase failed: " + "; ".join(problems[:5]))
    worker.engine.core.model = None  # free the 3B weights before the next phase
    return launches, tokens, _solo_serve(smi, _default_jobs(n_jobs, gen), tokens)


def _solo_serve(smi: str, jobs, serve_tokens: dict) -> dict:
    """Phase 3's jobs on a fresh engine of its weights and settings, one
    job waiting at each step, so each is prefilled alone (1 row, where
    phase 3 prefilled 4 a dispatch). Each row that parts from phase 3's
    must part at a near-tie. Returns each job's token ids: the second
    stream a worker process that prefilled the job alone answers with."""
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    cfg = get_preset("qwen2.5-3b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
                         device=torch.device("cuda"))
    core = _snapshot_engine(params, cfg)
    outs: dict = {}
    for j in jobs:
        core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(j.max_tokens))
        outs.update({o.rid: o for o in core.step()})
    solo = {rid: list(o.token_ids) for rid, o in _step_to_end(core, outs).items()}
    problems = []
    dispatches = core.stats()["prefill_dispatches"]
    if dispatches != len(jobs):
        problems.append(f"{dispatches} prefill dispatches for {len(jobs)} jobs prefilled alone")
    parting = _parting_witness(core, jobs, solo, serve_tokens)
    for rid, w in parting.items():
        if (w["recompute_rank"] is None or max(w["phase3_rank"], w["recompute_rank"]) > 2
                or not w["gap_bf16_steps"] <= NEAR_TIE_ULPS):
            problems.append(f"solo {rid} parts from phase 3's at {w['position']} at no near-tie: "
                            f"ranks {w['phase3_rank']} / {w['recompute_rank']}, gap {w['gap']} "
                            f"({w['gap_bf16_steps']} bf16 steps)")
    emit(dict(phase="serve", part="solo prefill", prefill_dispatches=dispatches,
              equal_phase3=len(jobs) - len(parting),
              parting_positions={rid: w["position"] for rid, w in parting.items()},
              max_gap_bf16_steps=max((w["gap_bf16_steps"] for w in parting.values()), default=0),
              near_tie_limit_bf16_steps=NEAR_TIE_ULPS, card=smi, problems=problems))
    if problems:
        raise SystemExit("serve phase (solo prefill) failed: " + "; ".join(problems[:5]))
    del core, params
    gc.collect()
    torch.cuda.empty_cache()
    return solo


def _served_as(ids, rid: str, gen: int, serve_tokens: dict, solo_tokens: dict):
    """Which prefill shape a worker process's token ids for ``rid`` came
    from: ``"batch"`` (phase 3's first ``gen``), ``"solo"`` (the solo
    run's), or None for neither."""
    for shape, ref in (("batch", serve_tokens), ("solo", solo_tokens)):
        if rid in ref and ids == ref[rid][:gen]:
            return shape
    return None


def phase_quant(smi: str) -> dict:
    """Phase 3's workload served with quantized weights at full width,
    both weight-only rungs through their kernels: qwen2.5-3b int8 (K6 on
    the 7 projections of every layer; the tied head is a plain product),
    and llama3.1-8b int4 with an fp8 KV pool (K7 on the projections, K6
    on the untied int8 head, K2 and K1 over the e5m2 pool)."""
    from llmq_tpu_torch.cli.worker import run_torch_worker

    n_jobs, gen = 16, 128
    launches = {}
    for model, dtype, kv_dtype in (("qwen2.5-3b", "int8", None),
                                   ("llama3.1-8b", "int4", "fp8")):
        url, queue = f"memory://chip-smoke-{dtype}", f"quant-{dtype}"
        asyncio.run(_submit(url, queue, _default_jobs(n_jobs, gen)))
        reset_launches()
        t0 = time.perf_counter()
        with env(LLMQ_DECODE_KERNEL="v1", **QUANT_KERNELS_ON):
            worker = run_torch_worker(
                f"preset://{model}", queue, device="cuda", dtype=dtype, kv_dtype=kv_dtype,
                max_num_seqs=16, max_model_len=512, broker_url=url, max_jobs=n_jobs,
            )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted, routes = read_launches(), read_routes()
        results = asyncio.run(_receive(url, queue))
        core = worker.engine.core
        stats = core.stats()
        L = core.model_config.num_layers
        steps = stats["decode_steps"] + _warm(stats)
        dispatches = steps + stats["prefill_dispatches"]
        rung = f"{dtype}_matmul"
        want = {rung: 7 * L * dispatches, "paged_decode": L * steps,
                "flash_prefill": L * stats["prefill_dispatches"]}
        if not core.model_config.tie_word_embeddings:  # the int8 head through K6
            want["int8_matmul"] = want.get("int8_matmul", 0) + dispatches
        problems = (_check_results(results, n_jobs, gen) + route_problems(routes, counted)
                    + graph_problems(stats))
        for name in ("int8_matmul", rung, "paged_decode", "flash_prefill"):
            if counted[name] <= 0:
                problems.append(f"{name} did not launch on the {dtype} path: {counted}")
        for name, n in counted.items():
            if n != want.get(name, 0):
                problems.append(f"{name} launched {n} times, want {want.get(name, 0)}")
        want_kv = "float8_e5m2" if kv_dtype == "fp8" else "bfloat16"
        if stats["kv_dtype"] != want_kv:
            problems.append(f"kv_dtype {stats['kv_dtype']}, want {want_kv}")
        dec_ms, dec_dev_ms = _decode_rates(core, S=16, ctx=330)
        captured = captured_rates(core, S=16, ctx=330)
        head = {}
        if core.model_config.tie_word_embeddings:
            head = _tied_head_cost(core)
        gen_tokens = sum(r["usage"]["completion_tokens"] for r in results)
        rec = dict(
            **captured, cuda_graphs=stats["cuda_graphs"],
            phase="quant_serve", model=f"preset://{model}", layers=L, dtype=dtype,
            kv_dtype=stats["kv_dtype"], quant_kernels=sorted(core.model.quant_kernels),
            jobs=len(results), gen_tokens=gen_tokens, wall_s=wall,
            serve_completion_tok_s=gen_tokens / wall,
            decode_tok_s=16 / (dec_ms / 1e3), decode_step_ms=dec_ms,
            decode_step_device_ms=dec_dev_ms,
            decode_idle_share=max(0.0, 1 - dec_dev_ms / dec_ms),
            launches=counted, routes=routes, expected_launches=want,
            decode_steps=stats["decode_steps"],
            prefill_dispatches=stats["prefill_dispatches"], card=smi, problems=problems, **head,
        )
        emit(rec)
        if problems:
            raise SystemExit(f"{dtype} serve phase failed: " + "; ".join(problems[:5]))
        for name in {"int8_matmul", rung}:
            launches[name] = launches.get(name, 0) + counted[name]
        worker.engine.core.model = None
        del worker, core
        torch.cuda.empty_cache()
    return launches


def _tied_head_cost(core) -> dict:
    """Device ms of the tied int8 head at a decode step of 16 rows: the
    plain product converts the whole [vocab, hidden] table to bf16 on
    every call (``quant.tied_head_matmul``, as the JAX package computes it
    outside any kernel), beside the same product on a bf16 table made
    once."""
    from llmq_tpu_torch.models import quant as qm

    embed = core.model.top_params()["embed"]
    h = torch.randn((16, embed["q"].shape[1]), device=core.device, dtype=torch.bfloat16)
    table = qm.dequantize({"q": embed["q"].t(), "scale": embed["scale"]}, torch.bfloat16).t()
    rec = dict(tied_head_ms=device_ms(lambda i: qm.tied_head_matmul(h, embed), 10),
               tied_head_on_bf16_table_ms=device_ms(lambda i: h @ table.t(), 10),
               tied_head_table=list(embed["q"].shape))
    del table
    return rec


def _check_results(results, n_jobs: int, gen: int) -> list:
    ids = [r["id"] for r in results]
    problems = []
    if len(results) != n_jobs or len(set(ids)) != n_jobs:
        problems.append(f"{len(results)} results, {len(set(ids))} unique ids")
    for r in results:
        if r["usage"]["completion_tokens"] != gen:
            problems.append(f"{r['id']}: {r['usage']}")
        if r.get("row") is None or r.get("lang") != "fr":
            problems.append(f"{r['id']}: extras not passed through")
    return problems


def _decode_rates(core, *, S: int, ctx: int, iters: int = 0) -> tuple:
    """Span and device time (ms) of one decode step of ``S`` rows at
    context ``ctx``, through the engine's model and pool; with ``iters``,
    only that many steps, untimed."""
    dev = core.device
    n_pages = ctx // core.cfg.page_size + 2
    bt = torch.arange(1, 1 + S * n_pages, device=dev, dtype=torch.int32).reshape(S, n_pages)
    bt = torch.nn.functional.pad(bt, (0, core._pages_per_seq - n_pages))
    tok = torch.randint(1, 257, (S,), device=dev, dtype=torch.int32)
    ctx_t = torch.full((S,), ctx, device=dev, dtype=torch.int32)
    active = torch.ones((S,), device=dev, dtype=torch.bool)

    def decode(i):
        return core.model.decode(tok, ctx_t, core.k_pages, core.v_pages, bt, active)

    if iters:
        for i in range(iters):
            decode(i)
        return None
    return span_ms(decode, 10), device_ms(decode, 5)


PREFIX_TEMPLATE = (
    "You are a careful assistant for a customer-support team. Read the ticket below, "
    "decide which of the listed teams owns it, and answer with the team's name only. "
    "Teams: billing (invoices, refunds, payment failures), accounts (sign-in, "
    "passwords, profile changes), shipping (delivery dates, lost parcels, returns), "
    "product (defects, missing parts, manuals), and security (phishing, suspicious "
    "logins, data requests). "
)


def _prefix_jobs(n_jobs: int, gen: int) -> list:
    """Phase 4's workload: a ~1,024-token template with distinct tails."""
    from llmq_tpu_torch.core.models import Job

    template = (PREFIX_TEMPLATE * 3)[:1024]  # ByteTokenizer: 1,024 tokens = 32 pages of 32
    return [
        Job(id=f"pfx-{i:02d}", prompt=template + f" Ticket {i}: my parcel {1000 + 37 * i} "
            "arrived damaged and the box was open; I would like a replacement soon.",
            temperature=0.0, max_tokens=gen, ignore_eos=True, row=i, lang="fr")
        for i in range(n_jobs)
    ]


def phase_prefix(smi: str) -> tuple:
    """The chunked-prefill + prefix-cache path with the fused-write decode
    kernel, at full width; returns the launch counts and each job's token
    ids."""
    from llmq_tpu_torch.cli.worker import run_torch_worker

    n_jobs, gen, chunk, url, queue = 16, 64, 256, "memory://chip-smoke-prefix", "prefix"
    jobs = _prefix_jobs(n_jobs, gen)
    asyncio.run(_submit(url, queue, jobs))
    reset_launches()
    t0 = time.perf_counter()
    with env(LLMQ_DECODE_KERNEL="v3"), recording_tokens({}) as tokens:
        worker = run_torch_worker(
            "preset://qwen2.5-3b", queue, device="cuda", dtype="bfloat16",
            max_num_seqs=16, max_model_len=2048, prefill_chunk_size=chunk,
            enable_prefix_caching=True, broker_url=url, max_jobs=n_jobs,
        )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_launches(), read_routes()
    results = asyncio.run(_receive(url, queue))
    core = worker.engine.core
    stats = core.stats()
    L = core.model_config.num_layers
    problems = _check_results(results, n_jobs, gen) + route_problems(routes, launches)
    if stats.get("prefix_cache_hit_pages", 0) <= 0:
        problems.append(f"no prefix-cache hit: {stats.get('prefix_cache_hit_pages')}")
    if stats["decode_kernel"] != "v3":
        problems.append(f"decode kernel {stats['decode_kernel']}, not v3")
    if launches["paged_prefill"] <= 0 or launches["paged_decode_v3"] <= 0:
        problems.append(f"a kernel did not launch on the prefix-cache path: {launches}")
    if launches["paged_prefill"] != L * stats["prefill_dispatches"]:
        problems.append(f"chunk launches {launches['paged_prefill']} != {L} x "
                        f"{stats['prefill_dispatches']} chunk dispatches")
    problems += graph_problems(stats)
    if launches["paged_decode_v3"] != L * (stats["decode_steps"] + _warm(stats)):
        problems.append(f"fused-write decode launches {launches['paged_decode_v3']} != {L} x "
                        f"({stats['decode_steps']} decode steps + {_warm(stats)} warm-ups)")
    off_path = {k: launches[k] for k in ("paged_decode", "flash_prefill", "paged_decode_v2")}
    if any(off_path.values()):
        problems.append(f"kernels off the prefix-cache path launched: {off_path}")

    # Step rates after the counted run: one chunk dispatch of 4 rows x 256
    # positions at context 1,024 (a template's worth of prefix behind it),
    # one decode step of 16 rows at context 1,100.
    model, dev = core.model, core.device
    B, n_pages = 4, (1024 + chunk) // core.cfg.page_size
    bt = torch.arange(1, 1 + B * n_pages, device=dev, dtype=torch.int32).reshape(B, n_pages)
    bt = torch.nn.functional.pad(bt, (0, core._pages_per_seq - n_pages))
    tok = torch.randint(1, 257, (B, chunk), device=dev, dtype=torch.int32)
    pos = torch.arange(1024, 1024 + chunk, device=dev, dtype=torch.int32).expand(B, chunk)
    last = torch.full((B,), chunk - 1, device=dev, dtype=torch.int32)

    def chunk_step(i):
        return model.prefill_chunk(tok, pos.contiguous(), core.k_pages, core.v_pages, bt, last)

    chunk_ms, chunk_dev_ms = span_ms(chunk_step, 5), device_ms(chunk_step, 3)
    dec_ms, dec_dev_ms = _decode_rates(core, S=16, ctx=1100)
    captured = captured_rates(core, S=16, ctx=1100)
    gen_tokens = sum(r["usage"]["completion_tokens"] for r in results)
    prompt_tokens = sum(r["usage"]["prompt_tokens"] for r in results)
    rec = dict(
        **captured, cuda_graphs=stats["cuda_graphs"],
        phase="prefix_serve", model="preset://qwen2.5-3b", layers=L,
        decode_kernel=stats["decode_kernel"], prefill_chunk_size=chunk,
        jobs=len(results), gen_tokens=gen_tokens, prompt_tokens=prompt_tokens,
        prefill_tokens=stats["prefill_tokens"],
        prefix_cache_hit_pages=stats["prefix_cache_hit_pages"],
        prefix_cache_miss_pages=stats["prefix_cache_miss_pages"],
        prefix_hit_rate=stats["prefix_hit_rate"], wall_s=wall,
        serve_completion_tok_s=gen_tokens / wall,
        decode_tok_s=16 / (dec_ms / 1e3), decode_step_ms=dec_ms,
        decode_step_device_ms=dec_dev_ms, decode_idle_share=max(0.0, 1 - dec_dev_ms / dec_ms),
        chunk_tok_s=B * chunk / (chunk_ms / 1e3), chunk_4x256_ms=chunk_ms,
        chunk_4x256_device_ms=chunk_dev_ms,
        chunk_idle_share=max(0.0, 1 - chunk_dev_ms / chunk_ms),
        launches=launches, routes=routes, decode_steps=stats["decode_steps"],
        chunk_dispatches=stats["prefill_dispatches"], card=smi, problems=problems,
    )
    emit(rec)
    if problems:
        raise SystemExit("prefix-cache serve phase failed: " + "; ".join(problems[:5]))
    worker.engine.core.model = None
    return launches, tokens


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


def _parity_config():
    from llmq_tpu_torch.models.presets import get_preset

    cfg = dataclasses.replace(get_preset("qwen2.5-3b"), num_layers=2)
    return cfg, _numpy_params(cfg, seed=7)


def _engine(cfg, tree, dev, **ecfg):
    """An engine on ``dev`` over a numpy tree, or a torch tree (on the
    CPU: the engine moves it), such as a quantized one."""
    from llmq_tpu_torch.engine.engine import EngineConfig, EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models.convert import params_from_numpy

    params = tree if isinstance(tree["final_norm"], torch.Tensor) else params_from_numpy(tree)
    return EngineCore(cfg, params, ByteTokenizer(), engine_config=EngineConfig(**ecfg),
                      device=dev)


def _generate(core, prompts, n_tokens: int, temperature: float = 0.0, seed=None) -> dict:
    from llmq_tpu_torch.engine.sampling import SamplingParams

    params = SamplingParams(temperature=temperature, seed=seed, max_tokens=n_tokens,
                            ignore_eos=True)
    for i, p in enumerate(prompts):
        core.add_request(f"r{i}", prompt=p, params=params)
    done = {}
    while core.has_work:
        for o in core.step():
            done[o.rid] = o.token_ids
    return done


def phase_parity(variant: str = "f32") -> dict:
    """The default path (bucketed prefill, K2 + K1), card against CPU, in
    f32: ``f32`` weights and pool; ``int8`` / ``int4``, the weights
    quantized with f32 scales by ``models/quant.py`` and both rungs
    through their kernels (K6, K7; their plain versions on the CPU);
    ``fp8``, an e5m2 KV pool.

    An e5m2 value has two mantissa bits, so a K or V element that the two
    devices compute one f32 ulp apart rounds to two neighbouring e5m2
    values (25 % apart) when it lies that close to a rounding midpoint;
    the prefill's ~73,000 values at the prompts' positions make such a
    split likely in some runs, and one split moved decode logits 1.2e-3. So under fp8 the CPU
    decode step reads the card's prefill pools (the same e5m2 bits, as
    the JAX package's fp8 tests compare over the same pool), the count of
    prefill pool elements stored apart is reported, and the generated
    tokens still come from each device's own pools."""
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models import quant as qm
    from llmq_tpu_torch.models.convert import params_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tree = _parity_config()
    if variant in ("int8", "int4"):
        tree = qm.quantize_params(params_from_numpy(tree), bits=int(variant[3]))
    prompts = [
        "The capital of France is",
        "def fibonacci(n):\n    if n < 2:",
        "Once upon a time, in a kingdom by the sea, there lived",
        "Q: What is 12 times 12?\nA:",
    ]
    ecfg = dict(max_num_seqs=4, max_model_len=256, page_size=32, num_pages=64,
                kv_dtype="fp8" if variant == "fp8" else "f32", min_prefill_bucket=32)
    outs, logits, card_pools = {}, {}, None
    pool_split = None
    for dev in ("cuda", "cpu"):
        reset_launches()
        with env(LLMQ_DECODE_KERNEL="v1", **QUANT_KERNELS_ON):
            core = _engine(cfg, tree, dev, **ecfg)
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
        if variant == "fp8" and dev == "cuda":
            card_pools = [p.view(torch.uint8).cpu() for p in (core.k_pages, core.v_pages)]
        elif variant == "fp8":
            # Count the prompts' own positions only: the bucket's padding
            # rows hold values no one reads (K2 leaves zeros there, the
            # plain version an average, so their layer-2 K/V differ).
            pos = torch.arange(T)
            live = pos[None, :] < lengths[:, None]
            page, slot = bt[:, pos // 32][live], (pos % 32).expand(4, T)[live]
            pool_split = sum(int((p.view(torch.uint8)[:, page, slot] != c[:, page, slot]).sum())
                             for p, c in zip((core.k_pages, core.v_pages), card_pools))
            for p, c in zip((core.k_pages, core.v_pages), card_pools):
                p.view(torch.uint8).copy_(c)
        nxt = pre.argmax(-1).to(torch.int32)
        dec = core.model.decode(nxt, args[1], core.k_pages, core.v_pages, args[2],
                                torch.ones(4, dtype=torch.bool, device=core.device))
        logits[dev] = (pre.cpu(), dec.cpu())
        core.k_pages.view(torch.uint8).zero_()
        core.v_pages.view(torch.uint8).zero_()
        outs[dev] = _generate(core, prompts, 32)
        if dev == "cuda":
            counted, routes = read_launches(), read_routes()
        del core
    err_pre = (logits["cuda"][0] - logits["cpu"][0]).abs().max().item()
    err_dec = (logits["cuda"][1] - logits["cpu"][1]).abs().max().item()
    same = outs["cuda"] == outs["cpu"] and all(len(v) == 32 for v in outs["cuda"].values())
    rung = f"{variant}_matmul"
    route_errs = route_problems(routes, counted, route="exact")
    launch_ok = counted["paged_decode"] > 0 and counted.get(rung, 1) > 0 and not route_errs
    rec = dict(
        phase="parity_f32", config="qwen2.5-3b widths, 2 layers", path="bucketed prefill, v1",
        variant=variant, kv_dtype=ecfg["kv_dtype"], card_launches=counted, routes=routes,
        route_problems=route_errs,
        prefill_pool_elements_stored_apart=pool_split,
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        prefill_logits_max_abs_err=err_pre, decode_logits_max_abs_err=err_dec,
        tolerance=1e-4, greedy_tokens_identical=same,
        tokens_compared=sum(len(v) for v in outs["cuda"].values()),
    )
    emit(rec)
    if not (err_pre <= 1e-4 and err_dec <= 1e-4 and same and launch_ok):
        raise SystemExit(f"f32 parity failed ({variant})")
    return rec


CHUNK_PARITY_HEAD = ("System: answer in one short sentence and cite the page number. "
                     "Question follows. ")  # 82 byte tokens: 2 full pages of 32


def _chunk_logits(core, ids, C: int) -> tuple:
    """Logits of two chunks (positions 0..C-1, then C..len-1, a row's last
    position the one read) and of one decode step after them."""
    B = len(ids)
    dev = core.device
    n_pages = core._pages_per_seq
    bt = torch.arange(1, 1 + B * n_pages, dtype=torch.int32).reshape(B, n_pages).to(dev)
    outs = []
    for lo in (0, C):
        tokens = torch.zeros((B, C), dtype=torch.int32)
        pos = torch.full((B, C), -1, dtype=torch.int32)
        last = torch.zeros((B,), dtype=torch.int32)
        for r, row in enumerate(ids):
            seg = row[lo:lo + C]
            tokens[r, : len(seg)] = torch.tensor(seg)
            pos[r, : len(seg)] = torch.arange(lo, lo + len(seg))
            last[r] = max(len(seg) - 1, 0)
        outs.append(core.model.prefill_chunk(tokens.to(dev), pos.to(dev), core.k_pages,
                                             core.v_pages, bt, last.to(dev)))
    lengths = torch.tensor([len(r) for r in ids], dtype=torch.int32, device=dev)
    nxt = outs[-1].argmax(-1).to(torch.int32)
    dec = core.model.decode(nxt, lengths, core.k_pages, core.v_pages, bt,
                            torch.ones(B, dtype=torch.bool, device=dev))
    return outs[-1].cpu(), dec.cpu()


def phase_chunk_parity() -> dict:
    """The chunked + prefix-cache path, card under v1 / v2 / v3 against
    the CPU: chunk and decode logits, tokens (greedy, and one seeded
    request at temperature 0.8 through the threefry sampler), cache
    counters. The v2 run is the path K5 carries; its launches are
    counted there."""
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tree = _parity_config()
    C = 64
    tails = ["Which page mentions the harbour?", "Who wrote the foreword, and when?",
             "How many chapters are there?", "Is there an index at the end?"]
    prompts = [CHUNK_PARITY_HEAD + t for t in tails]
    ids = [ByteTokenizer().encode(p) for p in prompts]
    ecfg = dict(max_num_seqs=4, max_model_len=256, page_size=32, num_pages=64,
                kv_dtype="f32", prefill_chunk_size=C, enable_prefix_caching=True)

    def run(dev):
        core = _engine(cfg, tree, dev, **ecfg)
        logit_pair = _chunk_logits(core, ids, C)
        core.k_pages.zero_()
        core.v_pages.zero_()
        # Two waves, so the second one hits the first one's prefix pages.
        tokens = _generate(core, prompts[:2], 24)
        tokens.update({f"w2-{k}": v for k, v in _generate(core, prompts[2:], 24).items()})
        tokens.update({f"seeded-{k}": v for k, v in _generate(
            core, prompts[:1], 24, temperature=0.8, seed=7).items()})
        stats = core.stats()
        del core
        return logit_pair, tokens, stats

    with env(LLMQ_DECODE_KERNEL="v1"):
        ref_logits, ref_tokens, ref_stats = run("cpu")
    recs, launches = [], {}
    for kernel in ("v1", "v2", "v3"):
        reset_launches()
        with env(LLMQ_DECODE_KERNEL=kernel):
            (chunk_l, dec_l), tokens, stats = run("cuda")
        torch.cuda.synchronize()
        counted, routes = read_launches(), read_routes()
        err_chunk = (chunk_l - ref_logits[0]).abs().max().item()
        err_dec = (dec_l - ref_logits[1]).abs().max().item()
        same = tokens == ref_tokens and all(len(v) == 24 for v in tokens.values())
        counters = {k: stats[k] for k in ("prefix_cache_hit_pages", "prefix_cache_miss_pages")}
        counters_equal = counters == {k: ref_stats[k] for k in counters}
        decode_name = {"v1": "paged_decode", "v2": "paged_decode_v2",
                       "v3": "paged_decode_v3"}[kernel]
        # Two chunk dispatches and one decode step of the logits check, plus
        # the engine's own.
        want_decode = 2 * (stats["decode_steps"] + _warm(stats) + 1)
        want_chunk = 2 * (stats["prefill_dispatches"] + 2)
        launch_ok = (counted[decode_name] == want_decode and counted["paged_prefill"] == want_chunk
                     and sum(counted.values()) == want_decode + want_chunk
                     and not route_problems(routes, counted, route="exact"))
        rec = dict(
            phase="parity_f32", config="qwen2.5-3b widths, 2 layers",
            path=f"chunked prefill {C} + prefix cache, {kernel}",
            decode_kernel=stats["decode_kernel"],
            chunk_logits_max_abs_err=err_chunk, decode_logits_max_abs_err=err_dec,
            tolerance=1e-4, tokens_identical=same, seeded_requests=1,
            tokens_compared=sum(len(v) for v in tokens.values()),
            prefix_counters=counters, prefix_counters_equal=counters_equal,
            launches=counted, routes=routes, launches_as_expected=launch_ok,
        )
        emit(rec)
        recs.append(rec)
        if not (err_chunk <= 1e-4 and err_dec <= 1e-4 and same and counters_equal and launch_ok
                and counters["prefix_cache_hit_pages"] > 0 and stats["decode_kernel"] == kernel):
            raise SystemExit(f"chunked f32 parity failed under {kernel}")
        if kernel == "v2":
            launches["paged_decode_v2"] = counted["paged_decode_v2"]
    return launches

FUSED_MODES = {  # phase 6's and phase 10's fused dispatch modes
    "decode_block": dict(decode_block=4),
    "spec_tokens": dict(spec_tokens=2),
    "mixed_step": dict(mixed_step="on", prefill_chunk_size=64),
}


def phase_fused_parity() -> dict:
    """Phase 6's f32 parity for the fused dispatch modes (decode_block 4,
    spec_tokens 2, mixed_step on), card (exact routes) against the CPU at
    qwen2.5-3b's widths, 2 layers: verify logits (Q = 3 candidates a row)
    and mixed-step logits (three decode rows and a piggy segment) within
    1e-4; in each mode greedy tokens identical to the CPU's and to the
    mode's "off" run, and one seeded request at temperature 0.8 identical
    to the CPU's. Returns K3's launches on the card."""
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.ops.attention import mixed_query_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tree = _parity_config()
    C = 64
    prompts = [CHUNK_PARITY_HEAD + t for t in ("Name the harbour.", "Who wrote it?",
                                                "How long is it?", "abcabcabcabcabc")]
    ids = [ByteTokenizer().encode(p) for p in prompts]
    base = dict(max_num_seqs=4, max_model_len=256, page_size=32, num_pages=64, kv_dtype="f32")
    gen = 16

    def logits_on(dev):
        core = _engine(cfg, tree, dev, **base, prefill_chunk_size=C)
        _chunk_logits(core, ids, C)  # fills each row's pages, then one decode step
        d = core.device
        bt = torch.arange(1, 1 + 4 * core._pages_per_seq, dtype=torch.int32,
                          device=d).reshape(4, -1)
        lengths = torch.tensor([len(r) for r in ids], dtype=torch.int32, device=d)
        g = torch.Generator().manual_seed(3)
        qtok = torch.randint(1, 250, (4, 3), generator=g, dtype=torch.int32).to(d)
        qpos = lengths[:, None] + 1 + torch.arange(3, dtype=torch.int32, device=d)[None, :]
        verify = core.model.verify(qtok, qpos, core.k_pages, core.v_pages, bt)
        active = torch.tensor([True, True, True, False], device=d)
        seg_tok = torch.randint(1, 250, (C,), generator=g, dtype=torch.int32).to(d)
        seg_pos = torch.full((C,), -1, dtype=torch.int32, device=d)
        seg_pos[:20] = lengths[3] + 4 + torch.arange(20, dtype=torch.int32, device=d)
        qt, qp, is_chunk = mixed_query_grid(qtok[:, 0], lengths + 4, active, seg_tok, seg_pos,
                                            torch.tensor(3, device=d), core._pages_per_seq * 32)
        gather = torch.where(is_chunk, 19, 0)
        mixed = core.model.mixed(qt, qp, core.k_pages, core.v_pages, bt, gather)
        del core
        return verify.cpu(), mixed.cpu()

    def tokens_on(dev, fields):
        core = _engine(cfg, tree, dev, **base, **fields)
        out = _generate(core, prompts, gen)
        out.update({f"seeded-{k}": v for k, v in _generate(
            core, prompts[3:], gen, temperature=0.8, seed=7).items()})
        stats = core.stats()
        del core
        return out, stats

    cpu_l = logits_on("cpu")
    reset_launches()
    card_l = logits_on("cuda")
    err = [(a - b).abs().max().item() for a, b in zip(card_l, cpu_l)]
    problems = [f"{what} logits differ by {e}" for what, e in zip(("verify", "mixed"), err)
                if not e <= 1e-4]
    off = {"bucketed": tokens_on("cpu", {})[0],
           "chunked": tokens_on("cpu", dict(prefill_chunk_size=C))[0]}
    modes = {}
    for name, fields in FUSED_MODES.items():
        cpu_tokens, cpu_stats = tokens_on("cpu", fields)
        card_tokens, card_stats = tokens_on("cuda", fields)
        ref = off["chunked" if "prefill_chunk_size" in fields else "bucketed"]
        greedy_off = all(card_tokens[k] == ref[k] for k in ref if not k.startswith("seeded"))
        modes[name] = dict(tokens_equal_cpu=card_tokens == cpu_tokens,
                           greedy_equal_off=greedy_off,
                           spec_accepted=card_stats["spec_accepted"],
                           mixed_steps=card_stats["mixed_steps"])
        if card_tokens != cpu_tokens or not greedy_off:
            problems.append(f"{name}: tokens differ (cpu {card_tokens == cpu_tokens}, "
                            f"off {greedy_off})")
        if name == "mixed_step" and card_stats["mixed_steps"] <= 0:
            problems.append("no mixed step on the card")
    torch.cuda.synchronize()
    counted, routes = read_launches(), read_routes()
    problems += route_problems(routes, counted, route="exact")
    if counted["paged_prefill"] <= 0:
        problems.append(f"K3 did not launch: {counted}")
    rec = dict(phase="parity_f32", config="qwen2.5-3b widths, 2 layers",
               path="fused dispatch modes: decode_block 4, spec_tokens 2, mixed_step on",
               verify_logits_max_abs_err=err[0], mixed_logits_max_abs_err=err[1],
               tolerance=1e-4, modes=modes, tokens_compared=gen * 5 * len(FUSED_MODES),
               launches=counted, routes=routes, problems=problems)
    emit(rec)
    if problems:
        raise SystemExit("fused f32 parity failed: " + "; ".join(problems[:5]))
    return counted


# --- phase 10: the fused dispatch modes at full width -------------------------


def phase_fused(smi: str, serve_tokens: dict, prefix_tokens: dict) -> dict:
    """Phase 10: qwen2.5-3b (36 layers, bf16, phase 3's seeded weights)
    through ``EngineCore``, 16 jobs a serve: (a) phase 3's workload with
    ``cuda_graphs=False`` (eager), tokens bit for bit phase 3's captured
    run's; (b) ``decode_block=4``, tokens equal phase 3's, K1 4 x 36
    launches a dispatch; (c) ``spec_tokens=3``, ``spec_ngram=2``: drafts
    accepted, K3 36 launches a verify iteration and K1 none; (d)
    ``mixed_step="on"`` with chunks of 256 on phase 4's template workload
    under phase 4's settings (v3, prefix cache): mixed steps taken, K3's
    launches counted. Every launch on the tensor-core route. Returns K3's
    launches on the verify and mixed paths."""
    from llmq_tpu_torch.cli.worker import engine_config
    from llmq_tpu_torch.engine.engine import EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    dev = torch.device("cuda")
    cfg = get_preset("qwen2.5-3b")
    L = cfg.num_layers
    # run_torch_worker's draw for preset://qwen2.5-3b at seed 0: phase 3's weights
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16,
                         device=dev)
    jobs, pjobs = _default_jobs(16, 128), _prefix_jobs(16, 64)

    def serve(jobs, gen, *, graphs=True, kernel="v1", max_model_len=512, **fields):
        with env(LLMQ_DECODE_KERNEL=kernel):
            core = EngineCore(cfg, params, ByteTokenizer(), device=dev, cuda_graphs=graphs,
                              engine_config=engine_config(cfg, dtype="bfloat16", max_num_seqs=16,
                                                          max_model_len=max_model_len, **fields))
        reset_launches()
        t0 = time.perf_counter()
        tokens = _generate(core, [j.get_formatted_prompt() for j in jobs], gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = {j.id: tokens[f"r{i}"] for i, j in enumerate(jobs)}
        return core, tokens, read_launches(), read_routes(), core.stats(), wall

    def finish(label, core, launches, routes, stats, wall, tokens, want, problems, **extra):
        equal = sum(tokens[k] == want[k] for k in want)
        rec = dict(phase="fused_serve", serve=label, model="preset://qwen2.5-3b", layers=L,
                   jobs=len(tokens), jobs_equal_reference=equal, wall_s=wall,
                   serve_completion_tok_s=sum(map(len, tokens.values())) / wall,
                   decode_steps=stats["decode_steps"],
                   decode_dispatches=stats["decode_dispatches"],
                   prefill_dispatches=stats["prefill_dispatches"],
                   cuda_graphs=stats["cuda_graphs"], launches=launches, routes=routes,
                   card=smi, **extra)
        problems += route_problems(routes, launches)
        rec["problems"] = problems
        emit(rec)
        del core
        gc.collect()
        torch.cuda.empty_cache()
        if problems:
            raise SystemExit(f"fused phase ({label}) failed: " + "; ".join(problems[:5]))
        return rec

    out = {}
    # (a) eager against phase 3's captured run
    core, tokens, launches, routes, stats, wall = serve(jobs, 128, graphs=False)
    problems = [] if tokens == serve_tokens else ["eager tokens differ from phase 3's captured run"]
    if stats["cuda_graphs"] is not None or launches["paged_decode"] != L * stats["decode_steps"]:
        problems.append(f"eager run: graphs {stats['cuda_graphs']}, K1 {launches['paged_decode']}")
    finish("eager (cuda_graphs=False)", core, launches, routes, stats, wall, tokens,
           serve_tokens, problems)

    # (b) decode_block=4
    core, tokens, launches, routes, stats, wall = serve(jobs, 128, decode_block=4)
    problems = graph_problems(stats)
    if tokens != serve_tokens:
        problems.append("decode_block=4 tokens differ from phase 3's")
    k1 = L * (stats["decode_steps"] + _warm(stats))
    if launches["paged_decode"] != k1 or stats["decode_steps"] != 4 * stats["decode_dispatches"]:
        problems.append(f"K1 {launches['paged_decode']} launches, want {k1} (4 x {L} a dispatch)")
    captured = captured_rates(core, S=16, ctx=330)
    finish("decode_block=4", core, launches, routes, stats, wall, tokens, serve_tokens,
           problems, **captured)

    # (c) spec_tokens=3, spec_ngram=2
    core, tokens, launches, routes, stats, wall = serve(jobs, 128, spec_tokens=3)
    problems = graph_problems(stats)
    iters = stats["decode_steps"] + _warm(stats, "verify")
    if launches["paged_prefill"] != L * iters or launches["paged_decode"]:
        problems.append(f"K3 {launches['paged_prefill']} launches, want {L} x {iters}; "
                        f"K1 {launches['paged_decode']}")
    if not stats["acceptance_rate"] > 0:
        problems.append(f"no draft accepted: {stats['spec_accepted']} of {stats['spec_proposed']}")
    row_iters = stats["spec_proposed"] / 3
    finish("spec_tokens=3", core, launches, routes, stats, wall, tokens, serve_tokens, problems,
           acceptance_rate=stats["acceptance_rate"], spec_proposed=stats["spec_proposed"],
           spec_accepted=stats["spec_accepted"], verify_iterations=stats["decode_steps"],
           tokens_per_row_verify_iteration=1 + stats["spec_accepted"] / max(row_iters, 1),
           note="jobs_equal_reference is printed, not asserted: K3's bf16 arithmetic is "
                "not K1's")
    out["verify"] = launches["paged_prefill"]

    # (d) mixed steps on phase 4's workload
    core, tokens, launches, routes, stats, wall = serve(
        pjobs, 64, kernel="v3", max_model_len=2048, mixed_step="on", prefill_chunk_size=256,
        enable_prefix_caching=True)
    problems = graph_problems(stats)
    K = 1
    k3 = L * (stats["prefill_dispatches"] + K * stats["mixed_steps"] + _warm(stats, "mixed"))
    k4 = L * (stats["decode_steps"] - K * stats["mixed_steps"] + _warm(stats))
    if stats["mixed_steps"] <= 0:
        problems.append("no mixed step")
    if launches["paged_prefill"] != k3 or launches["paged_decode_v3"] != k4:
        problems.append(f"K3 {launches['paged_prefill']} (want {k3}), K4 "
                        f"{launches['paged_decode_v3']} (want {k4})")
    finish("mixed_step=on", core, launches, routes, stats, wall, tokens, prefix_tokens,
           problems, mixed_steps=stats["mixed_steps"],
           mixed_prefill_tokens=stats["mixed_prefill_tokens"],
           note="jobs_equal_reference (phase 4's tokens) is printed, not asserted: the mixed "
                "grid's decode rows go through K3, not K4")
    out["mixed"] = launches["paged_prefill"]
    del params
    return out


# --- phase 8: the checkpoint path at full width ------------------------------

#: ours -> HF name of a layer tensor (qwen2: biases, no gemma2 norms)
HF_LAYER_NAMES = {
    "ln1": "input_layernorm.weight", "ln2": "post_attention_layernorm.weight",
    "q_proj": "self_attn.q_proj.weight", "k_proj": "self_attn.k_proj.weight",
    "v_proj": "self_attn.v_proj.weight", "o_proj": "self_attn.o_proj.weight",
    "q_bias": "self_attn.q_proj.bias", "k_bias": "self_attn.k_proj.bias",
    "v_bias": "self_attn.v_proj.bias", "gate_proj": "mlp.gate_proj.weight",
    "up_proj": "mlp.up_proj.weight", "down_proj": "mlp.down_proj.weight",
    # qwen2_moe (phase 18): the router, each expert's projections, the shared expert
    "router": "mlp.gate.weight", "expert_gate_proj": "mlp.experts.{e}.gate_proj.weight",
    "expert_up_proj": "mlp.experts.{e}.up_proj.weight",
    "expert_down_proj": "mlp.experts.{e}.down_proj.weight",
    "shared_gate_proj": "mlp.shared_expert.gate_proj.weight",
    "shared_up_proj": "mlp.shared_expert.up_proj.weight",
    "shared_down_proj": "mlp.shared_expert.down_proj.weight",
    "shared_expert_gate": "mlp.shared_expert_gate.weight",
}
_ST_TAGS = {torch.bfloat16: "BF16", torch.float32: "F32"}


def write_hf_checkpoint(cfg, params: dict, out_dir: str, shards: int = 2) -> int:
    """A qwen2 (or qwen2_moe) HF checkpoint of ``params``: config.json,
    ``shards`` safetensors files and their index, HF names, linear weights
    [out, in], an expert stack as one tensor per (layer, expert). Written
    tensor by tensor from the card; returns the bytes written."""
    hf = dict(model_type=cfg.model_type, vocab_size=cfg.vocab_size,
              hidden_size=cfg.hidden_size,
              num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
              num_key_value_heads=cfg.num_kv_heads, intermediate_size=cfg.intermediate_size,
              max_position_embeddings=cfg.max_position_embeddings, rope_theta=cfg.rope_theta,
              rms_norm_eps=cfg.rms_norm_eps, tie_word_embeddings=cfg.tie_word_embeddings)
    if cfg.num_experts:
        hf.update(num_experts=cfg.num_experts, num_experts_per_tok=cfg.num_experts_per_tok,
                  moe_intermediate_size=cfg.moe_intermediate_size,
                  shared_expert_intermediate_size=cfg.shared_expert_intermediate_size,
                  norm_topk_prob=cfg.norm_topk_prob, decoder_sparse_step=1, mlp_only_layers=[])
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f)
    names = [("model.embed_tokens.weight", lambda: params["embed"])]
    for i in range(cfg.num_layers):
        for ours, theirs in HF_LAYER_NAMES.items():
            t = params["layers"].get(ours)
            if t is None:
                continue
            if t.dim() == 4:  # [L, E, in, out]: one tensor an expert
                names += [(f"model.layers.{i}.{theirs.format(e=e)}",
                           lambda t=t, i=i, e=e: t[i, e].T) for e in range(t.shape[1])]
                continue
            names.append((f"model.layers.{i}.{theirs}",
                          lambda t=t, i=i: t[i].T if t.dim() == 3 else t[i]))
    names.append(("model.norm.weight", lambda: params["final_norm"]))
    if "lm_head" in params:
        names.append(("lm_head.weight", lambda: params["lm_head"].T))
    per = -(-len(names) // shards)
    weight_map, total = {}, 0
    for k in range(shards):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        part, header, at = names[k * per:(k + 1) * per], {}, 0
        for name, get in part:
            t = get()
            n = t.numel() * t.element_size()
            header[name] = dict(dtype=_ST_TAGS[t.dtype], shape=list(t.shape),
                                data_offsets=[at, at + n])
            at += n
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(out_dir, fname), "wb") as f:
            f.write(len(raw).to_bytes(8, "little") + raw)
            for name, get in part:
                f.write(get().contiguous().cpu().view(torch.uint8).numpy().tobytes())
                weight_map[name] = fname
        total += at
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return total


def _split_char_token(k: int) -> bytes:
    """Id ``k`` >= 257 of ``write_text_tokenizer``'s vocabulary: "é"'s
    continuation byte, " k", and "é"'s lead byte, so that every two such
    tokens in a row join into "é" across their boundary."""
    return b"\xa9" + f" {k}".encode() + b"\xc3"


def write_text_tokenizer(out_dir: str, vocab_size: int) -> None:
    """An HF tokenizer (tokenizer.json, tokenizer_config.json) beside a
    checkpoint in which every id has text: id 0 is the EOS, ids 1..256 are
    the byte tokenizer's (byte + 1, no merges, so a prompt encodes to the
    byte tokenizer's ids), and every later id ``k`` is
    ``_split_char_token(k)``. Random weights emit mostly those, so each
    streamed text splits a character across every flush."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers

    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    chars, n = {}, 0  # GPT-2's byte-level alphabet: byte -> printable character
    for b in range(256):
        if b in printable:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + n)
            n += 1
    vocab = {"<|endoftext|>": 0}
    vocab.update({chars[b]: b + 1 for b in range(256)})
    vocab.update({"".join(chars[b] for b in _split_char_token(k)): k
                  for k in range(257, vocab_size)})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens([AddedToken("<|endoftext|>", special=True)])
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump(dict(tokenizer_class="PreTrainedTokenizerFast", eos_token="<|endoftext|>",
                       clean_up_tokenization_spaces=False, model_max_length=32768,
                       chat_template="{% for m in messages %}{{ m['role'] + ': ' + m['content'] "
                                     "+ '\n' }}{% endfor %}{{ 'assistant: ' }}"), f)


def _leaves(tree: dict, prefix: str = ""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


class _RssPeak:
    """The host's resident set (``/proc/self/statm``), sampled every 5 ms
    while in the block: its growth over the start, at the peak."""

    def __enter__(self):
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        self.growth_gb = (self.peak - self.start) / 1e9


def _quantized_reference(loaded_bf16: dict, mode: str) -> dict:
    """The loader's block quantization (``engine/weights.py``) applied to
    the whole in-memory tensors: what streaming must reproduce."""
    from llmq_tpu_torch.engine import weights as tw
    from llmq_tpu_torch.models import quant as qm

    out = {}
    for name, t in _leaves(loaded_bf16):
        key = name.split(".")[-1]
        if name == "embed":
            q, s = tw._quant_int8(t.float(), axis=1)
            out.update({"embed.q": q, "embed.scale": s.to(t.dtype)})
        elif key in qm.QUANTIZED_LAYER_KEYS:
            for li in range(t.shape[0]):  # one layer at a time: the f32 copy stays small
                w = t[li].float()
                parts = (dict(zip(("q", "scale", "zero"), tw._quant_int4(w))) if mode == "int4"
                         else dict(zip(("q", "scale"), tw._quant_int8(w, axis=-2))))
                for p, v in parts.items():
                    v = v if p == "q" else v.to(t.dtype)
                    out.setdefault(f"{name}.{p}", torch.empty((t.shape[0], *v.shape),
                                                              dtype=v.dtype, device=v.device))
                    out[f"{name}.{p}"][li] = v
        else:
            out[name] = t
    return out


def _np_quant(a32: np.ndarray, axis: int):
    """The reference loader's host int8 quantization of one block
    (``llmq_tpu/engine/weights.py::_np_quant``), in numpy."""
    amax = np.abs(a32).max(axis=axis)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(a32 / np.expand_dims(scale, axis)), -127, 127).astype(np.int8)
    return q, scale


def _np_quant_int4(a32: np.ndarray, group: int):
    """The reference loader's host int4 quantization of one [K, N] block
    (``_np_quant_int4``), in numpy: packed codes, f32 scale and zero."""
    k, n = a32.shape
    ag = a32.reshape(k // group, group, n)
    amin, amax = ag.min(axis=-2), ag.max(axis=-2)
    scale = np.where(amax > amin, (amax - amin) / 15.0, 1.0).astype(np.float32)
    zero = np.rint(-amin / scale).astype(np.float32)
    q = np.clip(np.rint(ag / scale[:, None, :] + zero[:, None, :]), 0, 15).astype(np.uint8)
    q = q.reshape(k, n)
    return q[0::2] | (q[1::2] << 4), scale, zero


def _host_quant_mismatches(loaded: dict, quant: dict, mode: str) -> list:
    """Layers 0 and L - 1 of q_proj and down_proj, and the embedding's
    first 4,096 rows, quantized on the card against the reference loader's
    numpy arithmetic on the host (the scales compared in f32, then cast)."""
    from llmq_tpu_torch.models import quant as qm

    bad = []
    L = loaded["layers"]["q_proj"].shape[0]
    for key in ("q_proj", "down_proj"):
        for li in (0, L - 1):
            w = loaded["layers"][key][li].float().cpu().numpy()
            got = {k: v[li].cpu() for k, v in quant["layers"][key].items()}
            if mode == "int4":
                q, scale, zero = _np_quant_int4(w, qm.int4_group(w.shape[0]))
                want = {"q": q, "scale": scale, "zero": zero}
            else:
                q, scale = _np_quant(w, axis=-2)
                want = {"q": q, "scale": scale}
            for part, ref in want.items():
                ref_t = torch.from_numpy(ref)
                if part != "q":
                    ref_t = ref_t.to(got[part].dtype)
                if not _same_bits(ref_t, got[part]):
                    bad.append(f"{key}[{li}].{part}")
    e = loaded["embed"][:4096].float().cpu().numpy()
    q, scale = _np_quant(e, axis=1)
    if not (_same_bits(torch.from_numpy(q), quant["embed"]["q"][:4096].cpu())
            and _same_bits(torch.from_numpy(scale).to(quant["embed"]["scale"].dtype),
                           quant["embed"]["scale"][:4096].cpu())):
        bad.append("embed[:4096]")
    return bad


def phase_checkpoint(smi: str, serve_tokens: dict) -> int:
    """Phase 8: phase 3's qwen2.5-3b weights (the same seed) written as an
    HF checkpoint, loaded back bf16 (bit for bit), int8 and int4 (the
    loader's block quantization, against the same applied to whole
    tensors), and phase 3's jobs served from the loaded tree under
    ``LLMQ_DECODE_KERNEL=v2``: K5 on the tensor-core route, tokens equal
    to the first 32 of phase 3's; a bf16 load with the load ledger timed
    beside the plain one. Returns K5's launches."""
    import tempfile

    from llmq_tpu_torch.cli.worker import engine_config
    from llmq_tpu_torch.engine.engine import EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.engine.weights import load_checkpoint
    from llmq_tpu_torch.models import quant as qm
    from llmq_tpu_torch.models.config import ModelConfig
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    dev = torch.device("cuda")
    cfg = get_preset("qwen2.5-3b")
    # build_engine's draw for preset://qwen2.5-3b at seed 0: phase 3's weights
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16,
                         device=dev)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    free_gb = shutil.disk_usage(build_dir).free / 1e9
    ckpt = tempfile.mkdtemp(prefix="hf-qwen2.5-3b-", dir=build_dir)
    problems, rec = [], dict(phase="checkpoint", model="qwen2.5-3b", layers=cfg.num_layers,
                             disk_free_gb_before=free_gb, card=smi)
    try:
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(cfg, params, ckpt)
        rec.update(checkpoint_gb=nbytes / 1e9, write_s=time.perf_counter() - t0)
        if ModelConfig.from_pretrained(ckpt) != cfg:
            problems.append("ModelConfig.from_pretrained differs from the preset")
        torch.cuda.synchronize()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            loaded = load_checkpoint(ckpt, cfg, dtype=torch.bfloat16, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        want, got = dict(_leaves(params)), dict(_leaves(loaded))
        bad = [n for n in want if n not in got or not _same_bits(want[n], got[n])]
        if sorted(want) != sorted(got) or bad:
            problems.append(f"bf16 load differs from the in-memory weights: {bad[:5]}")
        rec.update(load_bf16_s=load_s, load_bf16_gb_s=nbytes / 1e9 / load_s,
                   load_bf16_host_rss_growth_gb=rss.growth_gb, bf16_leaves=len(want),
                   bf16_bit_exact=not bad)
        # The load ledger (a worker's checkpoint load keeps one): each block
        # copied back to the host and hashed.
        ledger = {}
        t0 = time.perf_counter()
        again = load_checkpoint(ckpt, cfg, dtype=torch.bfloat16, device="cuda",
                                checksum_ledger=ledger)
        torch.cuda.synchronize()
        rec.update(load_bf16_ledger_s=time.perf_counter() - t0, ledger_entries=len(ledger))
        if len(ledger) != len(want):
            problems.append(f"the load ledger has {len(ledger)} entries for {len(want)} leaves")
        del params, want, again
        for mode in ("int8", "int4"):
            with _RssPeak() as rss:
                t0 = time.perf_counter()
                quant = load_checkpoint(ckpt, cfg, dtype=torch.bfloat16, device="cuda",
                                        quantize=mode)
                torch.cuda.synchronize()
                q_s = time.perf_counter() - t0
            ref = _quantized_reference(loaded, mode)
            mine = dict(_leaves(quant))
            bad = [n for n in ref if n not in mine or not _same_bits(ref[n], mine[n])]
            if sorted(ref) != sorted(mine) or bad:
                problems.append(f"{mode} load differs from whole-tensor quantization: {bad[:5]}")
            host_bad = _host_quant_mismatches(loaded, quant, mode)
            if host_bad:
                problems.append(f"{mode} load differs from the reference's numpy arithmetic: "
                                f"{host_bad}")
            # Where quantize_params (XLA's reciprocal product, the preset
            # path's quantizer) would put other codes or scales: counted.
            whole = dict(_leaves(qm.quantize_params(loaded, scale_dtype=torch.bfloat16,
                                                    bits=4 if mode == "int4" else 8)))
            differ = {n: int((whole[n] != mine[n]).sum()) for n in whole
                      if n.rsplit(".", 1)[-1] in ("q", "scale", "zero")}
            rec.update({f"load_{mode}_s": q_s, f"load_{mode}_gb_s": nbytes / 1e9 / q_s,
                        f"load_{mode}_host_rss_growth_gb": rss.growth_gb,
                        f"{mode}_bit_exact_vs_whole_tensor": not bad,
                        f"{mode}_bit_exact_vs_reference_numpy_sample": not host_bad,
                        f"{mode}_elements_unlike_quantize_params":
                            {n: c for n, c in differ.items() if c}})
            del quant, ref, mine, whole
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    # Phase 3's jobs from the loaded tree, under v2 (K5), 32 new tokens each.
    gen = 32
    jobs = _default_jobs(16, gen)
    with env(LLMQ_DECODE_KERNEL="v2"):
        core = EngineCore(cfg, loaded, ByteTokenizer(), device=dev, engine_config=engine_config(
            cfg, dtype="bfloat16", max_num_seqs=16, max_model_len=512))
    reset_launches()
    t0 = time.perf_counter()
    tokens = _generate(core, [j.get_formatted_prompt() for j in jobs], gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_launches(), read_routes()
    stats = core.stats()
    L = cfg.num_layers
    same = all(tokens[f"r{i}"] == serve_tokens[j.id][:gen] for i, j in enumerate(jobs))
    if not same:
        problems.append("tokens differ from the first 32 of phase 3's")
    if (launches["paged_decode_v2"] != L * (stats["decode_steps"] + _warm(stats))
            or launches["paged_decode"]):
        problems.append(f"K5 {launches['paged_decode_v2']} launches for "
                        f"{stats['decode_steps']} decode steps + {_warm(stats)} warm-ups, K1 "
                        f"{launches['paged_decode']}")
    problems += route_problems(routes, launches) + graph_problems(stats)
    rec.update(decode_kernel=stats["decode_kernel"], serve_wall_s=wall,
               serve_completion_tok_s=16 * gen / wall, tokens_equal_phase3_first_32=same,
               decode_steps=stats["decode_steps"], launches=launches, routes=routes,
               problems=problems)
    emit(rec)
    if problems or stats["decode_kernel"] != "v2":
        raise SystemExit("checkpoint phase failed: " + "; ".join(problems[:5]))
    del core, loaded
    return launches["paged_decode_v2"]


# --- phase 9: tcp:// and the command line at full width ----------------------

_SERVER = """import asyncio, sys
from llmq_tpu_torch.broker.tcp import BrokerServer

async def main():
    srv = BrokerServer("127.0.0.1", 0)
    await srv.start()
    print(srv._server.sockets[0].getsockname()[1], flush=True)
    await asyncio.Event().wait()

asyncio.run(main())
"""


def _stop(proc: subprocess.Popen, sig=signal.SIGTERM, timeout: float = 60) -> int:
    if proc.poll() is None:
        proc.send_signal(sig)
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def phase_tcp_cli(smi: str, serve_tokens: dict, solo_tokens: dict) -> dict:
    """Phase 9: the port's ``BrokerServer`` in a process of its own,
    phase 3's jobs (32 new tokens) published to it over tcp://, served by
    ``python -m llmq_tpu_torch worker run preset://qwen2.5-3b`` in another
    process, which SIGTERM stops with exit code 0."""
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    n_jobs, gen, queue = 16, 32, "smoke-tcp"
    penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    server = subprocess.Popen([sys.executable, "-c", _SERVER], cwd=root, env=penv,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    worker = None
    problems = []
    try:
        url = f"tcp://127.0.0.1:{int(server.stdout.readline())}"
        jobs = _default_jobs(n_jobs, gen)
        asyncio.run(_submit(url, queue, jobs))
        log_path = os.path.join(OUT_DIR, "tcp_worker.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            worker = subprocess.Popen(
                [sys.executable, "-m", "llmq_tpu_torch", "worker", "run",
                 "preset://qwen2.5-3b", queue, "--max-num-seqs", "16", "--max-model-len", "512",
                 "--dtype", "bfloat16"],
                cwd=root, env=dict(penv, LLMQ_BROKER_URL=url, LLMQ_DECODE_KERNEL="v1",
                                 LLMQ_RESULT_DIGEST="1"),
                stdout=log, stderr=subprocess.STDOUT)
            results = asyncio.run(_receive_n(url, queue, n_jobs, worker, timeout=600))
            wall = time.perf_counter() - t0
            rc = _stop(worker)
        if rc != 0:
            problems.append(f"worker exited {rc} on SIGTERM")
        problems += _check_results(results, n_jobs, gen)
        tok = ByteTokenizer()
        shapes = [_served_as(r.get("token_ids"), r["id"], gen, serve_tokens, solo_tokens)
                  for r in results]
        for r, shape in zip(results, shapes):
            if shape is None or r["result"] != tok.decode(r["token_ids"]):
                problems.append(f"{r['id']}: tokens differ from the first {gen} of phase 3's "
                                f"and of its solo run's")
        gen_tokens = sum(r["usage"]["completion_tokens"] for r in results)
        rec = dict(phase="tcp_cli", model="preset://qwen2.5-3b", broker=url, jobs=len(results),
                   prefilled_solo=shapes.count("solo"),
                   gen_tokens=gen_tokens, wall_s=wall, serve_completion_tok_s=gen_tokens / wall,
                   timing="from the worker process's start, its engine build included",
                   worker_exit_code=rc, card=smi, problems=problems)
        emit(rec)
    finally:
        if worker is not None:
            _stop(worker, signal.SIGKILL, 10)
        _stop(server, signal.SIGTERM, 10)
    if problems:
        raise SystemExit("tcp/cli phase failed: " + "; ".join(problems[:5]))
    return rec


async def _receive_n(url: str, queue: str, n: int, proc, timeout: float,
                     log: str = "tcp_worker.log") -> list:
    """``n`` results off ``<queue>.results``, acked, while ``proc`` (its
    output in ``log``) lives."""
    from llmq_tpu_torch.broker.base import make_broker

    broker = make_broker(url)
    await broker.connect()
    results, deadline = [], time.monotonic() + timeout
    try:
        while len(results) < n:
            if time.monotonic() > deadline or proc.poll() is not None:
                raise SystemExit(f"{len(results)} of {n} results, worker exit code "
                                 f"{proc.poll()} (log: {log} in {OUT_DIR})")
            msg = await broker.get(queue + ".results")
            if msg is None:
                await asyncio.sleep(0.1)
                continue
            results.append(json.loads(msg.body))
            await msg.ack()
    finally:
        await broker.close()
    return results


# --- phase 11: the request-state plane at full width -------------------------

SNAPSHOT_POOL_PAGES = 137  # 136 usable pages of 32: 16 rows of 200 + 128 tokens must preempt


def _snapshot_engine(params, cfg, **fields):
    """Phase 3's engine settings through ``EngineCore`` (16 slots, 512
    positions, bf16, K1), with ``fields`` over them."""
    from llmq_tpu_torch.cli.worker import engine_config
    from llmq_tpu_torch.engine.engine import EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    ecfg = engine_config(cfg, dtype="bfloat16", max_num_seqs=16, max_model_len=512,
                         decode_block=fields.pop("decode_block", None))
    with env(LLMQ_DECODE_KERNEL="v1"):
        return EngineCore(cfg, params, ByteTokenizer(), device=torch.device("cuda"),
                          engine_config=dataclasses.replace(ecfg, **fields))


def _step_to_end(core, outs: dict) -> dict:
    while core.has_work:
        outs.update({o.rid: o for o in core.step()})
    return outs


def _greedy(n: int):
    from llmq_tpu_torch.engine.sampling import SamplingParams

    return SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True)


def _snapshot_round_trip(smi, cfg, params, jobs, serve_tokens) -> dict:
    """Phase 11 (a): 16 rows decode to >= 40 tokens each, ``extract_all``,
    the bytes codec both ways, ``insert_request`` back into the same
    engine, decode to the end: tokens equal phase 3's, the pools keep
    their storage and no graph is captured again. Then the gather and the
    in-place insert of the same rows' pages, timed apart."""
    from llmq_tpu_torch.engine import snapshot as snap_mod

    L = cfg.num_layers
    core = _snapshot_engine(params, cfg)
    reset_launches()
    for j in jobs:
        core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(128))
    outs: dict = {}
    while (len(core.scheduler.running) < len(jobs)
           or min(len(s.output_ids) for s in core.scheduler.running.values()) < 40):
        outs.update({o.rid: o for o in core.step()})
    ptrs = (core.k_pages.data_ptr(), core.v_pages.data_ptr())
    captures = core.stats()["cuda_graphs"]["captures"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = core.extract_all(finished=[])
    extract_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    blobs = [s.to_bytes() for s in snaps]
    encode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = [snap_mod.RequestSnapshot.from_bytes(b) for b in blobs]
    decode_ms = (time.perf_counter() - t0) * 1e3
    offsets = sorted(len(s.output_ids) for s in back)
    for s in back:
        core.insert_request(s)
    outs = _step_to_end(core, outs)
    torch.cuda.synchronize()
    launches, routes = read_launches(), read_routes()
    st = core.stats()
    tokens = {rid: o.token_ids for rid, o in outs.items()}
    problems = route_problems(routes, launches) + graph_problems(st)
    equal = sum(tokens.get(j.id) == serve_tokens[j.id] for j in jobs)
    if equal != len(jobs):
        problems.append(f"{equal} of {len(jobs)} restored jobs equal phase 3's tokens")
    if len(snaps) != len(jobs) or any(s.kv_k is None for s in snaps):
        problems.append(f"{len(snaps)} snapshots, some without KV pages")
    if st["cuda_graphs"]["captures"] != captures:
        problems.append(f"captures {captures} -> {st['cuda_graphs']['captures']} over the restore")
    if (core.k_pages.data_ptr(), core.v_pages.data_ptr()) != ptrs:
        problems.append("the restore moved the KV pools")
    if st["kv_restores"] != len(jobs) or st["snapshots_inserted"] != len(jobs):
        problems.append(f"kv_restores {st['kv_restores']}, inserted {st['snapshots_inserted']}")
    if launches["paged_decode"] != L * (st["decode_steps"] + _warm(st)):
        problems.append(f"K1 {launches['paged_decode']} != {L} x ({st['decode_steps']} + "
                        f"{_warm(st)})")
    if launches["flash_prefill"] != L * st["prefill_dispatches"]:
        problems.append(f"K2 {launches['flash_prefill']} != {L} x {st['prefill_dispatches']}")
    # The same rows' pages through the gather and the insert alone, with
    # every row finished (their pages free; nothing reads them again).
    n = max(s.kv_k.shape[1] for s in snaps)
    rows = [torch.arange(1 + r * n, 1 + (r + 1) * n, device=core.device) for r in range(len(jobs))]
    gather_ms = insert_ms = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [(snap_mod.pages_to_host(core.k_pages, idx), snap_mod.pages_to_host(core.v_pages, idx))
                for idx in rows]
        gather_ms = min(gather_ms, (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx, (k, v) in zip(rows, host):
            snap_mod.pages_from_host(core.k_pages, idx, k)
            snap_mod.pages_from_host(core.v_pages, idx, v)
        torch.cuda.synchronize()
        insert_ms = min(insert_ms, (time.perf_counter() - t0) * 1e3)
    kv_bytes = sum(k.nbytes + v.nbytes for k, v in host)
    rec = dict(
        phase="snapshot", part="a: round trip", model="preset://qwen2.5-3b", layers=L,
        rows=len(snaps), resume_offsets=offsets, jobs_equal_phase3=equal,
        snapshot_bytes_per_row=sum(map(len, blobs)) / len(blobs),
        kv_positions_per_row=sum(s.kv_valid for s in snaps) / len(snaps),
        extract_all_ms=extract_ms, encode_ms=encode_ms, decode_ms=decode_ms,
        gather_ms=gather_ms, gather_gb_s=kv_bytes / gather_ms / 1e6,
        insert_ms=insert_ms, insert_gb_s=kv_bytes / insert_ms / 1e6, timed_kv_bytes=kv_bytes,
        timing="16 rows of pages, both pools: gather = one index_select and one copy to "
               "pageable host memory a pool and row; insert = one copy to the card and one "
               "index_copy_ a pool and row; best of 3; extract_all includes the drain of "
               "the run-ahead",
        captures_before=captures, captures_after=st["cuda_graphs"]["captures"],
        kv_restores=st["kv_restores"], decode_steps=st["decode_steps"],
        prefill_dispatches=st["prefill_dispatches"], launches=launches, routes=routes,
        card=smi, problems=problems,
    )
    emit(rec)
    del core
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise SystemExit("snapshot phase (a) failed: " + "; ".join(problems[:5]))
    return launches


# A row of bf16 recompute that parts from phase 3's tokens must part at a
# near-tie: at the first position where they differ, both tokens rank in
# the top 3 of the logits that a prefill of the shared context gives, and
# their logits lie at most NEAR_TIE_ULPS bf16 steps apart (the step at the
# top logit's magnitude; the head's matmul rounds logits to bf16). A fault
# in the re-prefill path would pick a token that ranks nowhere near.
NEAR_TIE_ULPS = 4


def _parting_witness(core, jobs, tokens: dict, serve_tokens: dict) -> dict:
    """For each job whose ``tokens`` part from phase 3's: the first position
    where they part and, there, the logits of one prefill (through K2, on
    pools of its own) of the prompt and the tokens both runs share: the
    two tokens' logits, their ranks, the gap in logits and in bf16 steps."""
    out = {}
    page = core.k_pages.shape[2]
    L, _, _, n_kv, d = core.k_pages.shape
    for j in jobs:
        got, want = tokens.get(j.id), serve_tokens[j.id]
        if got == want:
            continue
        pos = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        ids = core.tokenizer.encode(j.get_formatted_prompt()) + want[:pos]
        T = next(b for b in core._buckets if b >= len(ids))
        n = -(-T // page)
        pools = [torch.zeros((L, n + 1, page, n_kv, d), dtype=core.k_pages.dtype,
                             device=core.k_pages.device) for _ in range(2)]
        toks = torch.zeros((1, T), dtype=torch.int32, device=core.device)
        toks[0, : len(ids)] = torch.tensor(ids, dtype=torch.int32)
        lengths = torch.tensor([len(ids)], dtype=torch.int32, device=core.device)
        bt = torch.arange(1, n + 1, dtype=torch.int32, device=core.device)[None]
        logits = core.model.prefill(toks, lengths, *pools, bt)[0].float()
        top = torch.topk(logits, 3)
        a, b = want[pos], got[pos] if pos < len(got) else None
        la = float(logits[a])
        lb = float(logits[b]) if b is not None else float("nan")
        step = 2.0 ** (math.floor(math.log2(abs(float(top.values[0])))) - 7)
        rank = lambda t: int((logits > logits[t]).sum())  # noqa: E731
        out[j.id] = dict(position=pos, phase3_token=a, recompute_token=b,
                         phase3_logit=la, recompute_logit=lb, gap=abs(la - lb),
                         gap_bf16_steps=abs(la - lb) / step, bf16_step=step,
                         phase3_rank=rank(a), recompute_rank=rank(b) if b is not None else None,
                         top3_logits=[float(v) for v in top.values])
        del pools
    return out


def _swap_serves(make, jobs, modes, serve_tokens=None) -> dict:
    """The 16 jobs through an engine per preemption mode (``make(mode)``):
    tokens, stats, wall time, launches; with ``serve_tokens``, the witness
    of each row that parts from them (``_parting_witness``)."""
    recs = {}
    for mode in modes:
        core = make(mode)
        reset_launches()
        t0 = time.perf_counter()
        for j in jobs:
            core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(128))
        outs = _step_to_end(core, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = read_launches(), read_routes()
        st = core.stats()
        tokens = {rid: o.token_ids for rid, o in outs.items()}
        recs[mode] = dict(tokens=tokens, stats=st, wall=wall, launches=launches, routes=routes)
        if serve_tokens is not None:
            recs[mode]["parting"] = _parting_witness(core, jobs, tokens, serve_tokens)
        del core
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def _snapshot_swap(smi, cfg, params, jobs, serve_tokens) -> None:
    """Phase 11 (b): the 16 jobs on a pool that must preempt, under
    recompute and under swap preemption, in bf16 at full width (swap's
    tokens equal phase 3's), then at the same widths in f32 on 2 layers
    on the exact routes, where recompute's re-prefill gives the
    uninterrupted run's tokens too and all three must agree."""
    recs = _swap_serves(lambda mode: _snapshot_engine(
        params, cfg, num_pages=SNAPSHOT_POOL_PAGES, preempt_mode=mode), jobs,
        ("recompute", "swap"), serve_tokens)
    rec_, swap = recs["recompute"], recs["swap"]
    problems = []
    for r in recs.values():
        problems += route_problems(r["routes"], r["launches"]) + graph_problems(r["stats"])
    equal = {m: [j.id for j in jobs if r["tokens"].get(j.id) == serve_tokens[j.id]]
             for m, r in recs.items()}
    if len(equal["swap"]) != len(jobs):
        problems.append(f"{len(equal['swap'])} of {len(jobs)} swap jobs equal phase 3's")
    parting = rec_["parting"]
    for rid, w in parting.items():
        if (w["recompute_rank"] is None or max(w["phase3_rank"], w["recompute_rank"]) > 2
                or not w["gap_bf16_steps"] <= NEAR_TIE_ULPS):
            problems.append(f"recompute's {rid} parts from phase 3's at {w['position']} at no "
                            f"near-tie: ranks {w['phase3_rank']} / {w['recompute_rank']}, gap "
                            f"{w['gap']} ({w['gap_bf16_steps']} bf16 steps)")
    s, r = swap["stats"], rec_["stats"]
    if r["preemptions"] < 1 or s["swap_preempts"] < 1 or s["kv_restores"] < 1:
        problems.append(f"preemptions {r['preemptions']}, swap_preempts {s['swap_preempts']}, "
                        f"kv_restores {s['kv_restores']}")
    if not s["prefill_tokens"] < r["prefill_tokens"]:
        problems.append(f"swap prefill tokens {s['prefill_tokens']} not under recompute's "
                        f"{r['prefill_tokens']}")
    # f32, 2 layers, the exact routes (TF32 off): all three runs agree.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg, tree = _parity_config()
    f32 = _swap_serves(lambda mode: _engine(
        pcfg, tree, torch.device("cuda"), max_num_seqs=16, max_model_len=512, kv_dtype="f32",
        preempt_mode="recompute" if mode == "whole" else mode,
        num_pages=None if mode == "whole" else SNAPSHOT_POOL_PAGES), jobs,
        ("whole", "recompute", "swap"))
    for r in f32.values():
        problems += route_problems(r["routes"], r["launches"], route="exact")
    f32_equal = {m: sum(f32[m]["tokens"][j.id] == f32["whole"]["tokens"][j.id] for j in jobs)
                 for m in ("recompute", "swap")}
    if f32_equal != {"recompute": len(jobs), "swap": len(jobs)}:
        problems.append(f"f32 jobs equal to the uninterrupted run: {f32_equal}")
    fs = f32["swap"]["stats"]
    if f32["recompute"]["stats"]["preemptions"] < 1 or fs["swap_preempts"] < 1:
        problems.append(f"f32: preemptions {f32['recompute']['stats']['preemptions']}, "
                        f"swap_preempts {fs['swap_preempts']}")
    emit(dict(phase="snapshot", part="b: swap against recompute", num_pages=SNAPSHOT_POOL_PAGES,
              bf16_jobs_equal_phase3={m: len(v) for m, v in equal.items()},
              bf16_recompute_jobs_differing=[j.id for j in jobs if j.id not in equal["recompute"]],
              bf16_recompute_parting=parting, near_tie_limit_bf16_steps=NEAR_TIE_ULPS,
              **{f"bf16_{m}_{k}": recs[m]["stats"][k] for m in recs
                 for k in ("preemptions", "swap_preempts", "kv_restores", "prefill_tokens",
                           "prefill_dispatches", "decode_steps")},
              bf16_recompute_wall_s=rec_["wall"], bf16_swap_wall_s=swap["wall"],
              bf16_swap_launches=swap["launches"],
              f32_2_layers_jobs_equal_uninterrupted=f32_equal,
              **{f"f32_{m}_{k}": f32[m]["stats"][k] for m in ("recompute", "swap")
                 for k in ("preemptions", "swap_preempts", "kv_restores", "prefill_tokens")},
              note="bf16 recompute's equality with phase 3 is printed, not asserted: its "
                   "re-prefill computes the generated positions' K/V through K2 and a "
                   "many-row projection, where the uninterrupted run wrote them a decode row "
                   "at a time; swap restores the very bytes. Each row that parts must part at "
                   "a near-tie (bf16_recompute_parting: ranks from 0 under a prefill of the "
                   "shared context)",
              card=smi, problems=problems))
    if problems:
        raise SystemExit("snapshot phase (b) failed: " + "; ".join(problems[:5]))


VIP_PROMPT = ("Answer in one short sentence, in French, and keep the register formal: what "
              "does the quarterly report say about growth in the northern region this year? ")


def _snapshot_priority(smi, cfg, params, jobs, serve_tokens) -> None:
    """Phase 11 (c): 16 batch rows fill the slots at ``decode_block`` 4 and
    ``interactive_decode_block`` 1 (swap preemption); one request arrives
    once they all decode, first as batch, then as interactive; then alone."""
    core = _snapshot_engine(params, cfg, decode_block=4, interactive_decode_block=1,
                            preempt_mode="swap")
    runs = {}
    for prio in ("batch", "interactive"):
        for j in jobs:
            core.add_request(f"{prio}-{j.id}", prompt=j.get_formatted_prompt(),
                             params=_greedy(128))
        outs: dict = {}
        while (len(core.scheduler.running) < len(jobs)
               or min(len(s.output_ids) for s in core.scheduler.running.values()) < 8):
            outs.update({o.rid: o for o in core.step()})
        before = dict(pp=core.priority_preemptions, steps=core.decode_steps,
                      dispatches=core.decode_dispatches)
        core.add_request(f"vip-{prio}", prompt=VIP_PROMPT, params=_greedy(32), priority=prio)
        outs = _step_to_end(core, outs)
        vip = outs[f"vip-{prio}"]
        runs[prio] = dict(
            tokens=vip.token_ids, ttft_ms=(vip.timing["first_token"] - vip.timing["enqueued"]) * 1e3,
            finish_ms=(vip.timing["finished"] - vip.timing["enqueued"]) * 1e3,
            priority_preemptions=core.priority_preemptions - before["pp"],
            decode_steps=core.decode_steps - before["steps"],
            decode_dispatches=core.decode_dispatches - before["dispatches"],
            batch_equal_phase3=sum(outs[f"{prio}-{j.id}"].token_ids == serve_tokens[j.id]
                                   for j in jobs))
    replays_small = core._graphs.replays
    small_graphs = 1 in core.stats()["cuda_graphs"]["graph_iterations"]
    core.add_request("solo", prompt=VIP_PROMPT, params=_greedy(32))
    solo = _step_to_end(core, {})
    problems = graph_problems(core.stats())
    if runs["interactive"]["priority_preemptions"] != 1 or runs["batch"]["priority_preemptions"]:
        problems.append(f"priority preemptions {runs['interactive']['priority_preemptions']} "
                        f"(interactive), {runs['batch']['priority_preemptions']} (batch)")
    if runs["interactive"]["tokens"] != solo["solo"].token_ids:
        problems.append("the interactive request's tokens differ from its solo run")
    if not small_graphs:
        problems.append("no graph of the small interactive block was captured")
    it = runs["interactive"]
    if not it["decode_steps"] < 4 * it["decode_dispatches"]:
        problems.append("no small-block dispatch while the interactive row was resident")
    emit(dict(phase="snapshot", part="c: priority", decode_block=4, interactive_decode_block=1,
              ttft_interactive_ms=it["ttft_ms"], ttft_as_batch_ms=runs["batch"]["ttft_ms"],
              finish_interactive_ms=it["finish_ms"], finish_as_batch_ms=runs["batch"]["finish_ms"],
              priority_preemptions=it["priority_preemptions"],
              small_block_graph=small_graphs, replays_through_c=replays_small,
              batch_rows_equal_phase3={p: r["batch_equal_phase3"] for p, r in runs.items()},
              timing="engine host stamps, enqueue to first token / to finish, the 16 batch "
                     "rows decoding", card=smi, problems=problems))
    del core
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise SystemExit("snapshot phase (c) failed: " + "; ".join(problems[:5]))


async def _collect_results(url: str, queue: str, n: int, procs, timeout: float,
                           on_first=None) -> list:
    """``n`` results off ``<queue>.results``, acked; ``on_first`` runs when
    the first lands. Fails when the time runs out or every process in
    ``procs()`` has exited."""
    from llmq_tpu_torch.broker.base import make_broker

    broker = make_broker(url)
    await broker.connect()
    results, deadline = [], time.monotonic() + timeout
    try:
        while len(results) < n:
            live = procs()
            if time.monotonic() > deadline or (live and all(p.poll() is not None for p in live)):
                raise SystemExit(f"{len(results)} of {n} results from the worker processes "
                                 f"(their logs are in {OUT_DIR})")
            msg = await broker.get(queue + ".results")
            if msg is None:
                await asyncio.sleep(0.01)
                continue
            results.append(json.loads(msg.body))
            await msg.ack()
            if len(results) == 1 and on_first is not None:
                on_first()
    finally:
        await broker.close()
    return results


def _snapshot_handoff(smi, serve_tokens, solo_tokens) -> None:
    """Phase 11 (d): phase 9's ``BrokerServer`` and a ``python -m
    llmq_tpu_torch worker run`` process, SIGTERM'd when the first result
    lands (a job of 8 tokens; the others ask for 128); a second worker
    process drains the queue, resuming the handed-off jobs."""
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    n_jobs, queue = 16, "smoke-handoff"
    gens = {f"job-{i:02d}": 8 if i == 0 else 128 for i in range(n_jobs)}
    jobs = [Job(**{**j.model_dump(), "max_tokens": gens[j.id]})
            for j in _default_jobs(n_jobs, 128)]
    penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    server = subprocess.Popen([sys.executable, "-c", _SERVER], cwd=root, env=penv,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    workers, rcs, problems = [], [], []
    try:
        url = f"tcp://127.0.0.1:{int(server.stdout.readline())}"
        asyncio.run(_submit(url, queue, jobs))

        def start(i):
            log = open(os.path.join(OUT_DIR, f"handoff_worker{i}.log"), "w")
            workers.append(subprocess.Popen(
                [sys.executable, "-m", "llmq_tpu_torch", "worker", "run", "preset://qwen2.5-3b",
                 queue, "--max-num-seqs", "16", "--max-model-len", "512", "--dtype", "bfloat16"],
                cwd=root, env=dict(penv, LLMQ_BROKER_URL=url, LLMQ_DECODE_KERNEL="v1",
                                 LLMQ_RESULT_DIGEST="1"),
                stdout=log, stderr=subprocess.STDOUT))
            log.close()

        t0 = time.perf_counter()
        start(1)
        stopped = {}

        def sigterm_first():
            stopped["t"] = time.perf_counter()
            workers[0].send_signal(signal.SIGTERM)

        first = asyncio.run(_collect_results(url, queue, 1, lambda: workers, 600, sigterm_first))
        rcs.append(_stop(workers[0], signal.SIGTERM, 120))
        drained_s = time.perf_counter() - stopped["t"]
        start(2)
        rest = asyncio.run(_collect_results(url, queue, n_jobs - len(first), lambda: workers[1:],
                                            600))
        wall = time.perf_counter() - t0
        rcs.append(_stop(workers[1], signal.SIGTERM, 120))
    finally:
        for w in workers:
            _stop(w, signal.SIGKILL, 10)
        _stop(server, signal.SIGTERM, 10)
    results = first + rest
    ids = [r["id"] for r in results]
    if sorted(ids) != sorted(gens):
        problems.append(f"{len(results)} results, {len(set(ids))} unique ids")
    tok = ByteTokenizer()
    shapes = []
    for r in results:
        n = gens[r["id"]]
        shapes.append(_served_as(r.get("token_ids"), r["id"], n, serve_tokens, solo_tokens))
        if (shapes[-1] is None or r["result"] != tok.decode(r["token_ids"])
                or r["usage"]["completion_tokens"] != n):
            problems.append(f"{r['id']}: tokens differ from the first {n} of phase 3's and of "
                            f"its solo run's")
    offsets = {r["id"]: r.get("resume_offset", 0) for r in results}
    if not any(o > 0 for o in offsets.values()):
        problems.append("no result was resumed from a snapshot (resume_offset > 0)")
    if rcs != [0, 0]:
        problems.append(f"worker exit codes {rcs}")
    emit(dict(phase="snapshot", part="d: worker handoff over tcp://", broker=url,
              jobs=len(results), prefilled_solo=shapes.count("solo"),
              resumed=sum(o > 0 for o in offsets.values()),
              resume_offsets=sorted(o for o in offsets.values() if o > 0),
              first_worker_drain_s=drained_s, wall_s=wall, worker_exit_codes=rcs,
              timing="from the first worker process's start to the 16th result; drain = "
                     "SIGTERM to the first worker's exit", card=smi, problems=problems))
    if problems:
        raise SystemExit("snapshot phase (d) failed: " + "; ".join(problems[:5]))


def phase_snapshot(smi: str, serve_tokens: dict, solo_tokens: dict) -> dict:
    """Phase 11, the request-state plane (M11) at full width: qwen2.5-3b,
    bf16, phase 3's seeded weights and 16 jobs; parts (a)-(d). Returns the
    launches of part (a), whose restored rows decode through K1."""
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    cfg = get_preset("qwen2.5-3b")
    # build_engine's draw for preset://qwen2.5-3b at seed 0: phase 3's weights
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
                         device=torch.device("cuda"))
    jobs = _default_jobs(16, 128)
    launches = _snapshot_round_trip(smi, cfg, params, jobs, serve_tokens)
    _snapshot_swap(smi, cfg, params, jobs, serve_tokens)
    _snapshot_priority(smi, cfg, params, jobs, serve_tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _snapshot_handoff(smi, serve_tokens, solo_tokens)
    return launches


# --- phase 12: the prefix-KV plane at full width ------------------------------

PREFIX_HOST_GB = 1.0  # the host tier's budget: ~870 pages of 1.18 MB
# A pool the 16 templated rows outgrow (each holds ~37 pages, 32 shared):
# admissions and page growth evict cached pages while dispatches fly.
PRESSURE_PAGES = 80


def _prefix_kv_engine(params, cfg, dtype="bfloat16", **fields):
    """Phase 4's engine settings (v3, chunks of 256, the prefix cache, 16
    slots, 2,048 positions, bf16 unless ``dtype`` says otherwise) through
    ``EngineCore``, ``fields`` over them."""
    from llmq_tpu_torch.cli.worker import engine_config
    from llmq_tpu_torch.engine.engine import EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    ecfg = engine_config(cfg, dtype=dtype, max_num_seqs=16, max_model_len=2048,
                         prefill_chunk_size=256, enable_prefix_caching=True)
    with env(LLMQ_DECODE_KERNEL="v3"):
        return EngineCore(cfg, params, ByteTokenizer(), device=torch.device("cuda"),
                          engine_config=dataclasses.replace(ecfg, **fields))


def _timed_promotes(core) -> list:
    """Wrap the engine's promotion so each wave that promotes is timed
    alone (synchronized before and after): [(seconds, pages, bytes)]."""
    timed, promote = [], core._promote_host_pages

    def wrapper(admitted):
        hr = [e for s in admitted for _, _, e in (s.host_restore or ())]
        if not hr:
            return promote(admitted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        promote(admitted)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t0, len(hr), sum(e.nbytes for e in hr)))

    core._promote_host_pages = wrapper
    return timed


def _two_waves(core, jobs, gen: int) -> dict:
    """``jobs[:8]`` to their end, every cached page flushed to the host
    tier (dropped with the tier off), then ``jobs[8:]`` to their end.
    Returns the tokens and what the flush cost."""
    outs: dict = {}
    for j in jobs[:8]:
        core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
    outs = _step_to_end(core, outs)
    captures = core.stats()["cuda_graphs"]["captures"]
    demotes = core.prefix_demotes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flushed = core.flush_prefix_to_host()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    for j in jobs[8:]:
        core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
    outs = _step_to_end(core, outs)
    torch.cuda.synchronize()
    return dict(tokens={rid: o.token_ids for rid, o in outs.items()}, flushed=flushed,
                flush_s=flush_s, demoted=core.prefix_demotes - demotes,
                captures_wave1=captures)


def _pressure_serve(core, jobs, gen: int) -> dict:
    """The jobs at once on ``core``, whose pool they outgrow: the allocator
    evicts cached pages during admission and page growth, with dispatches
    in flight. Times each demote's host time (its gather waits for every
    dispatch queued before it) and notes the rows preempted and the rows
    that promoted host pages."""
    timed, demote = [], core._demote_page
    preempted, preempt = set(), core.scheduler.preempt
    promoted, promote = set(), core._promote_host_pages

    def on_demote(page, hashes):
        in_flight = core._dispatch_idx - core._processed_idx
        t0 = time.perf_counter()
        demote(page, hashes)
        timed.append((time.perf_counter() - t0, in_flight))

    def on_preempt(seq, **kw):
        preempted.add(seq.rid)
        return preempt(seq, **kw)

    def on_promote(admitted):
        promoted.update(seq.rid for seq in admitted if seq.host_restore)
        promote(admitted)

    core.scheduler.on_demote = on_demote
    core.scheduler.preempt = on_preempt
    core._promote_host_pages = on_promote
    reset_launches()
    for j in jobs:
        core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
    outs = _step_to_end(core, {})
    torch.cuda.synchronize()
    return dict(tokens={rid: o.token_ids for rid, o in outs.items()}, timed=timed,
                preempted=preempted, promoted=promoted, stats=core.stats(),
                launches=read_launches(), routes=read_routes())


def _pressure_demotes(params, cfg, jobs, gen: int, prefix_tokens) -> tuple:
    """Demotes with dispatches in flight, on a pool of ``PRESSURE_PAGES``
    with the host tier on: phase 4's 16 jobs in bf16 at full width, where
    every row never preempted gives phase 4's tokens and a row that parts
    (a preempted one re-prefills) parts at a near-tie; then the same
    serve in f32 on 2 layers on the exact routes, where all 16 rows give
    the tokens of a serve on a pool they do not outgrow with the tier off.
    Both serves must demote with dispatches in flight and promote.
    Returns (the record, its problems)."""
    problems = []
    core = _prefix_kv_engine(params, cfg, prefix_host_gb=PREFIX_HOST_GB,
                             num_pages=PRESSURE_PAGES)
    bf = _pressure_serve(core, jobs, gen)
    never = [j.id for j in jobs if j.id not in bf["preempted"]]
    unequal = [rid for rid in never if bf["tokens"][rid] != prefix_tokens[rid]]
    if unequal:
        problems.append(f"(a) pressure: rows never preempted part from phase 4's: {unequal}")
    parting = _parting_witness(core, jobs, bf["tokens"], prefix_tokens)
    for rid, w in parting.items():
        if (w["recompute_rank"] is None or max(w["phase3_rank"], w["recompute_rank"]) > 2
                or not w["gap_bf16_steps"] <= NEAR_TIE_ULPS):
            problems.append(f"(a) pressure: {rid} parts from phase 4's at {w['position']} at no "
                            f"near-tie: ranks {w['phase3_rank']} / {w['recompute_rank']}, gap "
                            f"{w['gap']} ({w['gap_bf16_steps']} bf16 steps)")
    del core
    gc.collect()
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from llmq_tpu_torch.models.convert import params_from_numpy

    pcfg, tree = _parity_config()
    p32 = params_from_numpy(tree)
    f32 = _pressure_serve(_prefix_kv_engine(p32, pcfg, dtype="float32",
                                            prefix_host_gb=PREFIX_HOST_GB,
                                            num_pages=PRESSURE_PAGES), jobs, gen)
    roomy = _pressure_serve(_prefix_kv_engine(p32, pcfg, dtype="float32"), jobs, gen)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    f32_equal = sum(f32["tokens"][j.id] == roomy["tokens"][j.id] for j in jobs)
    if f32_equal != len(jobs):
        problems.append(f"(a) pressure f32: {f32_equal} of {len(jobs)} rows equal the roomy "
                        f"serve's")
    problems += route_problems(f32["routes"], f32["launches"], route="exact")
    for name, r in (("bf16", bf), ("f32", f32)):
        if not any(n > 0 for _, n in r["timed"]):
            problems.append(f"(a) pressure {name}: no demote with dispatches in flight "
                            f"({len(r['timed'])} demotes)")
        if r["stats"]["prefix_promotes"] < 1:
            problems.append(f"(a) pressure {name}: no page promoted")
    if roomy["stats"]["preemptions"] or roomy["stats"]["prefix_demotes"]:
        problems.append(f"(a) the roomy f32 serve preempted {roomy['stats']['preemptions']} "
                        f"and demoted {roomy['stats']['prefix_demotes']}")
    ms = sorted(t * 1e3 for t, _ in bf["timed"])
    st = bf["stats"]
    rec = dict(pressure_pages=PRESSURE_PAGES, pressure_demotes=len(bf["timed"]),
               pressure_demote_ms_median=ms[len(ms) // 2] if ms else None,
               pressure_demote_ms_max=ms[-1] if ms else None,
               pressure_in_flight=[n for _, n in bf["timed"]],
               pressure_promotes=st["prefix_promotes"], pressure_preemptions=st["preemptions"],
               pressure_preempted_rows=sorted(bf["preempted"]),
               pressure_promoted_rows=sorted(bf["promoted"]),
               pressure_jobs_equal_phase4=sum(bf["tokens"][j.id] == prefix_tokens[j.id]
                                              for j in jobs),
               pressure_never_preempted_equal_phase4=len(never) - len(unequal),
               pressure_never_preempted=len(never), pressure_parting=parting,
               pressure_f32_2_layers_equal_roomy=f32_equal,
               pressure_f32_demotes=len(f32["timed"]),
               pressure_f32_in_flight=[n for _, n in f32["timed"]],
               pressure_f32_promotes=f32["stats"]["prefix_promotes"],
               pressure_f32_preemptions=f32["stats"]["preemptions"],
               pressure_f32_preempted_rows=sorted(f32["preempted"]),
               pressure_f32_promoted_rows=sorted(f32["promoted"]))
    return rec, problems


def _prefix_kv_host_tier(smi, cfg, params, prefix_tokens) -> dict:
    """Phase 12 (a) and (b). (a): phase 4's 16 jobs in two waves of 8 with
    the host tier on and a flush between: the second wave promotes the
    template's pages; tokens equal phase 4's, pools and captures in
    place; the same waves with the tier off for the prefill tokens. (b):
    the template's chunks exported from (a)'s engine and ingested into a
    second engine, whose serve of jobs 0-7 skips the template's prefill
    and gives phase 4's tokens. Returns (a)'s launches."""
    from llmq_tpu_torch.engine import prefix_store as prefix_mod
    from llmq_tpu_torch.utils.hashing import token_prefix_chain

    L, gen = cfg.num_layers, 64
    jobs = _prefix_jobs(16, gen)
    problems = []
    off = _prefix_kv_engine(params, cfg)
    cold = _two_waves(off, jobs, gen)
    cold_prefill = off.stats()["prefill_tokens"]
    del off
    gc.collect()
    torch.cuda.empty_cache()
    core = _prefix_kv_engine(params, cfg, prefix_host_gb=PREFIX_HOST_GB)
    promotes = _timed_promotes(core)
    ptrs = (core.k_pages.data_ptr(), core.v_pages.data_ptr())
    reset_launches()
    t0 = time.perf_counter()
    warm = _two_waves(core, jobs, gen)
    wall = time.perf_counter() - t0
    launches, routes = read_launches(), read_routes()
    st = core.stats()
    equal = sum(warm["tokens"].get(j.id) == prefix_tokens[j.id] for j in jobs)
    cold_equal = sum(cold["tokens"].get(j.id) == prefix_tokens[j.id] for j in jobs)
    problems += route_problems(routes, launches) + graph_problems(st)
    if equal != len(jobs):
        problems.append(f"(a) {equal} of {len(jobs)} jobs equal phase 4's tokens")
    if st["prefix_promotes"] < 1 or not promotes:
        problems.append(f"(a) no page promoted: {st['prefix_promotes']}")
    if st["cuda_graphs"]["captures"] != warm["captures_wave1"]:
        problems.append(f"(a) captures {warm['captures_wave1']} -> "
                        f"{st['cuda_graphs']['captures']} over the promotion")
    if (core.k_pages.data_ptr(), core.v_pages.data_ptr()) != ptrs:
        problems.append("(a) the promotion moved the KV pools")
    if not st["prefill_tokens"] < cold_prefill:
        problems.append(f"(a) prefill tokens {st['prefill_tokens']} not under the tier-off "
                        f"serve's {cold_prefill}")
    if launches["paged_prefill"] != L * st["prefill_dispatches"]:
        problems.append(f"(a) K3 {launches['paged_prefill']} != {L} x {st['prefill_dispatches']}")
    if launches["paged_decode_v3"] != L * (st["decode_steps"] + _warm(st)):
        problems.append(f"(a) K4 {launches['paged_decode_v3']} != {L} x ({st['decode_steps']} + "
                        f"{_warm(st)})")
    off_path = {k: launches[k] for k in ("paged_decode", "flash_prefill", "paged_decode_v2")}
    if any(off_path.values()):
        problems.append(f"(a) kernels off the prefix-cache path launched: {off_path}")
    promote_s = sum(t for t, _, _ in promotes)
    promote_bytes = sum(b for _, _, b in promotes)
    pressure, pressure_problems = _pressure_demotes(params, cfg, jobs, gen, prefix_tokens)
    problems += pressure_problems
    emit(dict(
        **pressure, phase="prefix_kv", part="a: host tier", model="preset://qwen2.5-3b", layers=L,
        decode_kernel=st["decode_kernel"], prefix_host_gb=PREFIX_HOST_GB,
        jobs_equal_phase4=equal, tier_off_jobs_equal_phase4=cold_equal,
        prefix_demotes=st["prefix_demotes"], pages_flushed=warm["flushed"],
        demote_ms_per_page=warm["flush_s"] * 1e3 / max(1, warm["demoted"]),
        prefix_promotes=st["prefix_promotes"], promote_waves=len(promotes),
        promote_ms=promote_s * 1e3, promote_bytes=promote_bytes,
        promote_gb_s=promote_bytes / promote_s / 1e9 if promote_s else None,
        prefill_tokens=st["prefill_tokens"], tier_off_prefill_tokens=cold_prefill,
        prefix_cache_hit_pages=st["prefix_cache_hit_pages"],
        host_tier={k: v for k, v in st.items() if k.startswith("prefix_host_")},
        captures_before=warm["captures_wave1"], captures_after=st["cuda_graphs"]["captures"],
        wall_s=wall, launches=launches, routes=routes,
        timing="demote: flush_prefix_to_host() between two synchronizes over the pages it "
               "demoted (one gather and one copy to pageable host memory a page and pool); "
               "promote: the wave's _promote_host_pages between two synchronizes (a concat "
               "on the host, one copy to the card and one index_copy_ a pool); pressure: "
               "each demote's host time inside the allocator, dispatches in flight",
        near_tie_limit_bf16_steps=NEAR_TIE_ULPS,
        note="pressure: a row never preempted must give phase 4's tokens; a preempted row "
             "re-prefills its generated positions (K3) where phase 4 wrote them a decode row "
             "at a time (K4), so in bf16 it may part, at a near-tie (ranks from 0 under a "
             "prefill of the shared context); in f32 on the exact routes all 16 rows must "
             "equal a serve on a pool they do not outgrow",
        card=smi, problems=problems))
    if problems:
        raise SystemExit("prefix_kv phase (a) failed: " + "; ".join(problems[:5]))
    a_launches = launches

    # (b) shipping: the template's chunks from (a)'s engine into a second engine
    # The template's pages: the first 1,024 positions' chain digests (a
    # chain covers only the full pages before a prompt's last position).
    page = core.cfg.page_size
    ids = core.tokenizer.encode(jobs[0].get_formatted_prompt())
    digests = [h.hex() for h in token_prefix_chain(ids, page)[: 1024 // page]]
    t0 = time.perf_counter()
    chunks = core.export_prefix_chunks(digests)
    export_s = time.perf_counter() - t0
    del core
    gc.collect()
    torch.cuda.empty_cache()
    dst = _prefix_kv_engine(params, cfg, prefix_host_gb=PREFIX_HOST_GB)
    t0 = time.perf_counter()
    ingested = dst.ingest_prefix_chunks(chunks)
    ingest_s = time.perf_counter() - t0
    reset_launches()
    for j in jobs[:8]:
        dst.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
    outs = _step_to_end(dst, {})
    torch.cuda.synchronize()
    launches, routes = read_launches(), read_routes()
    st = dst.stats()
    shipped = {rid: o.token_ids for rid, o in outs.items()}
    problems = route_problems(routes, launches) + graph_problems(st)
    equal = sum(shipped.get(j.id) == prefix_tokens[j.id] for j in jobs[:8])
    tails = sum(len(dst.tokenizer.encode(j.get_formatted_prompt())) - 1024 for j in jobs[:8])
    if len(chunks) != len(digests) or ingested != len(digests):
        problems.append(f"(b) {len(chunks)} chunks exported, {ingested} ingested, of "
                        f"{len(digests)}")
    if equal != 8:
        problems.append(f"(b) {equal} of 8 jobs equal phase 4's tokens")
    if st["prefill_tokens"] != tails or st["prefix_promotes"] != len(digests):
        problems.append(f"(b) prefill tokens {st['prefill_tokens']} (the tails: {tails}), "
                        f"promotes {st['prefix_promotes']}")
    chunk_bytes = [len(prefix_mod.chunk_from_b64(c)) for c in chunks]
    emit(dict(phase="prefix_kv", part="b: chunk shipping", chunks=len(chunks),
              ingested=ingested, chunk_bytes=chunk_bytes[0] if chunk_bytes else None,
              chunks_total_bytes=sum(chunk_bytes), export_ms=export_s * 1e3,
              ingest_ms=ingest_s * 1e3, jobs_equal_phase4=equal,
              prefill_tokens=st["prefill_tokens"], tail_tokens=tails,
              prefix_promotes=st["prefix_promotes"], launches=launches,
              timing="export: the host tier's entries to the chunk codec and base64; ingest: "
                     "base64 and the codec back (blake2b over every byte) into the host tier",
              card=smi, problems=problems))
    del dst
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise SystemExit("prefix_kv phase (b) failed: " + "; ".join(problems[:5]))
    return a_launches


def _adopted_serve(core, jobs, gen: int, *, solo: bool = False) -> tuple:
    """Every job's prompt phase alone (``prefill_only``): all waiting at
    once (prefill rows of 4), or with ``solo`` each prefilled alone, as a
    worker process takes a job that arrives by itself; then each snapshot
    inserted back into the same engine and decoded: the disaggregated path
    in one process. Returns (tokens, snapshots)."""
    done: dict = {}
    for j in jobs:
        core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen),
                         prefill_only=True)
        if solo:
            _step_to_end(core, done)
    _step_to_end(core, done)
    snaps = [done[j.id].snapshot for j in jobs]
    if any(o.finish_reason != "prefill_done" or o.token_ids for o in done.values()):
        raise SystemExit("prefix_kv phase (c): a prefill-only request did not stop at the "
                         "boundary")
    for s in snaps:
        core.insert_request(s)
    outs = _step_to_end(core, {})
    return {rid: o.token_ids for rid, o in outs.items()}, snaps


def _log_has(path: str, text: str) -> bool:
    with open(path) as f:
        return text in f.read()


def _worker_stats(log_path: str) -> dict:
    """The ``worker stats`` line a worker process logs as it stops, from a
    log of plain lines (``worker run``) or of JSON records (``worker
    pipeline``, ``utils/logging.py``)."""
    with open(log_path) as f:
        for line in reversed(f.readlines()):
            try:
                line = json.loads(line)["message"]
            except (ValueError, KeyError, TypeError):
                pass
            if "worker stats " in line:
                return json.loads(line.split("worker stats ", 1)[1])
    return {}


def _prefix_kv_disagg(smi, cfg, params, serve_tokens, solo_tokens) -> dict:
    """Phase 12 (c): a prefill-role and a decode-role worker process over
    phase 9's broker serve phase 3's 16 jobs at 32 tokens; in process, the
    same path in bf16 (K2 then K1, counted) witnesses each row that parts
    from phase 3's, and in f32 on 2 layers (exact routes) gives the
    unified run's tokens 16 of 16. Returns the in-process launches."""
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    n_jobs, gen, queue = 16, 32, "smoke-disagg"
    jobs = _default_jobs(n_jobs, gen)
    want = {j.id: serve_tokens[j.id][:gen] for j in jobs}
    penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    server = subprocess.Popen([sys.executable, "-c", _SERVER], cwd=root, env=penv,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    workers, rcs, problems, logs = [], [], [], {}
    try:
        url = f"tcp://127.0.0.1:{int(server.stdout.readline())}"
        asyncio.run(_submit(url, queue, jobs))
        starts = {}
        # The decode worker first, consuming before the prefill worker
        # starts: the handoff latency is then the road's, not a start-up race.
        for role in ("decode", "prefill"):
            logs[role] = os.path.join(OUT_DIR, f"disagg_{role}.log")
            starts[role] = time.perf_counter()
            with open(logs[role], "w") as log:
                workers.append(subprocess.Popen(
                    [sys.executable, "-m", "llmq_tpu_torch", "worker", "run",
                     "preset://qwen2.5-3b", queue, "--role", role, "--max-num-seqs", "16",
                     "--max-model-len", "512", "--dtype", "bfloat16"],
                    cwd=root, env=dict(penv, LLMQ_BROKER_URL=url, LLMQ_DECODE_KERNEL="v1",
                                 LLMQ_RESULT_DIGEST="1"),
                    stdout=log, stderr=subprocess.STDOUT))
            while role == "decode" and not _log_has(logs[role], "consuming"):
                if workers[0].poll() is not None or time.perf_counter() - starts[role] > 300:
                    raise SystemExit(f"prefix_kv phase (c): the decode worker did not start "
                                     f"(log: {logs[role]})")
                time.sleep(0.2)
        results = asyncio.run(_collect_results(url, queue, n_jobs, lambda: workers, 600))
        done = time.perf_counter()
        rcs = [_stop(w, signal.SIGTERM, 120) for w in workers]
    finally:
        for w in workers:
            _stop(w, signal.SIGKILL, 10)
        _stop(server, signal.SIGTERM, 10)
    dec, pre = _worker_stats(logs["decode"]), _worker_stats(logs["prefill"])
    ids = [r["id"] for r in results]
    if sorted(ids) != sorted(want):
        problems.append(f"(c) {len(results)} results, {len(set(ids))} unique ids")
    if rcs != [0, 0]:
        problems.append(f"(c) worker exit codes {rcs} (decode, prefill)")
    # Since M6's second part a prefill worker offers each job to the decode
    # worker first (as the reference's does); with the decode worker up,
    # every offer must be taken: a fallback to <q>.decode is a fault.
    roads = (pre.get("handoffs_shipped", 0), pre.get("handoffs_fallback", 0))
    if roads != (n_jobs, 0) or dec.get("jobs_adopted") != n_jobs:
        problems.append(f"(c) handoffs shipped / fallback {roads}, adopted "
                        f"{dec.get('jobs_adopted')}")
    if any(r["usage"]["completion_tokens"] != gen for r in results):
        problems.append("(c) a result without its 32 tokens")

    # In process, bf16 at full width: the same path, counted, and its tokens.
    core = _snapshot_engine(params, cfg)
    reset_launches()
    adopted, snaps = _adopted_serve(core, jobs, gen)
    torch.cuda.synchronize()
    launches, routes = read_launches(), read_routes()
    st = core.stats()
    L = cfg.num_layers
    problems += route_problems(routes, launches) + graph_problems(st)
    if launches["flash_prefill"] != L * st["prefill_dispatches"] or launches["flash_prefill"] < 1:
        problems.append(f"(c) K2 {launches['flash_prefill']} != {L} x {st['prefill_dispatches']}")
    if launches["paged_decode"] != L * (st["decode_steps"] + _warm(st)):
        problems.append(f"(c) K1 {launches['paged_decode']} != {L} x ({st['decode_steps']} + "
                        f"{_warm(st)})")
    tok = ByteTokenizer()
    got = {r["id"]: r.get("token_ids") for r in results}
    parting_ids = [j.id for j in jobs if adopted.get(j.id) != want[j.id]]
    if any(tok.decode(got[r["id"]] or []) != r["result"] for r in results):
        problems.append("(c) a result's text is not its token ids' text")
    # The prefill worker takes a job that arrives alone in a prefill of its
    # own (1 row, not 4): its adopted row is the in-process adoption of
    # jobs each prefilled alone, which parts from the solo run at a
    # near-tie as the batch adoption does from phase 3's.
    solo_want = {j.id: solo_tokens[j.id][:gen] for j in jobs}
    adopted_solo, _ = _adopted_serve(core, jobs, gen, solo=True)
    unwitnessed = [rid for rid, ids in got.items()
                   if ids not in (want[rid], adopted.get(rid), solo_want[rid],
                                  adopted_solo.get(rid))]
    if unwitnessed:
        problems.append(f"(c) worker rows parting from phase 3's, its solo run's and the "
                        f"in-process adoptions: {unwitnessed}")
    parting = _parting_witness(core, jobs, adopted, want)
    parting_solo = _parting_witness(core, jobs, adopted_solo, solo_want)
    for what, witnessed in (("phase 3's", parting), ("the solo run's", parting_solo)):
        for rid, w in witnessed.items():
            if (w["recompute_rank"] is None or max(w["phase3_rank"], w["recompute_rank"]) > 2
                    or not w["gap_bf16_steps"] <= NEAR_TIE_ULPS):
                problems.append(f"(c) adopted {rid} parts from {what} at {w['position']} at "
                                f"no near-tie: ranks {w['phase3_rank']} / "
                                f"{w['recompute_rank']}, gap {w['gap']} "
                                f"({w['gap_bf16_steps']} bf16 steps)")
    snap_bytes = [len(s.to_bytes()) for s in snaps]
    del core
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at 2 layers on the exact routes: adoption equals the unified run.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg, tree = _parity_config()
    f32 = _engine(pcfg, tree, torch.device("cuda"), max_num_seqs=16, max_model_len=512,
                  kv_dtype="f32")
    reset_launches()
    for j in jobs:
        f32.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
    whole = {rid: o.token_ids for rid, o in _step_to_end(f32, {}).items()}
    f32_adopted, _ = _adopted_serve(f32, jobs, gen)
    problems += route_problems(read_routes(), read_launches(), route="exact")
    f32_equal = sum(f32_adopted.get(j.id) == whole[j.id] for j in jobs)
    if f32_equal != n_jobs:
        problems.append(f"(c) f32: {f32_equal} of {n_jobs} adopted jobs equal the unified run's")
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(phase="prefix_kv", part="c: disaggregation over tcp://", broker=url,
              jobs=len(results), unique=len(set(ids)), worker_exit_codes=rcs,
              prefill_worker=pre, decode_worker=dec,
              handoff_ms_p50=dec.get("handoff_ms_p50"), handoff_ms_p95=dec.get("handoff_ms_p95"),
              handoff_payload_bytes_per_job=pre.get("handoff_bytes", 0) / n_jobs,
              snapshot_bytes_per_job=sum(snap_bytes) / len(snap_bytes),
              wall_from_prefill_start_s=done - starts["prefill"],
              wall_from_decode_start_s=done - starts["decode"],
              worker_tokens_equal_phase3=sum(ids == want[r] for r, ids in got.items()),
              worker_tokens_equal_solo=sum(ids == solo_tokens[r][:gen] for r, ids in got.items()),
              worker_tokens_equal_in_process=sum(ids == adopted.get(r) for r, ids in got.items()),
              worker_tokens_equal_in_process_solo=sum(ids == adopted_solo.get(r)
                                                      for r, ids in got.items()),
              prefill_worker_prefill_dispatches=pre.get("kernel_launches", {}).get(
                  "flash_prefill_attention_cuda", {}).get("launches", 0) // cfg.num_layers,
              bf16_solo_adopted_parting={rid: w["position"] for rid, w in parting_solo.items()},
              bf16_in_process_equal_phase3=n_jobs - len(parting_ids),
              bf16_parting=parting, near_tie_limit_bf16_steps=NEAR_TIE_ULPS,
              bf16_launches=launches, f32_2_layers_adopted_equal_unified=f32_equal,
              timing="wall: from a worker process's start (its engine build included) to the "
                     "16th result, the decode worker consuming before the prefill worker starts; "
                     "handoff: the prefill worker's stamp before its offer to the decode "
                     "worker's start of the job, after the offer's reply, the publish to "
                     "<q>.d.<id>, its delivery, parse and snapshot decode (wall clocks of one "
                     "host); payload: the JSON job with its base64 snapshot",
              note="bf16: the adopted row computes its last prompt position in a decode step "
                   "(K1), where phase 3 computed it in the prefill (K2 and a many-row "
                   "projection); a row that parts must part at a near-tie (ranks from 0 under a "
                   "prefill of the shared context)",
              card=smi, problems=problems))
    if problems:
        raise SystemExit("prefix_kv phase (c) failed: " + "; ".join(problems[:5]))
    return launches


def phase_prefix_kv(smi: str, serve_tokens: dict, solo_tokens: dict,
                    prefix_tokens: dict) -> dict:
    """Phase 12, the prefix-KV plane (M11b) at full width: qwen2.5-3b,
    bf16, phase 3's seeded weights; parts (a)-(c). Returns the launches of
    (a) (K3, K4) and of (c)'s in-process adoption (K1, K2)."""
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    t0 = time.perf_counter()
    cfg = get_preset("qwen2.5-3b")
    # build_engine's draw for preset://qwen2.5-3b at seed 0: phase 3's weights
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
                         device=torch.device("cuda"))
    a = _prefix_kv_host_tier(smi, cfg, params, prefix_tokens)
    c = _prefix_kv_disagg(smi, cfg, params, serve_tokens, solo_tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(phase="prefix_kv", part="total", seconds=time.perf_counter() - t0))
    return dict(paged_prefill=a["paged_prefill"], paged_decode_v3=a["paged_decode_v3"],
                paged_decode=c["paged_decode"], flash_prefill=c["flash_prefill"])


# --- phase 13: the failure policy at full width -------------------------------

#: (a)'s chaos: a connection kill every 29th client operation (publish,
#: settle, get), a duplicate of every 7th delivery, seeded. The 16 jobs
#: make ~32 operations and the slow part ~8 before them, so one kill lands
#: among the jobs and no job is in flight across two: each kill redelivers
#: the jobs in flight, and a copy's delivery count is also the attempt
#: count that quarantine reads (2 here), as in the reference.
POLICY_CHAOS = "kill_every=29&dup_every=7&seed=13"
#: (a)'s job timeout: well above a job's ~0.5 s to result at phase 3's
#: settings (16 rows, ~200-token prompts, 32 tokens), and at most 1/2.6 of
#: the slow job's decode, whose timed-out requests keep decoding (neither
#: engine aborts them) and must not finish before its second attempt ends.
POLICY_JOB_TIMEOUT_S = 1.1
#: What ``setup_queue_infrastructure`` and ``BaseWorker.initialize``
#: (``llmq_tpu/broker/manager.py:253-291``, ``llmq_tpu/workers/base.py:
#: 203-209``) declare with LLMQ_MAX_REDELIVERIES=7 LLMQ_JOB_TTL_MINUTES=5:
#: each queue's meta.json in the file broker's directory (none: no meta).
FILE_POLICY = {"": {"ttl_ms": 300_000, "max_redeliveries": 7},
               ".results": {"max_redeliveries": 1_000_000_000}, ".failed": None,
               ".interactive": {"ttl_ms": 300_000, "max_redeliveries": 7},
               ".health": {"ttl_ms": 120_000, "max_redeliveries": 1_000_000_000}}


def _rows_held(core) -> int:
    return sum(s is not None for s in core.scheduler.slots)


async def _policy_serve(engine, url: str, queue: str, jobs: list, slow, timeout_s: float,
                        idle_timeout_s: float = 60.0, probe=None) -> dict:
    """Phase 13 (a) on a running broker: the slow job alone first, in a
    stretch the chaos leaves alone, until it is quarantined; a heartbeat
    read back; the 16 jobs under the chaos. Returns what was seen."""
    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.workers import base as worker_base
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    plain = BrokerManager(Config(broker_url=url, max_redeliveries=1000))
    await plain.connect()
    worker = TorchWorker(queue, engine, config=Config(
        broker_url=f"chaos+{url}?{POLICY_CHAOS}", max_redeliveries=1000, quarantine_attempts=2,
        job_timeout_s=timeout_s, reconnect_base_delay_s=0.05, reconnect_max_delay_s=0.5,
        result_digest=True))
    out = dict(quarantine=[], results={}, received=0)
    worker_base.HEARTBEAT_INTERVAL_S = 3600.0  # one beat at the start, none in the slow part
    await plain.publish_job(queue, slow)
    if probe is not None:
        probe()
    t0 = time.perf_counter()
    task = asyncio.create_task(worker.run())
    chaos = None

    async def until(what: str, done, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while not await done():
            if time.monotonic() > deadline or task.done():
                state = dict(worker_done=task.done(), quarantine=[m for m, _ in out["quarantine"]],
                             results=sorted(out["results"]), rows=_rows_held(engine.core),
                             processed=worker.jobs_processed, failed=worker.jobs_failed,
                             timed_out=worker.jobs_timed_out)
                raise SystemExit(f"failure_policy (a): {what} ({state}; log: "
                                 f"failure_policy_worker.log in {OUT_DIR})")
            await asyncio.sleep(0.01)

    async def slow_quarantined() -> bool:
        msg = await plain.broker.get(queue + ".quarantine")
        if msg is not None:
            out["quarantine"].append((msg.message_id, msg.headers))
            await msg.ack()
        return any(mid == slow.id for mid, _ in out["quarantine"])

    try:
        await until("the slow job was never quarantined", slow_quarantined)
        out["slow_quarantined_s"] = time.perf_counter() - t0
        chaos = worker.broker.broker.inner
        out["slow_part_chaos"] = dict(ops=chaos._ops, deliveries=chaos._deliveries,
                                      kills=chaos.kills, duplicates=chaos.duplicates)
        worker_base.HEARTBEAT_INTERVAL_S = 0.5

        async def beat() -> bool:
            health = (await plain.get_worker_health(queue)).get(worker.worker_id)
            if health is None or not (health.engine_stats or {}).get("jobs_quarantined"):
                return False
            out["heartbeat"] = health.model_dump(mode="json")
            return True

        await until("no heartbeat carried jobs_quarantined", beat, 30)

        # The slow job's request keeps decoding after its attempts timed
        # out (neither engine aborts it; the second attempt joined it):
        # the 16 jobs start on an idle engine.
        async def idle() -> bool:
            return _rows_held(engine.core) == 0

        await until("the slow job's request never ran out", idle, idle_timeout_s)
        out["slow_rows_done_s"] = time.perf_counter() - t0
        # The engine is held while the 16 jobs arrive, so they are admitted
        # together and prefilled four to a dispatch, as in phase 3: a job
        # that arrived alone would be prefilled as one row, another matmul
        # shape, whose bf16 rounding can flip a near-tie.
        held, gate = threading.Event(), threading.Event()
        prefills = engine.core.prefill_dispatches

        def hold() -> None:
            held.set()
            gate.wait(60)

        holder = threading.Thread(target=engine.call_on_engine, args=(hold, 90))
        holder.start()
        t1 = time.perf_counter()
        try:
            held.wait(30)
            for job in jobs:
                await plain.publish_job(queue, job)

            async def submitted() -> bool:
                return len(engine._futures) >= len(jobs)

            await until("the jobs did not all reach the engine", submitted, 60)
        finally:
            gate.set()
            holder.join(90)

        async def answered() -> bool:
            msg = await plain.broker.get(queue + ".results")
            if msg is not None:
                r = json.loads(msg.body)
                out["received"] += 1
                out["results"].setdefault(r["id"], r)
                await msg.ack()
            return len(out["results"]) == len(jobs)

        await until("the jobs were not all answered", answered, 300)
        out["serve_wall_s"] = time.perf_counter() - t1
        out["jobs_prefill_dispatches"] = engine.core.prefill_dispatches - prefills
        out["session"] = dict(worker.broker.session_stats.as_dict(), kills=chaos.kills,
                              duplicates=chaos.duplicates)
    finally:
        worker.request_shutdown()
        await asyncio.wait_for(task, timeout=120)
    while (msg := await plain.broker.get(queue + ".quarantine")) is not None:
        out["quarantine"].append((msg.message_id, msg.headers))
        await msg.ack()
    out["failed"] = (await plain.get_queue_stats(queue + ".failed")).message_count
    out["counters"] = {k: getattr(worker, k) for k in (
        "jobs_processed", "jobs_failed", "jobs_timed_out", "jobs_quarantined",
        "jobs_deadline_exceeded", "breaker_tripped")}
    out["worker_id"] = worker.worker_id
    await plain.disconnect()
    return out


def _failure_policy_chaos(smi, serve_tokens: dict, tcp_rec: dict) -> dict:
    """Phase 13 (a): a ``TorchWorker`` in this process over
    ``chaos+tcp://`` to phase 9's ``BrokerServer`` process, at phase 3's
    settings and weights."""
    from llmq_tpu_torch.cli.worker import build_engine
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.engine.sampling import SamplingParams

    root = os.path.dirname(os.path.abspath(__file__))
    n_jobs, gen, queue, max_model_len = 16, 32, "smoke-policy", 512
    penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    server = subprocess.Popen([sys.executable, "-c", _SERVER], cwd=root, env=penv,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    # The in-process worker's and broker session's log lines.
    log = logging.FileHandler(os.path.join(OUT_DIR, "failure_policy_worker.log"), mode="w")
    log.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    for name in ("worker", "llmq_tpu_torch"):
        logging.getLogger(name).addHandler(log)
        logging.getLogger(name).setLevel(logging.INFO)
    engine = None
    try:
        url = f"tcp://127.0.0.1:{int(server.stdout.readline())}"
        with env(LLMQ_DECODE_KERNEL="v1"):
            engine = build_engine("preset://qwen2.5-3b", device="cuda", dtype="bfloat16",
                                  max_num_seqs=16, max_model_len=max_model_len)
        # Warm-up (the decode graph's capture), then the step the slow job
        # is sized from: 64 more tokens of one request.
        times = {}
        for i, n in enumerate((8, 8, 72)):
            t = time.perf_counter()
            engine.generate_sync(rid=f"warm-{i}", prompt="warm up", timeout=300,
                                 params=SamplingParams(temperature=0.0, max_tokens=n,
                                                       ignore_eos=True))
            times[n] = time.perf_counter() - t
        step_s = (times[72] - times[8]) / 64
        if step_s <= 0:
            raise SystemExit(f"failure_policy (a): decode step measured {step_s * 1e3:.3f} ms")
        slow_tokens = max_model_len - 64
        timeout_s = min(POLICY_JOB_TIMEOUT_S, slow_tokens * step_s / 2.6)
        slow = Job(id="slow", prompt="Count slowly.", temperature=0.0, max_tokens=slow_tokens,
                   ignore_eos=True)
        jobs = _default_jobs(n_jobs, gen)
        seen = asyncio.run(_policy_serve(engine, url, queue, jobs, slow, timeout_s,
                                         idle_timeout_s=max(60.0, 4 * slow_tokens * step_s),
                                         probe=reset_launches))
        launches, routes = read_launches(), read_routes()
        stats = engine.core.stats()
    finally:
        if engine is not None:
            engine.shutdown()
        _stop(server, signal.SIGTERM, 10)
        for name in ("worker", "llmq_tpu_torch"):
            logging.getLogger(name).removeHandler(log)
        log.close()
    problems = []
    results = [seen["results"][j.id] for j in jobs if j.id in seen["results"]]
    problems += _check_results(results, n_jobs, gen)
    for r in results:
        want = serve_tokens.get(r["id"], [])[:gen]
        if r.get("token_ids") != want:
            at = next((i for i, (a, b) in enumerate(zip(r.get("token_ids") or [], want))
                       if a != b), None)
            problems.append(f"{r['id']}: tokens differ from phase 3's first {gen} (at {at})")
    slow_entries = [h for mid, h in seen["quarantine"] if mid == "slow"]
    if [(h.get("x-failure-reason"), h.get("x-delivery-count")) for h in slow_entries] != \
            [("timeout", 2)]:
        problems.append(f"the slow job's quarantine entries: {slow_entries}")
    if seen["failed"]:
        problems.append(f"{seen['failed']} message(s) on {queue}.failed")
    if seen["session"]["reconnects"] < 1:
        problems.append(f"no reconnect: {seen['session']}")
    beat = seen.get("heartbeat") or {}
    if beat.get("worker_id") != seen["worker_id"] or beat.get("status") != "running" or \
            beat.get("engine_stats", {}).get("jobs_quarantined") != 1:
        problems.append(f"heartbeat: {beat}")
    problems += route_problems(routes, launches) + graph_problems(stats)
    if launches["paged_decode"] <= 0 or launches["flash_prefill"] <= 0:
        problems.append(f"a kernel did not launch on the main path: {launches}")
    off_path = {k: n for k, n in launches.items() if k not in ("paged_decode", "flash_prefill")}
    if any(off_path.values()):
        problems.append(f"kernels off the default path launched: {off_path}")
    gen_tokens = sum(r["usage"]["completion_tokens"] for r in results)
    others = sorted({mid for mid, _ in seen["quarantine"] if mid != "slow"})
    emit(dict(phase="failure_policy", part="a: worker under chaos+tcp://", chaos=POLICY_CHAOS,
              job_timeout_s=timeout_s, step_ms=step_s * 1e3, slow_max_tokens=slow_tokens,
              slow_quarantined_s=seen["slow_quarantined_s"],
              slow_rows_done_s=seen["slow_rows_done_s"], slow_part_chaos=seen["slow_part_chaos"],
              slow_entries=slow_entries, quarantined_others=others,
              session=seen["session"], counters=seen["counters"],
              results=len(results), results_received=seen["received"],
              serve_wall_s=seen["serve_wall_s"],
              jobs_prefill_dispatches=seen["jobs_prefill_dispatches"],
              serve_completion_tok_s=gen_tokens / seen["serve_wall_s"],
              tcp_serve_completion_tok_s=tcp_rec.get("serve_completion_tok_s"),
              tcp_wall_s=tcp_rec.get("wall_s"), heartbeat=beat, launches=launches,
              routes=routes, cuda_graphs=stats["cuda_graphs"],
              timing="serve: the 16 jobs' publish to the 16th unique result, the engine warm; "
                     "phase 9's tcp figure includes its worker process's start",
              card=smi, problems=problems))
    if problems:
        raise SystemExit("failure_policy phase (a) failed: " + "; ".join(problems[:5]))
    return dict(paged_decode=launches["paged_decode"], flash_prefill=launches["flash_prefill"])


def _failure_policy_file(smi, serve_tokens: dict, solo_tokens: dict, tcp_rec: dict) -> None:
    """Phase 13 (b): ``python -m llmq_tpu_torch worker run`` as a process
    over ``file://`` with LLMQ_MAX_REDELIVERIES=7 LLMQ_JOB_TTL_MINUTES=5;
    phase 3's 16 jobs at 32 tokens and one unparseable body."""
    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.core.config import Config

    root = os.path.dirname(os.path.abspath(__file__))
    n_jobs, gen, queue = 16, 32, "smoke-file"
    broker_dir = os.path.join(root, "build", "policy_file_broker")
    shutil.rmtree(broker_dir, ignore_errors=True)
    url = f"file://{broker_dir}"
    garbage = b"\x00not a job {" + bytes(range(200, 216))
    jobs = _default_jobs(n_jobs, gen)

    async def submit() -> None:
        # Published, not declared: the worker's declaration sets each
        # queue's policy.
        mgr = BrokerManager(Config(broker_url=url))
        await mgr.connect()
        for job in jobs:
            await mgr.publish_job(queue, job)
        await mgr.broker.publish(queue, garbage, message_id="garbage",
                                 headers={"x-origin": "chip_smoke"})
        await mgr.disconnect()

    async def read(proc) -> tuple:
        mgr = BrokerManager(Config(broker_url=url))
        await mgr.connect()
        results, deadline = {}, time.monotonic() + 600
        while len(results) < n_jobs:
            if time.monotonic() > deadline or proc.poll() is not None:
                raise SystemExit(f"failure_policy (b): {len(results)} of {n_jobs} results, "
                                 f"worker exit code {proc.poll()} (log: failure_policy_file.log)")
            msg = await mgr.broker.get(queue + ".results")
            if msg is None:
                await asyncio.sleep(0.05)
                continue
            r = json.loads(msg.body)
            results.setdefault(r["id"], r)
            await msg.ack()
        wall = time.perf_counter() - t0
        dead = None
        for _ in range(200):
            if (dead := await mgr.broker.get(queue + ".failed")) is not None:
                break
            await asyncio.sleep(0.05)
        letter = None if dead is None else (dead.message_id, dead.body, dict(dead.headers))
        if dead is not None:
            await dead.ack()
        left = (await mgr.get_queue_stats(queue)).message_count
        await mgr.disconnect()
        return list(results.values()), wall, letter, left

    asyncio.run(submit())
    penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                LLMQ_BROKER_URL=url, LLMQ_MAX_REDELIVERIES="7", LLMQ_JOB_TTL_MINUTES="5",
                LLMQ_DECODE_KERNEL="v1", LLMQ_RESULT_DIGEST="1")
    log_path = os.path.join(OUT_DIR, "failure_policy_file.log")
    worker, problems = None, []
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log:
            worker = subprocess.Popen(
                [sys.executable, "-m", "llmq_tpu_torch", "worker", "run", "preset://qwen2.5-3b",
                 queue, "--max-num-seqs", "16", "--max-model-len", "512", "--dtype", "bfloat16"],
                cwd=root, env=penv, stdout=log, stderr=subprocess.STDOUT)
            results, wall, letter, left = asyncio.run(read(worker))
            rc = _stop(worker)
    finally:
        if worker is not None:
            _stop(worker, signal.SIGKILL, 10)
    metas = {}
    for suffix in FILE_POLICY:
        path = os.path.join(broker_dir, "queues", queue + suffix, "meta.json")
        metas[suffix] = json.load(open(path)) if os.path.exists(path) else None
    shutil.rmtree(broker_dir, ignore_errors=True)
    if metas != FILE_POLICY:
        problems.append(f"queue policies {metas}, want {FILE_POLICY}")
    if rc != 0:
        problems.append(f"worker exited {rc} on SIGTERM")
    problems += _check_results(results, n_jobs, gen)
    shapes = [_served_as(r.get("token_ids"), r["id"], gen, serve_tokens, solo_tokens)
              for r in results]
    problems += [f"{r['id']}: tokens differ from the first {gen} of phase 3's and of its solo "
                 f"run's" for r, shape in zip(results, shapes) if shape is None]
    headers = {} if letter is None else letter[2]
    if letter is None or letter[:2] != ("garbage", garbage):
        problems.append(f"the unparseable body's dead letter: {letter}")
    elif not (str(headers.get("x-error", "")).startswith("unparseable job payload: ")
              and headers.get("x-worker-id") and headers.get("x-death-queue") == queue
              and headers.get("x-origin") == "chip_smoke"
              and "x-failure-reason" not in headers):
        problems.append(f"dead-letter headers {headers}")
    if left:
        problems.append(f"{left} message(s) left on {queue}")
    emit(dict(phase="failure_policy", part="b: worker process over file://", broker=url,
              queue_policies=metas, dead_letter_headers=headers, jobs=len(results),
              prefilled_solo=shapes.count("solo"),
              time_to_16th_result_s=wall, tcp_wall_s=tcp_rec.get("wall_s"),
              timing="from the worker process's start, its engine build included, as phase 9's",
              worker_exit_code=rc, card=smi, problems=problems))
    if problems:
        raise SystemExit("failure_policy phase (b) failed: " + "; ".join(problems[:5]))


def phase_failure_policy(smi: str, serve_tokens: dict, solo_tokens: dict,
                         tcp_rec: dict) -> dict:
    """Phase 13, the broker manager and the worker's failure policy (M6's
    first part) at full width; parts (a) and (b). Returns (a)'s launches."""
    t0 = time.perf_counter()
    launches = _failure_policy_chaos(smi, serve_tokens, tcp_rec)
    gc.collect()
    torch.cuda.empty_cache()
    _failure_policy_file(smi, serve_tokens, solo_tokens, tcp_rec)
    emit(dict(phase="failure_policy", part="total", seconds=time.perf_counter() - t0))
    return launches


# --- phase 14: the client and a two-stage pipeline at full width -------------

# ``{token_digest}`` (``LLMQ_RESULT_DIGEST=1``) carries stage 1's token ids
# into stage 2's prompt: random weights emit mostly ids past 256, which the
# byte tokenizer's text drops, so ``{result}`` alone would not tell them.
PIPELINE_FORMAT = ("Format the following translation as clean markdown:\n\n{result}\n\n"
                   "(stage 1 tokens {token_digest})")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_listening(port: int, proc: subprocess.Popen, timeout: float = 60) -> None:
    import socket

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise SystemExit(f"nothing listens on port {port} (the process's exit code: {proc.poll()})")


def _read_lines(stream, lines: list) -> None:
    for line in stream:
        lines.append((time.perf_counter(), line))


def phase_pipeline(smi: str, serve_tokens: dict, solo_tokens: dict) -> dict:
    """Phase 14: the port's ``broker serve``, two ``worker pipeline``
    processes (one a stage of a two-stage pipeline of ``tpu`` workers over
    qwen2.5-3b), ``submit -p`` of phase 3's 16 prompts (32 tokens) and
    ``receive -p --limit 16``, each a process of the port's command line.
    Returns each stage worker's K1 and K2 launches."""
    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.core.models import Result
    from llmq_tpu_torch.core.pipeline import load_pipeline_config
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params
    from llmq_tpu_torch.utils.hashing import token_fold

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    n_jobs, gen, stages = 16, 32, ("translate", "format")
    engine_cfg = {"model": "preset://qwen2.5-3b", "max_num_seqs": 16, "max_model_len": 512}
    pipe_path = os.path.join(OUT_DIR, "smoke-pipeline.json")
    with open(pipe_path, "w") as f:
        json.dump({"name": "smoke-pipeline", "stages": [
            {"name": stages[0], "worker": "tpu", "config": dict(engine_cfg, prompt="{text}")},
            {"name": stages[1], "worker": "tpu",
             "config": dict(engine_cfg, prompt=PIPELINE_FORMAT)}]}, f)
    jobs = _default_jobs(n_jobs, gen)
    rows_path = os.path.join(OUT_DIR, "smoke-pipeline-rows.jsonl")
    with open(rows_path, "w") as f:
        for j in jobs:
            f.write(json.dumps(dict(id=j.id, text=j.prompt, **j.extras())) + "\n")
    pipeline = load_pipeline_config(pipe_path)
    port = _free_port()
    url = f"tcp://127.0.0.1:{port}"
    penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                LLMQ_BROKER_URL=url, LLMQ_DECODE_KERNEL="v1", LLMQ_RESULT_DIGEST="1")
    cli = [sys.executable, "-m", "llmq_tpu_torch"]
    logs = {name: os.path.join(OUT_DIR, f"pipeline_{name}.log")
            for name in ("broker", *stages, "submit", "receive")}
    free_before = torch.cuda.mem_get_info()[0]
    procs, problems, lines = {}, [], []
    try:
        with open(logs["broker"], "w") as log:
            procs["broker"] = subprocess.Popen(
                cli + ["broker", "serve", "--host", "127.0.0.1", "--port", str(port)],
                cwd=root, env=penv, stdout=log, stderr=subprocess.STDOUT)
        _wait_listening(port, procs["broker"])
        t_start = time.perf_counter()
        for name in stages:
            with open(logs[name], "w") as log:
                procs[name] = subprocess.Popen(cli + ["worker", "pipeline", pipe_path, name],
                                               cwd=root, env=penv, stdout=log,
                                               stderr=subprocess.STDOUT)
        for name in stages:
            while not _log_has(logs[name], "consuming"):
                if procs[name].poll() is not None or time.perf_counter() - t_start > 300:
                    raise SystemExit(f"pipeline phase: the {name} worker did not start "
                                     f"(log: {logs[name]})")
                time.sleep(0.2)
        ready_s = time.perf_counter() - t_start
        with open(logs["receive"], "w") as err:
            procs["receive"] = subprocess.Popen(
                cli + ["receive", "-p", pipe_path, "--limit", str(n_jobs)], cwd=root, env=penv,
                stdout=subprocess.PIPE, stderr=err, text=True)
        reader = threading.Thread(target=_read_lines, args=(procs["receive"].stdout, lines),
                                  daemon=True)
        reader.start()
        t0 = time.perf_counter()
        with open(logs["submit"], "w") as log:
            submit_rc = subprocess.run(cli + ["submit", "-p", pipe_path, rows_path], cwd=root,
                                       env=penv, stdout=log, stderr=subprocess.STDOUT,
                                       timeout=300).returncode
        submit_s = time.perf_counter() - t0
        if submit_rc != 0:
            raise SystemExit(f"pipeline phase: submit exited {submit_rc} (log: {logs['submit']})")
        try:
            receive_rc = procs["receive"].wait(600)
        except subprocess.TimeoutExpired:
            raise SystemExit(f"pipeline phase: {len(lines)} of {n_jobs} results in 600 s "
                             f"(logs: {OUT_DIR}/pipeline_*.log)") from None
        reader.join(10)
        rcs = {name: _stop(procs[name], signal.SIGTERM, 120) for name in stages}
    finally:
        for proc in procs.values():
            _stop(proc, signal.SIGKILL, 10)
    results = [json.loads(line) for _, line in lines]
    wall = lines[-1][0] - t0 if lines else float("nan")
    worker_stats = {name: _worker_stats(logs[name]) for name in stages}

    if receive_rc != 0 or len(results) != n_jobs:
        problems.append(f"receive exited {receive_rc} with {len(results)} results")
    if rcs != {name: 0 for name in stages}:
        problems.append(f"stage worker exit codes on SIGTERM: {rcs}")
    problems += _check_results(results, n_jobs, gen)
    by_id = {r["id"]: r for r in results}
    if sorted(by_id) != sorted(j.id for j in jobs):
        problems.append(f"result ids {sorted(by_id)}")
    tok = ByteTokenizer()
    stage1_shapes, jobs2 = [], []
    for j in jobs:
        r = by_id.get(j.id)
        if r is None:
            continue
        for key, value in dict(text=j.prompt, **j.extras()).items():
            if r.get(key) != value:
                problems.append(f"{j.id}: extra {key} = {r.get(key)!r}, want {value!r}")
        # Stage 1's token ids reach the final result only as their digest
        # in stage 2's prompt: phase 3's first ``gen`` or its solo run's.
        shape = next((name for name, ref in (("batch", serve_tokens), ("solo", solo_tokens))
                      if f"tokens {token_fold(ref[j.id][:gen])})" in r["prompt"]), None)
        stage1_shapes.append(shape)
        if shape is None:
            problems.append(f"{j.id}: stage 1's token ids are neither phase 3's first {gen} "
                            f"nor its solo run's")
            continue
        ids1 = (serve_tokens if shape == "batch" else solo_tokens)[j.id][:gen]
        if r.get("previous_result") != tok.decode(ids1):
            problems.append(f"{j.id}: previous_result is not the text of stage 1's tokens")
        # The stage-1 result as the translate worker built it, for the
        # port's own hand-off to stage 2.
        stage1 = Result(id=j.id, prompt=j.prompt, result=tok.decode(ids1), worker_id="stage-1",
                        duration_ms=0.0, token_ids=ids1, token_digest=token_fold(ids1),
                        text=j.prompt, **j.extras())
        job2 = BrokerManager.build_next_stage_job(stage1, pipeline.stages[1])
        if job2.get_formatted_prompt() != r["prompt"]:
            problems.append(f"{j.id}: stage 2's prompt is not build_next_stage_job's")
        if r["result"] != tok.decode(r.get("token_ids") or []):
            problems.append(f"{j.id}: the result's text is not its token ids' text")
        jobs2.append(job2)

    # Stage 2's tokens against the engine in this process on the same
    # prompts: all waiting at once (4-row prefills), then each prefilled
    # alone. A worker process takes its jobs as stage 1 publishes them, so
    # a row may take either shape; a row equal to neither must part from
    # the solo run at a near-tie, as must each solo row from the batch run.
    cfg = get_preset("qwen2.5-3b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
                         device=torch.device("cuda"))
    core = _snapshot_engine(params, cfg)
    for j in jobs2:
        core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
    batch2 = {rid: list(o.token_ids) for rid, o in _step_to_end(core, {}).items()}
    outs: dict = {}
    for j in jobs2:
        core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
        outs.update({o.rid: o for o in core.step()})
    solo2 = {rid: list(o.token_ids) for rid, o in _step_to_end(core, outs).items()}
    got2 = {j.id: by_id[j.id].get("token_ids") for j in jobs2}
    stage2_shapes = [next((name for name, ref in (("batch", batch2), ("solo", solo2))
                           if got2[j.id] == ref[j.id]), None) for j in jobs2]
    neither = [j for j, shape in zip(jobs2, stage2_shapes) if shape is None]
    solo_parting = _parting_witness(core, jobs2, solo2, batch2)
    parting = _parting_witness(core, neither, got2, solo2)
    for what, witnessed in (("the solo run", solo_parting), ("both runs", parting)):
        for rid, w in witnessed.items():
            if (w["recompute_rank"] is None or max(w["phase3_rank"], w["recompute_rank"]) > 2
                    or not w["gap_bf16_steps"] <= NEAR_TIE_ULPS):
                problems.append(f"stage 2 {rid} ({what}) parts at {w['position']} at no "
                                f"near-tie: ranks {w['phase3_rank']} / {w['recompute_rank']}, "
                                f"gap {w['gap']} ({w['gap_bf16_steps']} bf16 steps)")
    del core, params
    gc.collect()
    torch.cuda.empty_cache()

    launches = {}
    on_path = {KERNEL_COUNTERS[k][1]: k for k in ("paged_decode", "flash_prefill")}
    for name in stages:
        kl = worker_stats[name].get("kernel_launches", {})  # by wrapper name
        launches[name] = {k: kl.get(w, {}).get("launches", 0) for w, k in on_path.items()}
        for w, k in on_path.items():
            entry = kl.get(w)
            if not entry or entry["tensor_core"] != entry["launches"] or entry["exact"]:
                problems.append(f"{name} worker: {k} launches {entry} (want all on the "
                                f"tensor-core route)")
        off_path = sorted(set(kl) - set(on_path))
        if off_path:
            problems.append(f"{name} worker: kernels off the default path launched: {off_path}")
        if worker_stats[name].get("jobs_processed") != n_jobs:
            problems.append(f"{name} worker: {worker_stats[name]}")
    rate = {name: (worker_stats[name]["completion_tokens"] / worker_stats[name]["busy_s"]
                   if worker_stats[name].get("busy_s") else None) for name in stages}
    rec = dict(phase="pipeline", broker=url, pipeline=pipeline.name, jobs=len(results),
               unique=len(by_id), submit_to_16th_result_s=wall, submit_process_s=submit_s,
               workers_ready_s=ready_s, stage_completion_tok_s=rate,
               stage_busy_s={name: worker_stats[name].get("busy_s") for name in stages},
               stage1_equal_batch_run=stage1_shapes.count("batch"),
               stage1_prefilled_solo=stage1_shapes.count("solo"),
               stage2_equal_batch_run=stage2_shapes.count("batch"),
               stage2_equal_solo_run=stage2_shapes.count("solo"),
               stage2_solo_parts_from_batch={rid: w["position"]
                                             for rid, w in solo_parting.items()},
               stage2_parting_from_both={rid: w["position"] for rid, w in parting.items()},
               stage2_max_gap_bf16_steps=max((w["gap_bf16_steps"] for w in
                                              (*solo_parting.values(), *parting.values())),
                                             default=0),
               worker_exit_codes=rcs, worker_stats=worker_stats,
               free_device_bytes_before=free_before, seconds=time.perf_counter() - t_phase,
               stage2_distinct_prompts=len({j.get_formatted_prompt() for j in jobs2}),
               timing="wall: from the start of the `submit -p` process to the 16th result line "
                      "read from the `receive -p` process (a client process starts Python and "
                      "imports no torch); "
                      "stage tok/s: a worker's completion tokens over its span from its first "
                      "job's start to its last result",
               card=smi, problems=problems)
    emit(rec)
    if problems:
        raise SystemExit("pipeline phase failed: " + "; ".join(problems[:5]))
    return launches


# --- phase 15: the peers' plane (M6's second part) at full width -------------


def _near_tie_problems(label: str, parting: dict) -> list:
    """Each row of ``_parting_witness`` must part at a near-tie."""
    return [f"{label} {rid} parts at {w['position']} at no near-tie: ranks {w['phase3_rank']} / "
            f"{w['recompute_rank']}, gap {w['gap']} ({w['gap_bf16_steps']} bf16 steps)"
            for rid, w in parting.items()
            if (w["recompute_rank"] is None or max(w["phase3_rank"], w["recompute_rank"]) > 2
                or not w["gap_bf16_steps"] <= NEAR_TIE_ULPS)]


async def _until(what: str, done, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not await done():
        if time.monotonic() > deadline:
            raise SystemExit(f"peers: {what}")
        await asyncio.sleep(0.01)


async def _results_of(mgr, queue: str, n: int, results: dict, timeout: float = 300.0) -> None:
    """Read ``<queue>.results`` until ``results`` holds ``n`` ids."""
    async def enough() -> bool:
        msg = await mgr.broker.get(queue + ".results")
        if msg is not None:
            r = json.loads(msg.body)
            results.setdefault(r["id"], r)
            await msg.ack()
        return len(results) >= n

    await _until(f"{len(results)} of {n} results on {queue}.results", enough, timeout)


async def _peers_affinity(url: str, cfg, params) -> dict:
    """Phase 15 (a) on a running broker: worker A serves 8 templated jobs
    from the shared queue and advertises its chains; an affinity submitter
    publishes 8 more, which must all land on A's private queue; then A
    leaves the shared queue (its KV server stays) and a fresh worker B
    takes a templated job from it, fetching A's pages before it prefills."""
    from llmq_tpu_torch.broker.manager import BrokerManager, affinity_queue_name
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.engine.engine import AsyncEngine
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    queue, gen = "smoke-peers", 32
    jobs = _prefix_jobs(16, gen)
    cold_job = jobs[0].model_copy(update={"id": "pfx-on-b"})  # pfx-00's prompt, served by B

    def worker(wid: str) -> TorchWorker:
        core = _prefix_kv_engine(params, cfg, prefix_host_gb=PREFIX_HOST_GB)
        return TorchWorker(queue, AsyncEngine(core), worker_id=wid, config=Config(
            broker_url=url, prefix_affinity=True, max_redeliveries=1000, result_digest=True))

    plain = BrokerManager(Config(broker_url=url, max_redeliveries=1000))
    submitter = BrokerManager(Config(broker_url=url, prefix_affinity=True))
    await plain.connect()
    await submitter.connect()
    a, b = worker("peer-a"), worker("peer-b")
    private = []
    claim = a._process_affinity_message

    async def counted(message) -> None:
        private.append(message.message_id)
        await claim(message)

    a._process_affinity_message = counted
    out, results, tasks = {}, {}, []
    try:
        reset_launches()
        t0 = time.perf_counter()
        tasks.append(asyncio.create_task(a.run()))
        for job in jobs[:8]:
            await plain.publish_job(queue, job)
        await _results_of(plain, queue, 8, results)
        await a._publish_heartbeat()  # the advertisement, not the 30 s cadence
        out["advertised"] = a._prefix_chains()
        t1 = time.perf_counter()
        for job in jobs[8:]:
            await submitter.publish_job(queue, job)
        await _results_of(plain, queue, 16, results)
        out["routed_wall_s"] = time.perf_counter() - t1
        out["a_wall_s"] = time.perf_counter() - t0
        out["routed"] = dict(affinity_routed=submitter.affinity_routed,
                             affinity_fallback=submitter.affinity_fallback)
        out["claimed_from_private_queue"] = sorted(private)
        out["left_on_private_queue"] = (await plain.get_queue_stats(
            affinity_queue_name(queue, a.worker_id))).message_count
        await a._stop_role_consumers()  # A serves its KV RPC only from here
        fetch = b._fetch_from_peer
        timed = {}

        async def timed_fetch(peer, want, req_id) -> None:
            t = time.perf_counter()
            await fetch(peer, want, req_id)
            timed.update(peer=peer, wanted=len(want), ms=(time.perf_counter() - t) * 1e3)

        def timed_call(engine, name: str):
            call = getattr(engine, name)

            def run(chunks):
                t = time.perf_counter()
                try:
                    return call(chunks)
                finally:
                    timed[name + "_ms"] = (time.perf_counter() - t) * 1e3

            setattr(engine, name, run)

        b._fetch_from_peer = timed_fetch
        timed_call(a.engine, "export_prefix_chunks")  # on A's engine thread
        timed_call(b.engine, "ingest_prefix_chunks")
        tasks.append(asyncio.create_task(b.run()))
        t2 = time.perf_counter()
        await plain.publish_job(queue, cold_job)
        await _results_of(plain, queue, 17, results)
        out["b_wall_s"] = time.perf_counter() - t2
        out["fetch"] = timed
    finally:
        for w in (a, b):
            w.request_shutdown()
        await asyncio.wait_for(asyncio.gather(*tasks), timeout=120)
        await plain.disconnect()
        await submitter.disconnect()
    out.update(results=results, a=a, b=b, jobs=jobs, cold_job=cold_job)
    return out


def _cold_prefill_ms(cfg, params, job) -> tuple:
    """What B's fetch stands in for: an engine of B's settings with empty
    caches, warmed on a prompt of the same length that shares no page,
    prefills the job's prompt; (ms from its admission to its first token,
    synchronized; the tokens it prefilled)."""
    core = _prefix_kv_engine(params, cfg, prefix_host_gb=PREFIX_HOST_GB)
    prompt = job.get_formatted_prompt()
    core.add_request("warm", prompt=prompt[::-1], params=_greedy(1))
    _step_to_end(core, {})
    before = core.stats()["prefill_tokens"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    core.add_request(job.id, prompt=prompt, params=_greedy(1))
    _step_to_end(core, {})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    tokens = core.stats()["prefill_tokens"] - before
    core.close()
    return ms, tokens


def _peers_affinity_part(smi, cfg, params, url: str) -> dict:
    """Phase 15 (a): checks and record; returns K3's and K4's launches."""
    from llmq_tpu_torch.workers import torch_worker

    seen = asyncio.run(_peers_affinity(url, cfg, params))
    launches, routes = read_launches(), read_routes()
    torch.cuda.synchronize()
    a, b, jobs, cold_job, results = (seen[k] for k in ("a", "b", "jobs", "cold_job", "results"))
    ca, cb = a.engine.core, b.engine.core
    sa, sb = ca.stats(), cb.stats()
    L = cfg.num_layers
    problems = _check_results([results[j.id] for j in jobs if j.id in results], 16, 32)
    if seen["routed"] != dict(affinity_routed=8, affinity_fallback=0):
        problems.append(f"(a) routing: {seen['routed']}")
    if seen["claimed_from_private_queue"] != sorted(j.id for j in jobs[8:]) or \
            seen["left_on_private_queue"]:
        problems.append(f"(a) A's private queue gave {seen['claimed_from_private_queue']}, "
                        f"{seen['left_on_private_queue']} left")
    if any(results[j.id]["worker_id"] != a.worker_id for j in jobs if j.id in results):
        problems.append("(a) a templated job was not served by A")
    got_b = results.get(cold_job.id, {})
    if got_b.get("worker_id") != b.worker_id:
        problems.append(f"(a) the job on the shared queue went to {got_b.get('worker_id')}")
    prompt_tokens = got_b.get("usage", {}).get("prompt_tokens", 0)
    fetched = b.prefix_chunks_fetched
    if not (fetched > 0 and sb["prefix_promotes"] >= fetched
            and sb.get("prefix_cache_hit_pages", 0) >= fetched
            and sb["prefill_tokens"] < prompt_tokens):
        problems.append(f"(a) B fetched {fetched} chunks, promoted {sb['prefix_promotes']}, hit "
                        f"{sb.get('prefix_cache_hit_pages')} pages, prefilled "
                        f"{sb['prefill_tokens']} of {prompt_tokens} tokens")
    if seen["fetch"].get("peer") != a.worker_id:
        problems.append(f"(a) B's fetch: {seen['fetch']}")
    problems += route_problems(routes, launches)
    for st in (sa, sb):
        problems += graph_problems(st)
    chunks = sa["prefill_dispatches"] + sb["prefill_dispatches"]
    steps = sa["decode_steps"] + _warm(sa) + sb["decode_steps"] + _warm(sb)
    if launches["paged_prefill"] != L * chunks or launches["paged_decode_v3"] != L * steps:
        problems.append(f"(a) K3 {launches['paged_prefill']} != {L} x {chunks} or K4 "
                        f"{launches['paged_decode_v3']} != {L} x {steps}")
    off_path = {k: launches[k] for k in ("paged_decode", "flash_prefill", "paged_decode_v2")}
    if any(off_path.values()):
        problems.append(f"(a) kernels off the prefix-cache path launched: {off_path}")
    on_a = results.get(jobs[0].id, {}).get("token_ids")
    on_b = got_b.get("token_ids")
    parting = {}
    if on_b != on_a:
        witness_job = cold_job.model_copy(update={"id": jobs[0].id})
        parting = _parting_witness(cb, [witness_job], {jobs[0].id: on_b}, {jobs[0].id: on_a})
        problems += _near_tie_problems("(a) B's", parting)
    a_stats, b_stats = a.stats(), b.stats()
    for w in (a, b):
        w.engine.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    local_ms, local_tokens = _cold_prefill_ms(cfg, params, cold_job)
    fetch_ms = seen["fetch"].get("ms")
    emit(dict(phase="peers", part="a: affinity routing and prefix shipping", broker=url,
              results=len(results), routed=seen["routed"],
              claimed_from_private_queue=len(seen["claimed_from_private_queue"]),
              advertised_chains=len(seen["advertised"] or []),
              b_fetch=seen["fetch"], fetch_timeout_s=torch_worker.PREFIX_FETCH_TIMEOUT_S,
              local_prefill_ms=local_ms, local_prefill_tokens=local_tokens,
              fetch_beats_local_prefill=fetch_ms is not None and fetch_ms < local_ms,
              note="B must fetch (the slice's road) within the worker's default timeout; the "
                   "fetch is not held to beat the local prefill, which it does not at this "
                   "size on this card (PERF.md, PR 13)",
              b_prefix_chunks_fetched=fetched,
              a_prefix_chunks_served=a.prefix_chunks_served,
              b_prefix_promotes=sb["prefix_promotes"],
              b_prefix_hit_pages=sb.get("prefix_cache_hit_pages"),
              b_prefill_tokens=sb["prefill_tokens"], cold_prefill_tokens=prompt_tokens,
              b_equal_a=on_b == on_a, b_parting=parting,
              near_tie_limit_bf16_steps=NEAR_TIE_ULPS,
              a_wall_s=seen["a_wall_s"], routed_wall_s=seen["routed_wall_s"],
              b_wall_s=seen["b_wall_s"], a_worker=a_stats, b_worker=b_stats,
              launches=launches, routes=routes,
              timing="a_wall: A's start (its first capture included) to its 16th result; "
                     "routed_wall: the affinity submitter's first publish to the 16th result; "
                     "b_wall: the job's publish to B's result, B's fetch included; "
                     "b_fetch.ms: B's request to its ingest's end, at the worker's default "
                     "timeout; its export_ms on A's engine and ingest_ms on B's are parts of "
                     "it; local_prefill_ms: an engine of B's settings with empty caches, "
                     "warmed, from the job's admission to its first token (what the fetch "
                     "stands in for); cold_prefill_tokens: the prompt's tokens",
              card=smi, problems=problems))
    if problems:
        raise SystemExit("peers phase (a) failed: " + "; ".join(problems[:5]))
    return dict(paged_prefill=launches["paged_prefill"],
                paged_decode_v3=launches["paged_decode_v3"])


async def _peers_adoption(url: str, cfg, params, jobs, *, queue: str = "smoke-adopt",
                          ship: bool = True) -> dict:
    """Phase 15 (b) on a running broker: a decode worker beats first, then
    a prefill worker serves the jobs, offering each to the decode worker;
    with ``ship`` False the prefill worker makes no offer, and every job
    takes the ``<q>.decode`` road (PR 10's) to the same decode worker."""
    from llmq_tpu_torch.broker.manager import BrokerManager, decode_adopt_queue_name
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.engine.engine import AsyncEngine
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    def worker(role: str) -> TorchWorker:
        return TorchWorker(queue, AsyncEngine(_snapshot_engine(params, cfg)),
                           worker_id=f"peers-{role}", config=Config(
                               broker_url=url, worker_role=role, max_redeliveries=1000,
                               result_digest=True))

    plain = BrokerManager(Config(broker_url=url, max_redeliveries=1000))
    await plain.connect()
    dec, pre = worker("decode"), worker("prefill")
    if not ship:
        async def no_offer(job, body) -> bool:
            return False

        pre._ship_to_decode_peer = no_offer
    out, results, tasks = {}, {}, []
    try:
        reset_launches()
        tasks.append(asyncio.create_task(dec.run()))

        async def decode_beats() -> bool:
            health = (await plain.get_worker_health(queue)).get(dec.worker_id)
            if health is not None and health.role == "decode":
                out["decode_heartbeat_role"] = health.role
                return True
            return False

        await _until("the decode worker's heartbeat never said role decode", decode_beats, 300)
        tasks.append(asyncio.create_task(pre.run()))
        t0 = time.perf_counter()
        for job in jobs:
            await plain.publish_job(queue, job)
        await _results_of(plain, queue, len(jobs), results)
        out["wall_s"] = time.perf_counter() - t0
        out["left"] = {name: (await plain.get_queue_stats(name)).message_count
                       for name in (decode_adopt_queue_name(queue, dec.worker_id),
                                    queue + ".decode")}
    finally:
        for w in (pre, dec):
            w.request_shutdown()
        await asyncio.wait_for(asyncio.gather(*tasks), timeout=120)
        await plain.disconnect()
    out.update(results=results, pre=pre, dec=dec)
    return out


def _peers_adoption_part(smi, cfg, params, url: str, serve_tokens, solo_tokens) -> dict:
    """Phase 15 (b): checks and record; returns K1's and K2's launches."""
    n_jobs, gen = 16, 32
    jobs = _default_jobs(n_jobs, gen)
    seen = asyncio.run(_peers_adoption(url, cfg, params, jobs))
    torch.cuda.synchronize()
    launches, routes = read_launches(), read_routes()
    pre, dec, results = seen["pre"], seen["dec"], seen["results"]
    sp, sd = pre.engine.core.stats(), dec.engine.core.stats()
    L = cfg.num_layers
    problems = _check_results(list(results.values()), n_jobs, gen)
    counts = (pre.handoffs_shipped, pre.handoffs_fallback, dec.jobs_adopted)
    if counts != (n_jobs, 0, n_jobs):
        problems.append(f"(b) shipped / fallback / adopted {counts}")
    if any(seen["left"].values()):
        problems.append(f"(b) left on the decode queues: {seen['left']}")
    if seen.get("decode_heartbeat_role") != "decode":
        problems.append("(b) the decode worker's heartbeat did not say role decode")
    problems += route_problems(routes, launches) + graph_problems(sd)
    if launches["flash_prefill"] != L * sp["prefill_dispatches"] or launches["flash_prefill"] < 1:
        problems.append(f"(b) K2 {launches['flash_prefill']} != {L} x {sp['prefill_dispatches']}")
    steps = sd["decode_steps"] + _warm(sd) + sp["decode_steps"] + _warm(sp)
    if launches["paged_decode"] != L * steps or launches["paged_decode"] < 1:
        problems.append(f"(b) K1 {launches['paged_decode']} != {L} x {steps}")
    off_path = {k: n for k, n in launches.items() if k not in ("paged_decode", "flash_prefill")}
    if any(off_path.values()):
        problems.append(f"(b) kernels off the disaggregated path launched: {off_path}")
    got = {rid: r.get("token_ids") for rid, r in results.items()}
    shapes = {rid: _served_as(ids, rid, gen, serve_tokens, solo_tokens)
              for rid, ids in got.items()}
    others = [j for j in jobs if shapes.get(j.id) is None]
    parting = _parting_witness(dec.engine.core, others, got,
                               {j.id: serve_tokens[j.id][:gen] for j in jobs})
    problems += _near_tie_problems("(b) adopted", parting)
    pre_stats, dec_stats = pre.stats(), dec.stats()
    for w in (pre, dec):
        w.engine.shutdown()
    # The same jobs through the <q>.decode road in this call, for comparison.
    pool = asyncio.run(_peers_adoption(url, cfg, params, jobs, queue="smoke-adopt-pool",
                                       ship=False))
    pool_counts = (pool["pre"].handoffs_shipped, pool["pre"].handoffs_fallback,
                   pool["dec"].jobs_adopted)
    if pool_counts != (0, n_jobs, n_jobs) or len(pool["results"]) != n_jobs:
        problems.append(f"(b) the <q>.decode road: shipped / fallback / adopted {pool_counts}, "
                        f"{len(pool['results'])} results")
    pool_stats = pool["dec"].stats()
    for w in (pool["pre"], pool["dec"]):
        w.engine.shutdown()
    emit(dict(phase="peers", part="b: direct adoption by a decode peer", broker=url,
              results=len(results), handoffs_shipped=counts[0], handoffs_fallback=counts[1],
              jobs_adopted=counts[2], left_on_decode_queues=seen["left"],
              handoff_ms_p50=dec_stats.get("handoff_ms_p50"),
              handoff_ms_p95=dec_stats.get("handoff_ms_p95"),
              pr10_decode_pool_handoff_s_median="1.83-2.39",
              decode_pool_road_same_call=dict(
                  handoff_ms_p50=pool_stats.get("handoff_ms_p50"),
                  handoff_ms_p95=pool_stats.get("handoff_ms_p95"), wall_s=pool["wall_s"],
                  equal_phase3=sum(r.get("token_ids") == serve_tokens[rid][:gen]
                                   for rid, r in pool["results"].items())),
              handoff_payload_bytes_per_job=pre.handoff_bytes / max(1, counts[0]),
              handoff_timeout_s=pre.config.handoff_timeout_s, wall_s=seen["wall_s"],
              equal_phase3=list(shapes.values()).count("batch"),
              equal_solo=list(shapes.values()).count("solo"),
              parting={rid: w["position"] for rid, w in parting.items()},
              max_gap_bf16_steps=max((w["gap_bf16_steps"] for w in parting.values()), default=0),
              near_tie_limit_bf16_steps=NEAR_TIE_ULPS,
              prefill_worker=pre_stats, decode_worker=dec_stats, launches=launches,
              routes=routes,
              timing="wall: the first job's publish to the 16th result, both engines built and "
                     "the decode worker beating; handoff: the prefill worker's stamp before its "
                     "offer to the decode worker's start of the job, after the offer's reply, "
                     "the publish to <q>.d.<id>, its delivery, parse and snapshot decode (wall "
                     "clocks of one host); PR 10's figure is the <q>.decode road between two "
                     "worker processes; decode_pool_road_same_call: the same jobs and settings in "
                     "this process with no offer made, every job through <q>.decode",
              card=smi, problems=problems))
    if problems:
        raise SystemExit("peers phase (b) failed: " + "; ".join(problems[:5]))
    return dict(paged_decode=launches["paged_decode"], flash_prefill=launches["flash_prefill"])


def phase_peers(smi: str, serve_tokens: dict, solo_tokens: dict) -> dict:
    """Phase 15, the peers' plane (M6's second part) at full width:
    qwen2.5-3b, bf16, phase 3's seeded weights, workers in this process
    over phase 9's ``BrokerServer`` process. Returns (a)'s K3 and K4
    launches and (b)'s K1 and K2 launches."""
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params
    from llmq_tpu_torch.workers import base as worker_base

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    server = subprocess.Popen([sys.executable, "-c", _SERVER], cwd=root, env=penv,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    log = logging.FileHandler(os.path.join(OUT_DIR, "peers_workers.log"), mode="w")
    log.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    for name in ("worker", "llmq_tpu_torch"):
        logging.getLogger(name).addHandler(log)
        logging.getLogger(name).setLevel(logging.INFO)
    interval = worker_base.HEARTBEAT_INTERVAL_S
    worker_base.HEARTBEAT_INTERVAL_S = 3600.0  # one beat at a worker's start; the rest by hand
    try:
        cfg = get_preset("qwen2.5-3b")
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
                             device=torch.device("cuda"))
        url = f"tcp://127.0.0.1:{int(server.stdout.readline())}"
        with env(LLMQ_PREFIX_AFFINITY="1"):
            a = _peers_affinity_part(smi, cfg, params, url)
        gc.collect()
        torch.cuda.empty_cache()
        b = _peers_adoption_part(smi, cfg, params, url, serve_tokens, solo_tokens)
    finally:
        worker_base.HEARTBEAT_INTERVAL_S = interval
        _stop(server, signal.SIGTERM, 10)
        for name in ("worker", "llmq_tpu_torch"):
            logging.getLogger(name).removeHandler(log)
        log.close()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(phase="peers", part="total", seconds=time.perf_counter() - t0))
    return {**a, **b}



# --- phase 16: the OpenAI gateway and the observability plane at full width --

GATEWAY_TRACE = ["submitted", "claimed", "tokenized", "admitted", "prefill_start", "first_token",
                 "decode", "finished"]


def _http(port: int, method: str, path: str, body=None, *, hang_up_after=None) -> dict:
    """One request to a local HTTP server: status, JSON body or the SSE
    frames, the seconds to the first frame and to the end; with
    ``hang_up_after``, the client closes after that many frames."""
    import http.client

    t0, sent_wall = time.perf_counter(), time.time()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = dict(status=resp.status, first_s=None, sent_wall=sent_wall)
    if resp.getheader("Content-Type") != "text/event-stream":
        raw = resp.read()
        try:
            out["body"] = json.loads(raw)
        except ValueError:
            out["body"] = raw.decode("utf-8", "replace")
    else:
        frames, buf = [], b""
        while hang_up_after is None or len(frames) < hang_up_after:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                if event.startswith(b"data: "):
                    if out["first_s"] is None:
                        out["first_s"] = time.perf_counter() - t0
                    text = event[6:].decode()
                    frames.append(text if text == "[DONE]" else json.loads(text))
        out["frames"] = frames
        out["text"] = "".join(f["choices"][0].get("text", "") for f in frames
                              if isinstance(f, dict))
    out["total_s"] = time.perf_counter() - t0
    resp.close()
    conn.close()
    return out


def _scrape(port: int) -> dict:
    """``/metrics`` as {series with labels: value}."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        body = resp.read().decode()
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            series, _, value = line.rpartition(" ")
            out[series] = float(value)
    return out


def _pct(values: list, q: float):
    if not values:
        return None
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def phase_gateway(smi: str, serve_tokens: dict, solo_tokens: dict) -> dict:
    """Phase 16: ``broker serve``, ``worker run`` of phase 3's weights as a
    checkpoint with ``write_text_tokenizer``'s tokenizer
    (``LLMQ_METRICS_PORT``, ``LLMQ_TRACE_LOG``) and ``serve`` as processes
    on tcp://; (a) phase 3's 16 prompts through the gateway, 8 blocking and
    8 streamed at once, then the other way round, and straight to the
    worker for their token ids; (b) a streamed request
    the client leaves after its first frame; (c) ``/metrics``, a chat request,
    ``/v1/models``, ``/healthz``; (d) ``trace`` of a job and ``monitor top
    --once``. Returns the worker's K1 and K2 launches."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from llmq_tpu_torch.broker.manager import BrokerManager
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.core.models import Job
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer, HFTokenizer
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    # Phase 3's weights (build_engine's draw at seed 0) as a checkpoint
    # whose tokenizer gives every id text (``write_text_tokenizer``).
    cfg = get_preset("qwen2.5-3b")
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="hf-text-qwen2.5-3b-", dir=os.path.join(root, "build"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
                         device=torch.device("cuda"))
    write_hf_checkpoint(cfg, params, ckpt)
    del params
    torch.cuda.empty_cache()
    write_text_tokenizer(ckpt, cfg.vocab_size)
    n_jobs, gen, queue = 16, 32, "smoke-gw"
    broker_port, http_port, metrics_port = _free_port(), _free_port(), _free_port()
    url = f"tcp://127.0.0.1:{broker_port}"
    trace_log = os.path.join(OUT_DIR, "gateway_trace.jsonl")
    open(trace_log, "w").close()
    penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                LLMQ_BROKER_URL=url)
    cli = [sys.executable, "-m", "llmq_tpu_torch"]
    logs = {name: os.path.join(OUT_DIR, f"gateway_{name}.log")
            for name in ("broker", "worker", "serve")}
    tok = HFTokenizer(ckpt)
    jobs = _default_jobs(n_jobs, gen)
    want = {j.id: {tok.decode(serve_tokens[j.id][:gen]), tok.decode(solo_tokens[j.id][:gen])}
            for j in jobs}
    procs, problems, rec = {}, [], dict(phase="gateway", broker=url, card=smi)
    byte_tok = ByteTokenizer()
    if any(tok.encode(j.get_formatted_prompt()) != byte_tok.encode(j.get_formatted_prompt())
           for j in jobs):
        problems.append("the checkpoint's tokenizer encodes a prompt unlike the byte tokenizer")
    try:
        with open(logs["broker"], "w") as log:
            procs["broker"] = subprocess.Popen(
                cli + ["broker", "serve", "--host", "127.0.0.1", "--port", str(broker_port)],
                cwd=root, env=penv, stdout=log, stderr=subprocess.STDOUT)
        _wait_listening(broker_port, procs["broker"])
        t_start = time.perf_counter()
        with open(logs["worker"], "w") as log:
            procs["worker"] = subprocess.Popen(
                cli + ["worker", "run", ckpt, queue, "--max-num-seqs", "16",
                       "--max-model-len", "512", "--dtype", "bfloat16"],
                cwd=root, env=dict(penv, LLMQ_DECODE_KERNEL="v1", LLMQ_RESULT_DIGEST="1",
                                   LLMQ_METRICS_PORT=str(metrics_port),
                                   LLMQ_TRACE_LOG=trace_log),
                stdout=log, stderr=subprocess.STDOUT)
        with open(logs["serve"], "w") as log:
            procs["serve"] = subprocess.Popen(
                cli + ["serve", queue, "--port", str(http_port)], cwd=root, env=penv,
                stdout=log, stderr=subprocess.STDOUT)
        _wait_listening(http_port, procs["serve"])
        while not _log_has(logs["worker"], "consuming"):
            if procs["worker"].poll() is not None or time.perf_counter() - t_start > 300:
                raise SystemExit(f"gateway phase: the worker did not start ({logs['worker']})")
            time.sleep(0.2)
        rec["worker_ready_s"] = time.perf_counter() - t_start

        # (a) 8 blocking and 8 streamed at once, then the other way round.
        def ask(j, stream: bool) -> dict:
            body = {"prompt": j.prompt, "max_tokens": gen, "temperature": 0.0}
            if stream:
                body["stream"] = True
            r = _http(http_port, "POST", "/v1/completions", body)
            if r["status"] == 200 and not stream:
                r.update(text=r["body"]["choices"][0]["text"], job_id=r["body"]["id"])
            elif r["status"] == 200:
                r["job_id"] = r["frames"][0]["id"]
            return dict(r, id=j.id, stream=stream)

        answers = []
        with ThreadPoolExecutor(n_jobs) as pool:
            for n_round, first_half_streams in ((1, False), (2, True)):
                plan = [(j, (i < n_jobs // 2) == first_half_streams) for i, j in enumerate(jobs)]
                answers += [dict(a, round=n_round) for a in pool.map(lambda a: ask(*a), plan)]
        blocking = {a["id"]: a for a in answers if not a["stream"]}
        streamed = {a["id"]: a for a in answers if a["stream"]}
        for a in answers:
            if a["status"] != 200:
                problems.append(f"{a['id']} ({'streamed' if a['stream'] else 'blocking'}): "
                                f"HTTP {a['status']}")
            elif a["text"] not in want[a["id"]]:
                problems.append(f"{a['id']}: text is neither phase 3's first {gen} tokens' "
                                f"nor its solo run's")
            if a["stream"] and a["status"] == 200 and (
                    a["frames"][-1] != "[DONE]"
                    or a["frames"][-2]["choices"][0]["finish_reason"] != "length"):
                problems.append(f"{a['id']}: stream ends {a['frames'][-2:]}")
        same = 0
        for rid, s in streamed.items():
            b = blocking[rid]
            if s.get("text") == b.get("text"):
                same += 1
            elif not (len(want[rid]) == 2 and {s.get("text"), b.get("text")} == want[rid]):
                problems.append(f"{rid}: streamed text differs from the blocking text")
        texts = [a.get("text") or "" for a in answers]
        # Every id past 256 ends in "é"'s lead byte and starts with its
        # continuation: a streamed "é" was split across two tokens.
        joined = sum(a["text"].count("é") for a in answers if a["stream"] and a.get("text"))
        rec.update(requests=len(answers), streamed_equal_blocking=same,
                   texts_nonempty=sum(1 for t in texts if t), text_chars=sum(map(len, texts)),
                   streamed_split_chars_joined=joined)
        if rec["texts_nonempty"] != len(answers) or not joined:
            problems.append(f"{rec['texts_nonempty']} of {len(answers)} texts non-empty, "
                            f"{joined} split characters streamed")
        for n_round in (1, 2):  # round 1 meets a cold worker: its first dispatches
            ttft = [a["first_s"] * 1e3 for a in answers if a["round"] == n_round and a["stream"]]
            lat = [a["total_s"] * 1e3 for a in answers
                   if a["round"] == n_round and not a["stream"]]
            rec[f"round{n_round}"] = dict(client_ttft_ms_p50=_pct(ttft, 0.5),
                                          client_ttft_ms_p95=_pct(ttft, 0.95),
                                          blocking_latency_ms_p50=_pct(lat, 0.5))

        # (b) a long stream the client leaves after its first frame (the
        # first token: random weights give few tokens with text).
        left = _http(http_port, "POST", "/v1/completions",
                     {"prompt": jobs[0].prompt, "max_tokens": 512, "temperature": 0.0,
                      "stream": True}, hang_up_after=1)
        cancelled_id = left["frames"][0]["id"] if left.get("frames") else None
        t_left = time.perf_counter()
        while True:
            util = _scrape(metrics_port).get("llmq_engine_kv_page_utilization")
            if util == 0.0:
                break
            if time.perf_counter() - t_left > 60:
                problems.append(f"pages in use 60 s after the client left: {util}")
                break
            time.sleep(0.1)
        rec["cancel_pages_free_s"] = time.perf_counter() - t_left

        # (c) the metrics, a chat request, the models and the health.
        chat = _http(http_port, "POST", "/v1/chat/completions",
                     {"messages": [{"role": "user", "content": jobs[1].prompt}],
                      "max_tokens": 8, "temperature": 0.0})
        models = _http(http_port, "GET", "/v1/models")
        health = _http(http_port, "GET", "/healthz")
        if chat["status"] != 200 or not isinstance(
                chat["body"]["choices"][0]["message"]["content"], str) or not (
                chat["body"]["choices"][0]["message"]["content"]):
            problems.append(f"chat: {chat}")
        if models["status"] != 200 or models["body"]["data"][0]["id"] != "llmq-tpu":
            problems.append(f"models: {models}")
        if health["body"] != {"ok": True, "queue": queue}:
            problems.append(f"healthz: {health}")
        served = len(answers) + 2
        metrics = _scrape(metrics_port)
        counts = {name: metrics.get(name) for name in (
            "llmq_ttft_seconds_count", "llmq_itl_seconds_count",
            'llmq_dispatch_seconds_count{kind="decode_block"}',
            'llmq_dispatch_seconds_count{kind="prefill"}', "llmq_broker_publish_seconds_count")}
        for name, n in counts.items():
            floor = 1 if "prefill" in name else served
            if n is None or n < floor:
                problems.append(f"/metrics {name} = {n}, want >= {floor}")
        rec.update(metrics_counts=counts, chat_text_chars=len(
            chat["body"]["choices"][0]["message"]["content"]) if chat["status"] == 200 else None)
        rc_serve = _stop(procs["serve"], signal.SIGTERM, 30)
        if rc_serve != 0:
            problems.append(f"serve exited {rc_serve} on SIGTERM")

        # The token ids behind (a)'s texts: the same 16 jobs published to
        # the worker straight (the gateway, which owns the results, gone).
        asyncio.run(_submit(url, queue, jobs))
        direct = asyncio.run(_receive_n(url, queue, n_jobs, procs["worker"], timeout=300,
                                        log="gateway_worker.log"))
        shapes = [_served_as(r.get("token_ids"), r["id"], gen, serve_tokens, solo_tokens)
                  for r in direct]
        for r, shape in zip(direct, shapes):
            if shape is None or r["result"] != tok.decode(r["token_ids"]) or not r["result"]:
                problems.append(f"{r['id']} straight to the worker: tokens differ from the "
                                f"first {gen} of phase 3's and of its solo run's")
        rec.update(direct_jobs=len(direct), direct_prefilled_solo=shapes.count("solo"))

        # (d) a job's trace, and the dashboard once a heartbeat carries the
        # serve (the worker beats every 30 s).
        t_served = time.time()

        async def trace_and_beat():
            async with BrokerManager(Config(broker_url=url)) as mgr:
                await mgr.publish_job(queue, Job(id="trace-me", prompt=jobs[2].prompt,
                                                 temperature=0.0, max_tokens=gen))
                deadline = time.monotonic() + 120
                while (await mgr.get_queue_stats(queue + ".results")).message_count < 1:
                    if time.monotonic() > deadline:
                        raise SystemExit("gateway phase: no result for trace-me")
                    await asyncio.sleep(0.1)
                while True:
                    beats = await mgr.get_worker_health(queue)
                    fresh = [h for h in beats.values()
                             if h.last_seen.timestamp() > t_served
                             and (h.engine_stats or {}).get("ttft_p50_ms")]
                    if fresh:
                        return fresh[0]
                    if time.monotonic() > deadline:
                        raise SystemExit("gateway phase: no heartbeat after the serve")
                    await asyncio.sleep(0.5)

        beat = asyncio.run(trace_and_beat())
        es = beat.engine_stats
        traced = subprocess.run(cli + ["trace", "trace-me", "-q", queue], cwd=root, env=penv,
                                capture_output=True, text=True, timeout=120)
        lines = traced.stdout.splitlines()
        events = [line.split()[0] for line in lines[3:] if line and not line.startswith("total")]
        if traced.returncode != 0 or events != GATEWAY_TRACE:
            problems.append(f"trace: exit {traced.returncode}, events {events}")
        with open(os.path.join(OUT_DIR, "gateway_trace.txt"), "w") as f:
            f.write(traced.stdout + traced.stderr)
        top = subprocess.run(cli + ["monitor", "top", queue, "--once"], cwd=root, env=penv,
                             capture_output=True, text=True, timeout=120)
        with open(os.path.join(OUT_DIR, "gateway_top.txt"), "w") as f:
            f.write(top.stdout + top.stderr)
        import re

        table = top.stdout.splitlines()
        head = next((i for i, line in enumerate(table) if line.startswith("worker ")), None)
        row = None
        if head is not None:
            cols = re.split(r"\s{2,}", table[head].strip())
            for line in table[head + 2:]:
                cells = re.split(r"\s{2,}", line.strip())
                if cells[0] == beat.worker_id:
                    row = dict(zip(cols, cells))
        if (row is None or float(row["tok/s"]) <= 0
                or float(row["ttft p50/p95 ms"].split("/")[0]) <= 0):
            problems.append(f"monitor top: the worker's row {row}")
        for key, value in (("cancellations", 1), ("jobs_cancelled", 1),
                           ("kv_page_utilization", 0.0)):
            if es.get(key) != value:
                problems.append(f"heartbeat {key} = {es.get(key)}, want {value}")
        rec.update(heartbeat_ttft_p50_ms=es.get("ttft_p50_ms"),
                   heartbeat_itl_p50_ms=es.get("itl_p50_ms"),
                   heartbeat_dispatch_ms=es.get("dispatch_ms"),
                   heartbeat_metrics_series=len(beat.metrics or {}), top_row=row,
                   trace_events=events)
        rc_worker = _stop(procs["worker"], signal.SIGTERM, 120)
        if rc_worker != 0:
            problems.append(f"worker exited {rc_worker} on SIGTERM")
    finally:
        for proc in procs.values():
            _stop(proc, signal.SIGKILL, 10)
        shutil.rmtree(ckpt, ignore_errors=True)
    stats = _worker_stats(logs["worker"])
    if stats.get("jobs_cancelled") != 1 or stats.get("finish_reasons", {}).get("cancelled") != 1:
        problems.append(f"the worker's stats: cancelled {stats.get('jobs_cancelled')}, "
                        f"finish reasons {stats.get('finish_reasons')} (want one cancelled)")
    with open(trace_log) as f:
        sink = [json.loads(line) for line in f]
    sink_events, at = {}, {}
    for r in sink:
        sink_events[r["event"]] = sink_events.get(r["event"], 0) + 1
        at[(r["job_id"], r["event"])] = r["t_wall"]
    # Round 2's answers split at the worker's claimed and finished stamps
    # (the sink's wall clock, the client's on the same host): the road to
    # the worker, the worker's span, the road back.
    split = {}
    for kind in ("blocking", "streamed"):
        parts = {"to_claim_ms": [], "worker_ms": [], "after_finish_ms": []}
        for a in answers:
            claimed = at.get((a.get("job_id"), "claimed"))
            finished = at.get((a.get("job_id"), "finished"))
            if a["round"] != 2 or a["stream"] != (kind == "streamed") or not (claimed and finished):
                continue
            parts["to_claim_ms"].append((claimed - a["sent_wall"]) * 1e3)
            parts["worker_ms"].append((finished - claimed) * 1e3)
            parts["after_finish_ms"].append((a["sent_wall"] + a["total_s"] - finished) * 1e3)
        split[kind] = dict({k: _pct(v, 0.5) for k, v in parts.items()}, n=len(parts["worker_ms"]))
        if split[kind]["n"] != n_jobs // 2:
            problems.append(f"round 2 {kind}: {split[kind]['n']} answers with both stamps")
    rec["round2_split_p50"] = split
    if sink_events.get("cancel_requested") != 1 or sink_events.get("finished", 0) < served:
        problems.append(f"LLMQ_TRACE_LOG events {sink_events}")
    launches = {}
    kl = stats.get("kernel_launches", {})  # by wrapper name
    on_path = {KERNEL_COUNTERS[k][1]: k for k in ("paged_decode", "flash_prefill")}
    for w, k in on_path.items():
        entry = kl.get(w)
        launches[k] = entry["launches"] if entry else 0
        if not entry or entry["tensor_core"] != entry["launches"] or entry["exact"]:
            problems.append(f"worker: {k} launches {entry} (want all on the tensor-core route)")
    if sorted(set(kl) - set(on_path)):
        problems.append(f"worker: kernels off the default path launched: {sorted(kl)}")
    rec.update(cancelled_job=cancelled_id, worker_stats=stats, trace_log_events=sink_events,
               launches=launches, seconds=time.perf_counter() - t_phase,
               timing="client_ttft: from sending a streamed request to its first SSE frame; "
                      "blocking latency: request to response; both with 16 requests in "
                      "flight through the gateway process; round2_split_p50: each part's own "
                      "p50 (host wall clock; the parts' p50s need not add up); heartbeat "
                      "percentiles: the worker's engine histograms (host clock)",
               problems=problems)
    emit(rec)
    if problems:
        raise SystemExit("gateway phase failed: " + "; ".join(problems[:5]))
    return launches


# --- phase 17: the fault planes ---------------------------------------------

FAULT_GEN = 32  # tokens a job in phase 17


async def _take_queue(url: str, name: str) -> list:
    """``(job id, headers)`` of each message on ``name``, acked."""
    from llmq_tpu_torch.broker.base import make_broker

    broker = make_broker(url)
    await broker.connect()
    out = []
    while (msg := await broker.get(name)) is not None:
        out.append((json.loads(msg.body)["id"], dict(msg.headers or {})))
        await msg.ack()
    await broker.close()
    return out


def _fault_leg(label: str, serve_tokens: dict, solo_tokens: dict, *, leg_env=None, arm=None,
               n_jobs: int = 16, config=None, rates: bool = False,
               faulted_replays: int = 0) -> dict:
    """One leg of phase 17: a fresh qwen2.5-3b engine (``build_engine``,
    phase 3's seed), ``arm(engine)`` (its faults and probes; returns a
    dict of what it saw) and a ``TorchWorker`` over ``memory://`` until
    ``n_jobs`` of phase 3's jobs settled, the kernel launches counted from
    just before the worker's run to just after; the engine is freed after.
    The variables ``leg_env`` hold through the leg, its rebuilds too.
    ``faulted_replays``: decode dispatches of the last engine whose graph
    replayed and which then faulted (the engine counts no dispatch that
    raised, as the reference counts none)."""
    from llmq_tpu_torch.cli.worker import build_engine
    from llmq_tpu_torch.core.config import Config
    from llmq_tpu_torch.workers.torch_worker import TorchWorker

    queue, url = "smoke-faults", f"memory://smoke-faults-{label}"
    jobs = _default_jobs(16, FAULT_GEN)[:n_jobs]
    asyncio.run(_submit(url, queue, jobs))
    with env(LLMQ_DECODE_KERNEL="v1", **(leg_env or {})):
        t0 = time.perf_counter()
        engine = build_engine("preset://qwen2.5-3b", device="cuda", dtype="bfloat16",
                              max_num_seqs=16, max_model_len=512)
        build_s = time.perf_counter() - t0
        pages = engine.core.scheduler.config.num_pages
        seen = arm(engine) if arm is not None else {}
        worker = TorchWorker(queue, engine, max_jobs=n_jobs, config=Config(
            broker_url=url, result_digest=True, max_redeliveries=1000, **(config or {})))
        if seen.get("wrap_rebuild") is not None:
            engine.rebuild_core = seen.pop("wrap_rebuild")(engine.rebuild_core)
        reset_launches()
        t1 = time.perf_counter()
        try:
            asyncio.run(worker.run())
        finally:
            engine.shutdown()
            if seen.get("stop") is not None:
                seen.pop("stop")()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches, routes = read_launches(), read_routes()
    results = {r["id"]: r for r in asyncio.run(_receive(url, queue))}
    quarantine = asyncio.run(_take_queue(url, queue + ".quarantine"))
    core = engine.core
    stats = core.stats()
    problems = route_problems(routes, launches)
    graphs = stats.get("cuda_graphs")
    if graphs is None or graphs["replays"] != stats["decode_dispatches"] + faulted_replays:
        problems.append(f"{label}: graph replays {graphs and graphs['replays']} != "
                        f"{stats['decode_dispatches']} decode-type dispatches + "
                        f"{faulted_replays} faulted")
    if launches["paged_decode"] <= 0 or launches["flash_prefill"] <= 0:
        problems.append(f"{label}: a kernel did not launch on the main path: {launches}")
    off_path = {k: n for k, n in launches.items() if k not in ("paged_decode", "flash_prefill")}
    if any(off_path.values()):
        problems.append(f"{label}: kernels off the default path launched: {off_path}")
    if core.scheduler.config.num_pages != pages:
        problems.append(f"{label}: the rebuilt engine has {core.scheduler.config.num_pages} "
                        f"pages, the first {pages}")
    shapes, parted = {}, {}
    for rid, r in results.items():
        ids = r.get("token_ids") or []
        shape = _served_as(ids, rid, FAULT_GEN, serve_tokens, solo_tokens)
        shapes[shape or "parted"] = shapes.get(shape or "parted", 0) + 1
        if shape is None:
            parted[rid] = ids
    parting = {}
    if parted:
        parting = _parting_witness(core, [j for j in jobs if j.id in parted], parted,
                                   {rid: serve_tokens[rid][:FAULT_GEN] for rid in parted})
        problems += _near_tie_problems(label, parting)
    rates_rec = captured_rates(core, S=16, ctx=330) if rates else {}
    rec = dict(label=label, build_s=build_s, wall_s=wall, num_pages=pages,
               results=len(results), result_shapes=shapes,
               parting_positions={rid: w["position"] for rid, w in parting.items()},
               quarantine=[(rid, h.get("x-failure-reason")) for rid, h in quarantine],
               engine_rebuilds=engine.engine_rebuilds,
               last_fault_reason=engine.last_fault_reason, last_rebuild=engine.last_rebuild,
               capture_s=(stats.get("cuda_graphs") or {}).get("capture_s"),
               watchdog_trips=engine.watchdog_trips, worker_error=repr(worker.error),
               jobs_quarantined=worker.jobs_quarantined, launches=launches, routes=routes,
               stats={k: stats.get(k) for k in ("hbm_oom_events", "oom_degradations",
                                                 "guard_trips", "integrity", "decode_steps",
                                                 "prefill_dispatches")},
               **rates_rec, **{k: v for k, v in seen.items() if not callable(v)})
    if worker.error is not None:
        problems.append(f"{label}: the worker stopped: {worker.error!r}")
    rec["problems"] = problems
    core.release()
    del engine, core, worker
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _sleep_cycles_per_s() -> float:
    """``torch.cuda._sleep`` cycles a second on this card, timed by events."""
    torch.cuda._sleep(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    return 100_000_000 / (start.elapsed_time(end) / 1e3)


def _arm_stall(engine) -> dict:
    """Phase 17 (b): warm the engine (its decode graph captured under the
    30 s floor), lower the floor to 1 s, and queue a device stall past the
    deadline behind the 10th decode dispatch of the serve; a thread reads
    the watchdog's ``last_ok_age_s`` / ``wedged_kind`` meanwhile."""
    wd = engine.core.watchdog
    engine.generate_sync(rid="warm", prompt="warm up", params=_greedy(8), timeout=300)
    wd.min_s = 1.0
    deadline = wd.deadline_for("decode_block")
    stall_s = max(3.0, deadline + 2.0)
    cycles = int(stall_s * _sleep_cycles_per_s())
    seen = dict(deadline_s=deadline, stall_s=stall_s, stall_cycles=cycles, age_max_wedged_s=0.0)
    trips, state, done = [], {"n": 0, "t": None}, threading.Event()
    wd._on_trip = lambda kind, elapsed, dl: trips.append((time.monotonic(), kind, elapsed, dl))

    def hook(kind: str) -> None:
        if kind != "decode_block" or state["t"] is not None:
            return
        state["n"] += 1
        if state["n"] >= 10:
            state["t"] = time.monotonic()
            torch.cuda._sleep(cycles)

    def poll() -> None:
        while not done.wait(0.01):
            if wd.wedged_kind() is not None:
                seen["age_max_wedged_s"] = max(seen["age_max_wedged_s"], wd.last_ok_age_s())

    engine.core.on_dispatch = hook
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()

    def stop() -> None:
        done.set()
        poller.join(5)
        if trips:
            t_trip, kind, elapsed, dl = trips[0]
            seen.update(trip_kind=kind, trip_elapsed_s=elapsed, trip_past_deadline_s=elapsed - dl,
                        stall_to_trip_s=t_trip - state["t"] if state["t"] else None)
        seen["trips_seen"] = len(trips)

    seen["stop"] = stop
    return seen


def _faults_integrity(smi: str) -> tuple:
    """Phase 17 (e): the weight audit, the canary, and one KV spot check on
    the prefix path. Returns (record, K3 / K4 launches)."""
    from llmq_tpu_torch.broker.chaos import BitFlipInjector
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    cfg = get_preset("qwen2.5-3b")
    problems, rec = [], {}

    def params():
        return init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
                           device=torch.device("cuda"))

    with env(LLMQ_WEIGHT_AUDIT_EVERY="3600", LLMQ_CANARY_EVERY="3600"):
        t0 = time.perf_counter()
        core = _snapshot_engine(params(), cfg)
        rec["build_with_baseline_and_golden_s"] = time.perf_counter() - t0
    n_leaves = len(core._weight_baseline)
    tree_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(core.params))
    audits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        audits.append((core.audit_weights(), (time.perf_counter() - t) * 1e3))
    if any(bad for bad, _ in audits):
        problems.append(f"audit of intact weights named {audits}")
    t = time.perf_counter()
    canary_ok = core.run_canary()
    canary_ms = (time.perf_counter() - t) * 1e3
    if not canary_ok:
        problems.append("the canary failed on intact weights")
    flip = BitFlipInjector("weight", mode="flip", seed=8, after_range=(1, 1)).bind(core)
    flip("decode_block")
    named = core.audit_weights()
    if named != flip.corrupted:
        problems.append(f"audit after a flip of {flip.corrupted} named {named}")
    nan = BitFlipInjector("logit", mode="nan", seed=9, after_range=(1, 1)).bind(core)
    failed_canary = not core.run_canary()
    if not failed_canary or nan.fired != 1:
        problems.append(f"the canary passed after a NaN flip ({nan.corrupted})")
    if core.integrity_status() != "suspect":
        problems.append(f"integrity_status {core.integrity_status()} after the flips")
    rec.update(leaves=n_leaves, tree_bytes=tree_bytes,
               audit_ms=[ms for _, ms in audits], audit_gb_s=[tree_bytes / ms / 1e6
                                                              for _, ms in audits],
               canary_tokens=len(core._canary_golden), canary_ms=canary_ms,
               flipped=flip.corrupted, audit_named=named, canary_failed_after_nan=failed_canary,
               integrity=core.integrity_status())
    core.release()
    del core
    gc.collect()
    torch.cuda.empty_cache()

    # One spot check mid-serve on the prefix path (K3 + K4).
    pcore = _prefix_kv_engine(params(), cfg)
    reset_launches()
    for j in _prefix_jobs(4, 16):
        pcore.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(16))
    outs: dict = {}
    while pcore.has_work and not any(s.prefilled for s in pcore.scheduler.running.values()):
        outs.update({o.rid: o for o in pcore.step()})
    pcore.step()
    t = time.perf_counter()
    spots = pcore.kv_spot_check()
    spot_ms = (time.perf_counter() - t) * 1e3
    _step_to_end(pcore, outs)
    torch.cuda.synchronize()
    launches, routes = read_launches(), read_routes()
    if spots or pcore.kv_spot_checks != 1:
        problems.append(f"kv spot check: {spots} ({pcore.kv_spot_checks} checks)")
    if launches["paged_prefill"] <= 0 or launches["paged_decode_v3"] <= 0:
        problems.append(f"prefix path: K3 / K4 did not launch: {launches}")
    problems += route_problems(routes, launches)
    rec.update(kv_spot_ms=spot_ms, kv_spot_mismatches=spots, prefix_results=len(outs),
               prefix_launches=launches)
    pcore.release()
    del pcore
    gc.collect()
    torch.cuda.empty_cache()
    rec["problems"] = problems
    return rec, {k: launches[k] for k in ("paged_prefill", "paged_decode_v3")}


def phase_faults(smi: str, serve_tokens: dict, solo_tokens: dict) -> dict:
    """Phase 17: the fault planes (M12) at full width; returns each
    kernel's launches summed over the legs."""
    from llmq_tpu_torch.broker.chaos import BitFlipInjector, DeviceFaultInjector

    t_phase = time.perf_counter()
    legs, problems = {}, []

    def inject(make):
        def arm(engine):
            engine.core.on_dispatch = make()
            return {}
        return arm

    # (a) a CUDA error on a decode dispatch
    legs["a"] = rec = _fault_leg("a_cuda_error", serve_tokens, solo_tokens, rates=True, arm=inject(
        lambda: DeviceFaultInjector("decode", "xla_error", seed=22, after_range=(8, 16))))
    if (rec["engine_rebuilds"], rec["last_fault_reason"]) != (1, "xla_runtime_error"):
        problems.append(f"(a) {rec['engine_rebuilds']} rebuild(s) for {rec['last_fault_reason']}")
    # (b) a real device stall under the watchdog
    legs["b"] = rec = _fault_leg("b_device_stall", serve_tokens, solo_tokens, arm=_arm_stall,
                                 leg_env=dict(LLMQ_WATCHDOG_MULT="2", LLMQ_WATCHDOG_MIN_S="30"))
    if (rec["engine_rebuilds"], rec["last_fault_reason"], rec["watchdog_trips"]) != \
            (1, "hung_dispatch", 1):
        problems.append(f"(b) rebuilds {rec['engine_rebuilds']}, reason "
                        f"{rec['last_fault_reason']}, trips {rec['watchdog_trips']}")
    if not rec["age_max_wedged_s"] > rec["deadline_s"]:
        problems.append(f"(b) last_dispatch_ok_age_s read {rec['age_max_wedged_s']} s while "
                        f"wedged, the deadline {rec['deadline_s']} s")
    # (c) a first out-of-memory error: the ladder, no rebuild
    legs["c"] = rec = _fault_leg("c_oom_ladder", serve_tokens, solo_tokens, faulted_replays=1,
                                 arm=inject(lambda: DeviceFaultInjector(
                                     "decode", "oom", seed=31, after_range=(8, 16))))
    if rec["engine_rebuilds"] or rec["stats"]["oom_degradations"] != ["shrink_runahead"]:
        problems.append(f"(c) rebuilds {rec['engine_rebuilds']}, ladder "
                        f"{rec['stats']['oom_degradations']}")
    # (d) the guard: clean, a transient NaN flip, a sticky one
    guard = dict(LLMQ_LOGIT_GUARD="on")
    legs["d_clean"] = rec = _fault_leg("d_guard_clean", serve_tokens, solo_tokens, leg_env=guard,
                                       rates=True)
    if rec["engine_rebuilds"] or rec["stats"]["integrity"] != "ok":
        problems.append(f"(d) guard on, no fault: {rec['engine_rebuilds']} rebuild(s), "
                        f"integrity {rec['stats']['integrity']}")

    def transient(engine):
        BitFlipInjector("logit", mode="nan", seed=41, after_range=(8, 16)).bind(engine.core)
        return {}

    legs["d_transient"] = rec = _fault_leg("d_nan_transient", serve_tokens, solo_tokens,
                                           leg_env=guard, arm=transient)
    if (rec["engine_rebuilds"], rec["last_fault_reason"]) != (1, "numerical_fault"):
        problems.append(f"(d) transient flip: {rec['engine_rebuilds']} rebuild(s), "
                        f"{rec['last_fault_reason']}")

    def sticky(engine):
        flip = BitFlipInjector("logit", mode="nan", seed=43, after_range=(2, 4), sticky=True)
        flip.bind(engine.core)

        def wrap(rebuild):
            def rebuild_with_flip():
                core = rebuild()
                flip.bind(core)  # re-armed: the rebuilt core corrupts again
                return core
            return rebuild_with_flip
        return {"wrap_rebuild": wrap}

    legs["d_sticky"] = rec = _fault_leg("d_nan_sticky", serve_tokens, solo_tokens, leg_env=guard,
                                        arm=sticky, n_jobs=1, config=dict(quarantine_attempts=1))
    if rec["quarantine"] != [("job-00", "numerical_fault")] or rec["results"]:
        problems.append(f"(d) sticky flip: quarantine {rec['quarantine']}, results "
                        f"{rec['results']}")
    for key in ("a", "b", "c", "d_clean", "d_transient"):
        if legs[key]["results"] != 16 or legs[key]["quarantine"]:
            problems.append(f"({key}) {legs[key]['results']} results, quarantine "
                            f"{legs[key]['quarantine']}")
    for leg in legs.values():
        problems += leg["problems"]
    guard_cost = dict(
        captured_step_ms_guard=legs["d_clean"].get("captured_step_ms"),
        captured_step_device_ms_guard=legs["d_clean"].get("captured_step_device_ms"),
        captured_step_ms_plain=legs["a"].get("captured_step_ms"),
        captured_step_device_ms_plain=legs["a"].get("captured_step_device_ms"))
    integ, prefix_launches = _faults_integrity(smi)
    problems += integ["problems"]
    launches = {name: sum(leg["launches"][name] for leg in legs.values())
                for name in ("paged_decode", "flash_prefill")}
    launches.update(prefix_launches)
    emit(dict(phase="faults", legs=legs, guard_cost=guard_cost, integrity=integ,
              launches=launches, seconds=time.perf_counter() - t_phase,
              rebuild_timing="extract_s / free_s / build_s / reinsert_s: host seconds of the "
                             "engine's rebuild (engine.last_rebuild); capture_s: the rebuilt "
                             "engine's warm-ups and captures, host seconds",
              card=smi, problems=problems))
    if problems:
        raise SystemExit("faults phase failed: " + "; ".join(problems[:5]))
    return launches


# --- phase 18: mixture-of-experts serving at full width ----------------------

MOE_PRESET = "qwen1.5-moe-a2.7b"
# K6 on one qwen1.5-moe-a2.7b layer's 2-D int8 weights at a decode step
# (the expert stacks are dequantized instead), and on its untied head.
MOE_QUANT_SHAPES = (
    ("qwen1.5-moe q/k/v/o_proj", 2048, 2048),
    ("qwen1.5-moe shared gate/up_proj", 2048, 5632),
    ("qwen1.5-moe shared down_proj", 5632, 2048),
    ("qwen1.5-moe lm_head", 2048, 151936),
)


def _moe_kernels(iters: int) -> dict:
    """K1 and K2 at the MoE's attention shapes (16 query heads over 16 KV
    heads, a query group of 1, d 128) and K6 at its int8 weights' shapes
    (M = 16), each against its plain version in f32 and bf16."""
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        rec = check_decode(MOE_PRESET, variant="v1", S=16, H=16, n_kv=16, d=128, L=24, page=32,
                           max_ctx=1024, dtype=dtype, softcap=None, window=None, iters=iters,
                           seed=31)
        recs[f"paged_decode/{rec['route']}"] = rec
        rec = check_prefill(MOE_PRESET, B=4, T=224, H=16, n_kv=16, d=128,
                            lengths=[224, 200, 151, 37], dtype=dtype, softcap=None, window=None,
                            iters=iters, seed=32)
        recs[f"flash_prefill/{rec['route']}"] = rec
        for i, (label, K, N) in enumerate(MOE_QUANT_SHAPES):
            rec = check_quant_matmul(label, kind="int8", M=16, K=K, N=N, dtype=dtype,
                                     iters=iters, seed=33 + i, timed=bf16)
            if bf16:
                recs[f"int8_matmul/{label}"] = rec
    return recs


def _moe_serve(smi: str, dtype: str) -> tuple:
    """(b) / (c): 16 of phase 3's jobs (64 new tokens) served by
    ``run_torch_worker("preset://qwen1.5-moe-a2.7b")`` over ``memory://``
    at full width, then the same jobs on an eager engine over the same
    weights. Returns the counted launches and the record."""
    from llmq_tpu_torch.cli.worker import run_torch_worker
    from llmq_tpu_torch.engine.engine import EngineCore
    from llmq_tpu_torch.models import transformer as tt

    n_jobs, gen = 16, 64
    url, queue = f"memory://chip-smoke-moe-{dtype}", f"moe-{dtype}"
    jobs = _default_jobs(n_jobs, gen)
    asyncio.run(_submit(url, queue, jobs))
    switches = QUANT_KERNELS_ON if dtype == "int8" else {}
    reset_launches()
    t0 = time.perf_counter()
    with env(LLMQ_DECODE_KERNEL="v1", **switches), recording_tokens({}) as tokens:
        worker = run_torch_worker(f"preset://{MOE_PRESET}", queue, device="cuda", dtype=dtype,
                                  max_num_seqs=16, max_model_len=512, broker_url=url,
                                  max_jobs=n_jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted, routes = read_launches(), read_routes()
    results = asyncio.run(_receive(url, queue))
    core = worker.engine.core
    stats = core.stats()
    cfg = core.model_config
    L = cfg.num_layers
    steps = stats["decode_steps"] + _warm(stats)
    dispatches = steps + stats["prefill_dispatches"]
    want = {"paged_decode": L * steps, "flash_prefill": L * stats["prefill_dispatches"]}
    if dtype == "int8":  # q/k/v/o and the shared expert's three a layer, and the untied head
        want["int8_matmul"] = 7 * L * dispatches + dispatches
    problems = (_check_results(results, n_jobs, gen) + route_problems(routes, counted)
                + graph_problems(stats))
    for name in want:
        if counted[name] <= 0:
            problems.append(f"{name} did not launch on the {dtype} MoE path: {counted}")
    for name, n in counted.items():
        if n != want.get(name, 0):
            problems.append(f"{name} launched {n} times, want {want.get(name, 0)}")

    # The same jobs on an eager engine over the same weights and settings:
    # the captured serve must give its tokens, or part at a near-tie.
    with env(LLMQ_DECODE_KERNEL="v1", **switches):
        eager = EngineCore(cfg, core.params, core.tokenizer, engine_config=core.cfg,
                           device=core.device, cuda_graphs=False)
    eager_out: dict = {}
    for j in jobs:
        eager.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
    eager_tokens = {rid: list(o.token_ids) for rid, o in _step_to_end(eager, eager_out).items()}
    parting = _parting_witness(eager, jobs, tokens, eager_tokens)
    for rid, w in parting.items():
        if (w["recompute_rank"] is None or max(w["phase3_rank"], w["recompute_rank"]) > 2
                or not w["gap_bf16_steps"] <= NEAR_TIE_ULPS):
            problems.append(f"captured {rid} parts from the eager serve at {w['position']} at "
                            f"no near-tie: ranks {w['phase3_rank']} / {w['recompute_rank']}, "
                            f"gap {w['gap']} ({w['gap_bf16_steps']} bf16 steps)")
    if eager.stats()["cuda_graphs"] is not None:
        problems.append("the eager twin dispatched through CUDA graphs")
    del eager
    gc.collect()
    torch.cuda.empty_cache()

    dec_ms, dec_dev_ms = _decode_rates(core, S=16, ctx=330)
    captured = captured_rates(core, S=16, ctx=330)
    # The layer's transient: the peak an eager decode step of 16 rows
    # allocates beyond what it starts with, beside the sizing's figure.
    quantized = dtype in ("int8", "int4")
    reserved = tt.moe_transient_bytes(cfg, torch.bfloat16, 16, quantized)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _decode_rates(core, S=16, ctx=330, iters=1)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - base
    weight_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(core.params))
    gen_tokens = sum(r["usage"]["completion_tokens"] for r in results)
    rec = dict(
        **captured, cuda_graphs=stats["cuda_graphs"], phase="moe_serve",
        model=f"preset://{MOE_PRESET}", layers=L, experts=cfg.num_experts,
        top_k=cfg.num_experts_per_tok, dtype=dtype, quant_kernels=sorted(core.model.quant_kernels),
        jobs=len(results), gen_tokens=gen_tokens, wall_s=wall,
        serve_completion_tok_s=gen_tokens / wall,
        timing="wall from the worker's build (weights drawn on the card) to its last job",
        decode_tok_s=16 / (dec_ms / 1e3), decode_step_ms=dec_ms, decode_step_device_ms=dec_dev_ms,
        decode_idle_share=max(0.0, 1 - dec_dev_ms / dec_ms),
        weight_gb=weight_bytes / 1e9, kv_pool_pages=core.k_pages.shape[1],
        moe_transient_reserved_gb=reserved / 1e9,
        eager_decode_step_peak_gb=step_peak / 1e9,
        captured_equals_eager=len(jobs) - len(parting),
        parting={rid: w["position"] for rid, w in parting.items()},
        launches=counted, routes=routes, expected_launches=want,
        decode_steps=stats["decode_steps"], prefill_dispatches=stats["prefill_dispatches"],
        card=smi, problems=problems,
    )
    emit(rec)
    if problems:
        raise SystemExit(f"moe {dtype} serve failed: " + "; ".join(problems[:5]))
    worker.engine.core.model = None
    del worker, core
    gc.collect()
    torch.cuda.empty_cache()
    return {name: counted[name] for name in want}, rec


def _moe_parity(smi: str) -> dict:
    """(d) f32, TF32 off: qwen1.5-moe-a2.7b's widths at 2 layers, one tree
    of seeded weights (attention biases perturbed), the card's engine
    against the port's CPU path: one prefill of 4 prompts and one decode
    step (grouped and sync-free expert forms), logits within 1e-4, and 16
    greedy tokens each, identical; K1 and K2 on their exact routes only."""
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_preset(MOE_PRESET), num_layers=2)
    g = torch.Generator().manual_seed(7)
    params = init_params(cfg, g, torch.float32)
    for name in ("q_bias", "k_bias", "v_bias"):
        params["layers"][name].normal_(0.0, 0.5, generator=g)
    prompts = ["The capital of France is", "def fibonacci(n):\n    if n < 2:",
               "Once upon a time, in a kingdom by the sea, there lived",
               "Q: What is 12 times 12?\nA:"]
    ecfg = dict(max_num_seqs=4, max_model_len=256, page_size=32, num_pages=64, kv_dtype="f32",
                min_prefill_bucket=32)
    ids = [ByteTokenizer().encode(p) for p in prompts]
    tokens = torch.zeros((4, 64), dtype=torch.int32)
    for r, row in enumerate(ids):
        tokens[r, :len(row)] = torch.tensor(row)
    lengths = torch.tensor([len(r) for r in ids], dtype=torch.int32)
    bt = torch.arange(1, 1 + 4 * 8, dtype=torch.int32).reshape(4, 8)
    logits, outs = {}, {}
    for dev in ("cuda", "cpu"):
        reset_launches()
        with env(LLMQ_DECODE_KERNEL="v1"):
            core = _engine(cfg, params, dev, **ecfg)
        args = [x.to(core.device) for x in (tokens, lengths, bt)]
        pre = core.model.prefill(args[0], args[1], core.k_pages, core.v_pages, args[2])
        dec = core.model.decode(pre.argmax(-1).to(torch.int32), args[1], core.k_pages,
                                core.v_pages, args[2],
                                torch.ones(4, dtype=torch.bool, device=core.device))
        logits[dev] = (pre.cpu(), dec.cpu())
        core.k_pages.zero_()
        core.v_pages.zero_()
        outs[dev] = _generate(core, prompts, 16)
        if dev == "cuda":
            counted, routes = read_launches(), read_routes()
        del core
        gc.collect()
        torch.cuda.empty_cache()
    err_pre = (logits["cuda"][0] - logits["cpu"][0]).abs().max().item()
    err_dec = (logits["cuda"][1] - logits["cpu"][1]).abs().max().item()
    same = outs["cuda"] == outs["cpu"] and all(len(v) == 16 for v in outs["cuda"].values())
    problems = route_problems(routes, counted, route="exact")
    if counted["paged_decode"] <= 0 or counted["flash_prefill"] <= 0:
        problems.append(f"K1 or K2 did not launch: {counted}")
    if not (err_pre <= 1e-4 and err_dec <= 1e-4):
        problems.append(f"logits apart: prefill {err_pre}, decode {err_dec}")
    if not same:
        problems.append("greedy tokens differ between the card and the CPU")
    rec = dict(phase="moe_parity_f32", config=f"{MOE_PRESET} widths, 2 layers",
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               prefill_logits_max_abs_err=err_pre, decode_logits_max_abs_err=err_dec,
               tolerance=1e-4, greedy_tokens_identical=same,
               tokens_compared=sum(len(v) for v in outs["cuda"].values()),
               card_launches=counted, routes=routes, card=smi, problems=problems)
    emit(rec)
    if problems:
        raise SystemExit("moe f32 parity failed: " + "; ".join(problems[:5]))
    return rec


def _moe_checkpoint(smi: str) -> dict:
    """(e) An HF-format qwen2_moe checkpoint of seeded bf16 weights at
    qwen1.5-moe-a2.7b's widths and 2 layers (one tensor per expert, a
    tokenizer beside it) under ``build/``, removed after:
    ``load_checkpoint`` on the card gives the written tree bit for bit and
    ``from_pretrained`` the config; then ``python -m llmq_tpu_torch worker
    run CHECKPOINT`` over tcp:// (the port's ``BrokerServer`` process)
    serves 4 jobs, whose token ids must equal an in-process engine's over
    the loaded tree, all 4 prefilled together or each alone."""
    from llmq_tpu_torch.cli.worker import engine_config
    from llmq_tpu_torch.engine.engine import EngineCore
    from llmq_tpu_torch.engine.tokenizer import HFTokenizer
    from llmq_tpu_torch.engine.weights import load_checkpoint
    from llmq_tpu_torch.models.config import ModelConfig
    from llmq_tpu_torch.models.presets import get_preset
    from llmq_tpu_torch.models.transformer import init_params

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = dataclasses.replace(get_preset(MOE_PRESET), num_layers=2)
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(5), torch.bfloat16,
                         device=dev)
    ckpt = os.path.join(root, "build", "moe_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    os.makedirs(ckpt)
    problems = []
    server = worker = None
    try:
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(cfg, params, ckpt)
        write_text_tokenizer(ckpt, cfg.vocab_size)
        write_s = time.perf_counter() - t0
        loaded_cfg = ModelConfig.from_pretrained(ckpt)
        keep = ("eos_token_ids", "bos_token_id", "max_position_embeddings")
        if dataclasses.replace(loaded_cfg, **{k: getattr(cfg, k) for k in keep}) != cfg:
            problems.append(f"from_pretrained gives {loaded_cfg}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_checkpoint(ckpt, cfg, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want, got = dict(_leaves(params)), dict(_leaves(loaded))
        if sorted(want) != sorted(got):
            problems.append(f"leaves {sorted(set(want) ^ set(got))} differ")
        apart = [n for n in want if n in got and not _same_bits(want[n], got[n])]
        if apart:
            problems.append(f"leaves not bit for bit: {apart[:5]}")
        del params
        n_jobs, gen, queue = 4, 32, "smoke-moe-ckpt"
        jobs = _default_jobs(n_jobs, gen)
        ref = {}
        ecfg = engine_config(loaded_cfg, dtype="bfloat16", max_num_seqs=4, max_model_len=512)
        for shape in ("batch", "solo"):  # the worker's build: its config, its tokenizer
            with env(LLMQ_DECODE_KERNEL="v1"):
                core = EngineCore(loaded_cfg, loaded, HFTokenizer(ckpt), engine_config=ecfg,
                                  device=dev)
            outs: dict = {}
            for j in jobs:
                core.add_request(j.id, prompt=j.get_formatted_prompt(), params=_greedy(gen))
                if shape == "solo":
                    outs.update({o.rid: o for o in core.step()})
            ref[shape] = {rid: list(o.token_ids) for rid, o in _step_to_end(core, outs).items()}
            del core
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        penv = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        server = subprocess.Popen([sys.executable, "-c", _SERVER], cwd=root, env=penv,
                                  stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        url = f"tcp://127.0.0.1:{int(server.stdout.readline())}"
        asyncio.run(_submit(url, queue, jobs))
        log_path = os.path.join(OUT_DIR, "moe_checkpoint_worker.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            worker = subprocess.Popen(
                [sys.executable, "-m", "llmq_tpu_torch", "worker", "run", ckpt, queue,
                 "--max-num-seqs", "4", "--max-model-len", "512", "--dtype", "bfloat16"],
                cwd=root, env=dict(penv, LLMQ_BROKER_URL=url, LLMQ_DECODE_KERNEL="v1",
                                   LLMQ_RESULT_DIGEST="1"),
                stdout=log, stderr=subprocess.STDOUT)
            results = asyncio.run(_receive_n(url, queue, n_jobs, worker, timeout=300,
                                             log="moe_checkpoint_worker.log"))
            worker_s = time.perf_counter() - t0
            rc = _stop(worker)
        if rc != 0:
            problems.append(f"worker exited {rc} on SIGTERM")
        problems += _check_results(results, n_jobs, gen)
        shapes = [_served_as(r.get("token_ids"), r["id"], gen, ref["batch"], ref["solo"])
                  for r in results]
        for r, shape in zip(results, shapes):
            if shape is None:
                problems.append(f"{r['id']}: token ids differ from the loaded tree's serves")
        rec = dict(phase="moe_checkpoint", config=f"{MOE_PRESET} widths, 2 layers, qwen2_moe",
                   checkpoint_gb=nbytes / 1e9, write_s=write_s, load_s=load_s,
                   load_gb_s=nbytes / 1e9 / load_s, leaves=len(want), leaves_apart=len(apart),
                   jobs=len(results), prefilled_solo=shapes.count("solo"),
                   worker_wall_s=worker_s,
                   timing="load: load_checkpoint to the card, synchronised (warm file pages); "
                          "worker: from its start to the 4th result",
                   worker_exit_code=rc, card=smi, problems=problems)
        emit(rec)
    finally:
        if worker is not None:
            _stop(worker, signal.SIGKILL, 10)
        if server is not None:
            _stop(server, signal.SIGTERM, 10)
        shutil.rmtree(ckpt, ignore_errors=True)
    if problems:
        raise SystemExit("moe checkpoint leg failed: " + "; ".join(problems[:5]))
    return rec


def phase_moe(smi: str, iters: int) -> tuple:
    """Phase 18; returns each serve's counted launches by dtype and the
    kernel records at the MoE's shapes."""
    recs = _moe_kernels(iters)
    launches = {}
    for dtype in ("bfloat16", "int8"):
        launches[dtype], _ = _moe_serve(smi, dtype)
    _moe_parity(smi)
    _moe_checkpoint(smi)
    return launches, recs


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
    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w").close()
    emit(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), count=torch.cuda.device_count()))
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, log in _build.build_logs.items():
            f.write(f"=== {name}\n{log}\n")
    emit(dict(phase="build", seconds=build_s, libraries=[os.path.basename(p) for p in paths.values()]))

    main_recs, launches = {}, {}
    if "kernels" in phases:
        main_recs = phase_kernels(args.iters)
    serve_tokens = solo_tokens = None
    if "serve" in phases:
        served, serve_tokens, solo_tokens = phase_serve(smi)
        launches.update(served)
        torch.cuda.empty_cache()
    prefix_tokens = None
    if "prefix" in phases:
        prefix, prefix_tokens = phase_prefix(smi)
        launches.update(paged_prefill=prefix["paged_prefill"],
                        paged_decode_v3=prefix["paged_decode_v3"])
        torch.cuda.empty_cache()
    if "quant" in phases:
        launches.update(phase_quant(smi))
    if "parity" in phases:
        for variant in ("f32", "int8", "int4", "fp8"):
            phase_parity(variant)
        launches.update(phase_chunk_parity())
        phase_fused_parity()
    if "checkpoint" in phases or "tcp" in phases:
        if serve_tokens is None:
            raise SystemExit("phases checkpoint and tcp compare with the serve phase's tokens")
        gc.collect()
        torch.cuda.empty_cache()
    if "checkpoint" in phases:
        launches["paged_decode_v2"] = phase_checkpoint(smi, serve_tokens)
        gc.collect()
        torch.cuda.empty_cache()
    tcp_rec = {}
    if "tcp" in phases:
        tcp_rec = phase_tcp_cli(smi, serve_tokens, solo_tokens)
    fused_launches = {}
    if "fused" in phases:
        if serve_tokens is None or prefix_tokens is None:
            raise SystemExit("phase fused compares with the serve and prefix phases' tokens")
        gc.collect()
        torch.cuda.empty_cache()
        fused_launches = phase_fused(smi, serve_tokens, prefix_tokens)
    snapshot_launches = {}
    if "snapshot" in phases:
        if serve_tokens is None:
            raise SystemExit("phase snapshot compares with the serve phase's tokens")
        gc.collect()
        torch.cuda.empty_cache()
        snapshot_launches = phase_snapshot(smi, serve_tokens, solo_tokens)
    prefix_kv_launches = {}
    if "prefix_kv" in phases:
        if serve_tokens is None or prefix_tokens is None:
            raise SystemExit("phase prefix_kv compares with the serve and prefix phases' tokens")
        gc.collect()
        torch.cuda.empty_cache()
        prefix_kv_launches = phase_prefix_kv(smi, serve_tokens, solo_tokens, prefix_tokens)
    policy_launches = {}
    if "failure_policy" in phases:
        if serve_tokens is None:
            raise SystemExit("phase failure_policy compares with the serve phase's tokens")
        gc.collect()
        torch.cuda.empty_cache()
        policy_launches = phase_failure_policy(smi, serve_tokens, solo_tokens, tcp_rec)
    pipeline_launches = {}
    if "pipeline" in phases:
        if serve_tokens is None:
            raise SystemExit("phase pipeline compares with the serve phase's tokens")
        gc.collect()
        torch.cuda.empty_cache()
        pipeline_launches = phase_pipeline(smi, serve_tokens, solo_tokens)
    peers_launches = {}
    if "peers" in phases:
        if serve_tokens is None:
            raise SystemExit("phase peers compares with the serve phase's tokens")
        gc.collect()
        torch.cuda.empty_cache()
        peers_launches = phase_peers(smi, serve_tokens, solo_tokens)
    gateway_launches = {}
    if "gateway" in phases:
        if serve_tokens is None:  # `--phases gateway` alone: phase 3 first, for its tokens
            _, serve_tokens, solo_tokens = phase_serve(smi)
        gc.collect()
        torch.cuda.empty_cache()
        gateway_launches = phase_gateway(smi, serve_tokens, solo_tokens)
    faults_launches = {}
    if "faults" in phases:
        if serve_tokens is None:  # `--phases faults` alone: phase 3 first, for its tokens
            _, serve_tokens, solo_tokens = phase_serve(smi)
        gc.collect()
        torch.cuda.empty_cache()
        faults_launches = phase_faults(smi, serve_tokens, solo_tokens)
    moe_launches, moe_recs = {}, {}
    if "moe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        moe_launches, moe_recs = phase_moe(smi, args.iters)
    if not phases >= set(ALL_PHASES):
        print("chip_smoke: phases skipped; no result line", file=sys.stderr)
        return 0
    kernels = []
    for name, source, exact_source, replaces in (
        ("paged_decode", "paged_decode_tc.cu", "paged_decode.cu", "pallas_attention.py:168"),
        ("flash_prefill", "flash_prefill_tc.cu", "flash_prefill.cu", "pallas_attention.py:1039"),
        ("paged_prefill", "paged_prefill_tc.cu", "paged_prefill.cu", "pallas_attention.py:830"),
        ("paged_decode_v3", "paged_decode_tc.cu", "paged_decode_v2.cu",
         "pallas_attention.py:575"),
        ("paged_decode_v2", "paged_decode_tc.cu", "paged_decode_v2.cu", "pallas_attention.py:487"),
        ("int8_matmul", "int8_matmul_tc.cu", "int8_matmul.cu", "pallas_matmul.py:145"),
        ("int4_matmul", "int4_matmul_tc.cu", "int4_matmul.cu", "pallas_matmul.py:219"),
    ):
        matmul = name.endswith("_matmul")
        rec = main_recs.get(name if matmul or exact_source is None else f"{name}/tensor_core", {})
        entry = dict(
            name=name, route="cuda", source=f"llmq_tpu_torch/ops/csrc/{source}",
            replaces=f"llmq_tpu/ops/{replaces}",
            launches=launches.get(name), max_abs_err=rec.get("max_abs_err"),
            ms=rec.get("ms"), plain_ms=rec.get("plain_ms"), bound_ms=rec.get("bound_ms"),
            bound_by=rec.get("bound_by"), library_ms=rec.get("library_ms"),
        )
        if exact_source is not None:  # the exact route's f32 record beside the tensor-core one
            exact = main_recs.get(f"{name}/exact", {})
            entry.update(exact_source=f"llmq_tpu_torch/ops/csrc/{exact_source}",
                         exact_f32_ms=exact.get("ms"),
                         exact_f32_max_abs_err=exact.get("max_abs_err"))
        if matmul:
            big = main_recs.get(f"{name}/m1024", {})
            entry.update({f"m1024_{k}": big.get(k) for k in ("ms", "library_ms", "bound_ms",
                                                              "bound_by")})
        if name == "paged_prefill":  # K3 on the verify and mixed paths (phase 10)
            verify = main_recs.get("paged_prefill/verify", {})
            entry.update(verify_launches=fused_launches.get("verify"),
                         mixed_launches=fused_launches.get("mixed"),
                         **{f"verify_shape_{k}": verify.get(k) for k in (
                             "ms", "library_ms", "bound_ms", "bound_by", "plain_ms",
                             "k1_same_contexts_ms")})
        if name in ("paged_decode", "flash_prefill"):  # phase 11 (a): restored rows
            entry["snapshot_launches"] = snapshot_launches.get(name)
        if name in prefix_kv_launches:  # phase 12: (a) K3, K4; (c) in process K1, K2
            entry["prefix_kv_launches"] = prefix_kv_launches[name]
        if name in policy_launches:  # phase 13 (a): the worker under chaos
            entry["failure_policy_launches"] = policy_launches[name]
        if name in ("paged_decode", "flash_prefill") and pipeline_launches:  # phase 14
            entry["pipeline_launches"] = {stage: n[name] for stage, n in pipeline_launches.items()}
        if name in peers_launches:  # phase 15: (a) K3, K4; (b) K1, K2
            entry["peers_launches"] = peers_launches[name]
        if name in gateway_launches:  # phase 16: the worker behind the gateway
            entry["gateway_launches"] = gateway_launches[name]
        if name in faults_launches:  # phase 17: K1, K2 over the legs; K3, K4 in (e)
            entry["faults_launches"] = faults_launches[name]
        if any(name in n for n in moe_launches.values()):  # phase 18: K1, K2, K6 by dtype
            entry["moe_launches"] = {dtype: n[name] for dtype, n in moe_launches.items()
                                     if name in n}
            entry["moe_shapes"] = {
                key.split("/", 1)[1]: {k: r.get(k) for k in ("ms", "plain_ms", "library_ms",
                                                             "bound_ms", "bound_by",
                                                             "max_abs_err")}
                for key, r in moe_recs.items()
                if key.startswith(name + "/") and not key.endswith("/exact")}
        if name == "int8_matmul":
            head = main_recs.get("int8_matmul/head", {})
            entry.update({f"llama_head_{k}": head.get(k) for k in ("ms", "library_ms", "bound_ms",
                                                                    "bound_by")})
        kernels.append(entry)
    if EVENT_TIMED:
        emit(dict(phase="timing", event_timed=EVENT_TIMED,
                  note="torch.profiler traced these windows empty; CUDA events timed them"))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
