"""Inference engine: continuous batching, decode dispatches as CUDA graphs.

Port of ``llmq_tpu/engine/engine.py``: ``EngineConfig`` (:166),
``RequestOutput`` (:145), the ``EngineCore`` step loop (bucketed
whole-prompt prefill padded to 1 or ``max_prefill_batch`` rows, or
chunked prefill with an optional prefix cache (``_prefill_chunked``
:3301); a run-ahead pipeline of ``runahead`` decode dispatches with
deferred page frees, device-side sampling and stopping plus host-side
stop strings, recompute preemption) and ``AsyncEngine`` with its engine
thread. The fused dispatch modes (M10): ``decode_block`` K decode
iterations a dispatch (``decode_block_step`` :1375), speculative decoding
(``spec_tokens`` drafts from the on-device n-gram drafter
:func:`draft_lookup`, verified K iterations a dispatch through K3:
``verify_step`` :1445) and mixed steps (``mixed_step="on"``: a prompt's
chunk segments ride in the decode dispatches, ``mixedfill_step`` :1666,
``_prefill_mixed`` :3412), composed as the JAX engine composes them.

Request-state plane (M11). ``extract_request`` / ``extract_all`` (:4147,
:4174) pull requests out as ``engine/snapshot.py`` snapshots (KV pages
gathered to the host after the run-ahead is drained: one
``index_select`` and one copy a pool) and ``insert_request`` (:4323)
puts them back, here or on another engine or package: it checks the
model signature and the key chain, repacks across page sizes and refuses
duplicates, and admission then writes the pages back into the pools in
place (``index_copy_``; the captured graphs keep the pools' addresses)
instead of prefilling. ``preempt_mode="swap"`` (``LLMQ_PREEMPT_MODE``)
captures a preempted row's pages to the host at its deferred-release
watermark and restores them on re-admission. Deadlines (``deadline_at``,
swept between steps) and the priority classes (interactive waiters
admitted first; ``priority_preempt`` evicts the youngest batch row for
one; ``interactive_decode_block`` dispatches a small-K block, its own
captured graph, while an interactive row is resident) follow :2569-2680.
``AsyncEngine`` adds ``resume``, ``handoff`` (drain-with-handoff,
:5044), token callbacks and ``call_on_engine``.

Prefix-KV plane (M11b). ``prefix_host_gb`` (``LLMQ_PREFIX_HOST_GB`` pins
over it; it needs ``enable_prefix_caching``, JAX :775-811) turns on the
host prefix tier (``engine/prefix_store.py``): a cache page the allocator
evicts is gathered to host RAM (``_demote_page``), and admission extends a
device prefix match from it, writing the host pages into the fresh pages
in place before the wave's first dispatch (``_promote_host_pages``,
:3012-3065). ``flush_prefix_to_host`` and ``export_prefix_chunks`` /
``ingest_prefix_chunks`` (pages shipped between engines in the chunk wire
form) follow :3055-3120 and ``missing_prefix_digests`` (a worker's
want-list before it fetches a prefix from a peer) :3127-3141, with the
three ``AsyncEngine`` wrappers (:5127-5160) that run them on the engine
thread. (The reference's ``hot_prefix_chains`` has no caller: its
workers advertise the chains their jobs walked.) ``add_request(prefill_only=True)`` stops a request at the
prefill boundary (:3866-3880): its first sampled token is dropped, the
prompt KV is snapshotted and it finishes as ``"prefill_done"`` with the
snapshot on ``RequestOutput.snapshot``; a decode engine adopts it through
``insert_request``.

Device decode state. The 12 leaves of the JAX state (:1300) live in
static device tensors — tokens, ctx, block tables, active, two-word
threefry keys, steps, temps, top-k, top-p, limits, min-tokens, stop ids,
and with speculation a 13th, the history ``[S, max_model_len + 1]`` (the
drafter's corpus; its last column takes the writes JAX drops) — written
in place by every dispatch, by the prefill scatter and by the resync, so
steady-state decode ships nothing host→device. On the card each
decode-type dispatch is one replay of a captured CUDA graph
(``engine/graphs.py``), one graph per (dispatch kind, sampling mode,
stop suppression, iterations); ``EngineCore(cuda_graphs=False)`` dispatches eagerly
instead, and the CPU always does. A dispatch's tokens go to pinned host
memory with ``non_blocking=True`` and a ``torch.cuda.Event``; the host
reads them ``runahead`` dispatches later. Prefill stays eager.

Observability (JAX :1060-1212). TTFT and ITL histograms, unlabeled and
``class="interactive"`` (observed where JAX observes them, :3880-3899),
the scheduler's queue-wait and preemption-delay histograms, one
``llmq_dispatch_seconds{kind=...}`` histogram and 256-entry ring per
dispatch kind (``prefill``, ``mixed``, ``decode_block`` or ``verify``, each
with ``_small`` for the interactive small block: :meth:`_record_dispatch`,
the host span of launching the dispatch, a CUDA-graph replay included,
never synchronized) and the engine's gauges, all registered in the
process's metrics registry (``obs/metrics.py``); ``stats()`` carries their
percentiles (``ttft_*``, ``itl_*``, ``dispatch_ms``, ``queue_wait_*``, the
interactive ones once an interactive request arrived). The three
``llmq_integrity_*`` gauges read the fault planes' counters.

Fault planes (M12). ``watchdog_mult`` > 0 starts a
``engine/watchdog.py::DispatchWatchdog``: every device call is bracketed
(:meth:`_wd`, at the reference's kinds: ``prefill``, ``mixed``,
``decode_block`` / ``verify`` and their ``_small``, ``guard``,
``snapshot_gather``, ``weight_audit``, ``kv_spot``), the fetch bracket
around the drain's ``event.synchronize()``, where a wedged kernel blocks
the engine thread. ``logit_guard="on"`` folds
``ops/dispatch.py::logit_guard_stats`` into every step function, inside
the captured graphs too (their static outputs, copied home with the
tokens; thresholds fixed at build, as JAX traces them); the drain raises
``LogitGuardError`` with the suspects before it appends a token
(:meth:`_eval_guard`, JAX :2839). ``weight_audit_every`` /
``canary_every`` record a weight digest and a golden greedy canary at
build and re-check them between batches (:meth:`maybe_idle_integrity`,
JAX :4429-4610). ``on_dispatch(kind)`` (JAX :3771) is the injectors'
hook. For recovery: :meth:`degrade_for_oom` (the OOM ladder),
:meth:`extract_for_rebuild` (per-row isolated snapshots), and
:meth:`release`, which frees the graphs, pools and weights so that a
rebuilt core fits beside nothing. ``AsyncEngine`` classifies a failed
step (``core/faults.py``) and contains it as JAX :5166-5560 does: the
ladder for a first OOM, else ``rebuild_core()`` (wired by the worker)
and every row re-inserted from its snapshot; a numerical fault puts its
suspects on probation and a re-trip convicts them as poison. Where the
rebuild itself fails (a CUDA error is sticky: every later call in the
process fails), the step's futures fail with ``DeviceFaultError`` and
``error`` is set, which stops the port's worker (ROADMAP.md queue 3); the
reference keeps consuming there.

Config. The engine honours ``max_num_seqs``, ``max_model_len``,
``page_size``, ``num_pages``, ``hbm_utilization``, ``kv_dtype`` (bf16,
f32 or fp8 = float8_e5m2), ``min_prefill_bucket``, ``max_prefill_batch``,
``prefill_chunk_size``, ``enable_prefix_caching`` (chunked prefill only,
as in JAX), ``admit_max_wait_s``, ``runahead``, ``decode_block``,
``spec_tokens``, ``spec_ngram``, ``stop_id_capacity``, ``mixed_step``
(``LLMQ_MIXED_STEP`` pins over it; it needs ``prefill_chunk_size``),
``preempt_mode``, ``priority_classes``, ``priority_preempt`` and
``interactive_decode_block`` (each pinned by its ``LLMQ_*`` variable, as
in JAX :733-774), ``prefix_host_gb`` and the fault planes' fields
``watchdog_mult``, ``watchdog_min_s``, ``logit_guard``,
``guard_logit_max``, ``guard_entropy_min``, ``weight_audit_every`` and
``canary_every`` (each pinned by its ``LLMQ_*`` variable, JAX :816-890).
``tp_overlap`` set away from its default raises ``NotImplementedError``
naming its ROADMAP.md item, and so does ``LLMQ_ACT_STATS`` turned on
(the reference's activation taps, which need host callbacks from inside
compiled code).
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import logging
import os
import queue
import threading
import time
import traceback
import weakref
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from llmq_tpu_torch.core.faults import (
    FAULT_NUMERICAL,
    FAULT_OOM,
    DeviceFaultError,
    LogitGuardError,
    classify_failure,
)
from llmq_tpu_torch.device import DeviceLike, resolve_device
from llmq_tpu_torch.engine import integrity as integrity_mod
from llmq_tpu_torch.engine import sampling as sampling_mod
from llmq_tpu_torch.engine import prefix_store as prefix_mod
from llmq_tpu_torch.engine import snapshot as snapshot_mod
from llmq_tpu_torch.engine.graphs import DispatchGraphs
from llmq_tpu_torch.engine.sampling import (
    SamplingParams,
    make_base_key,
    request_tag,
    sample_tokens,
    spec_verify_tokens,
    step_gumbel,
)
from llmq_tpu_torch.engine.scheduler import (
    OutOfPages,
    Scheduler,
    SchedulerConfig,
    Sequence,
    mixed_token_budget,
)
from llmq_tpu_torch.engine.snapshot import KVRestore, RequestSnapshot, SnapshotCompatError
from llmq_tpu_torch.engine.tokenizer import Tokenizer
from llmq_tpu_torch.engine.watchdog import NO_GUARD, DispatchWatchdog
from llmq_tpu_torch.models import quant as qm
from llmq_tpu_torch.models.config import ModelConfig
from llmq_tpu_torch.obs.metrics import DEFAULT_BUCKETS, Gauge, Histogram, get_registry, to_ms
from llmq_tpu_torch.models.transformer import (Params, Transformer, _unflatten, make_kv_pages,
                                               moe_transient_bytes)
from llmq_tpu_torch.ops.attention import mixed_query_grid
from llmq_tpu_torch.ops.dispatch import (
    decode_kernel_plan,
    logit_guard_stats,
    mixed_kernel_plan,
    verify_kernel_plan,
)
from llmq_tpu_torch.obs.trace import emit_trace_event
from llmq_tpu_torch.utils.host_mem import get_governor

logger = logging.getLogger(__name__)

#: Cancellations for rids the engine doesn't hold age out after this long.
_CANCEL_TTL_S = 5.0

#: ITL buckets: the latency defaults plus a sub-millisecond low end, where
#: the tokens of one fused decode block reach the host in a burst.
ITL_BUCKETS: Tuple[float, ...] = (0.0001, 0.00025, 0.0005) + DEFAULT_BUCKETS

#: Recent dispatch host spans kept per kind (``stats()["dispatch_ms"]``).
DISPATCH_RING = 256


@dataclasses.dataclass
class RequestOutput:
    """Final result of one generation request."""

    rid: str
    text: str
    token_ids: List[int]
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str  # "stop" | "length" | "cancelled" | "aborted" ...
    # Host-side monotonic lifecycle stamps (enqueued/admitted/
    # prefill_start/first_token/last_token/finished + preempt_count).
    timing: Optional[Dict[str, float]] = None
    # A prefill-only request (finish_reason="prefill_done") carries its
    # prompt-KV snapshot here for the decode-pool handoff; None otherwise.
    snapshot: Optional[RequestSnapshot] = None


# The JAX EngineConfig's name table: "fp8" is float8_e5m2, stored without
# scales (e5m2 keeps bf16's exponent range), half the bytes of bf16.
_KV_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp8": torch.float8_e5m2,
    "fp8_e5m2": torch.float8_e5m2,
    "float8_e5m2": torch.float8_e5m2,
    "f32": torch.float32,
    "float32": torch.float32,
}


@dataclasses.dataclass
class EngineConfig:
    """Field for field the JAX ``EngineConfig``; see the module docstring
    for which fields this engine honours. Descriptions of the others are
    in ``llmq_tpu/engine/engine.py``."""

    max_num_seqs: int = 64
    max_model_len: int = 4096
    page_size: int = 32
    num_pages: Optional[int] = None  # None → size from device memory
    hbm_utilization: float = 0.9
    kv_dtype: Any = torch.bfloat16  # bf16 | f32 | fp8 (float8_e5m2)
    min_prefill_bucket: int = 32
    max_prefill_batch: int = 4  # admitted seqs prefilled per dispatch
    prefill_chunk_size: Optional[int] = None
    enable_prefix_caching: bool = False
    # Admission waits for a full prefill batch of free slots, but never
    # defers admissible work for longer than this.
    admit_max_wait_s: float = 0.5
    runahead: int = 8  # decode dispatches in flight ahead of result reads
    decode_block: int = 1
    spec_tokens: int = 0
    spec_ngram: int = 2
    # Per-slot device-side stop-token-id capacity; grows (resync at the
    # wider shape) when a request's stop set exceeds it.
    stop_id_capacity: int = 8
    tp_overlap: str = "off"
    mixed_step: str = "off"
    preempt_mode: str = "recompute"
    priority_classes: bool = True
    priority_preempt: bool = True
    interactive_decode_block: int = 0
    prefix_host_gb: float = 0.0
    watchdog_mult: float = 0.0
    watchdog_min_s: float = 30.0
    logit_guard: str = "off"
    guard_logit_max: float = 0.0
    guard_entropy_min: float = 0.0
    weight_audit_every: float = 0.0
    canary_every: float = 0.0

    def __post_init__(self):
        # The JAX EngineConfig's checks of the fields this engine honours.
        for name, lowest in (("decode_block", 1), ("spec_tokens", 0), ("spec_ngram", 1),
                             ("interactive_decode_block", 0)):
            setattr(self, name, int(getattr(self, name)))
            if getattr(self, name) < lowest:
                raise ValueError(f"{name}={getattr(self, name)} (want >= {lowest})")
        self.mixed_step = str(self.mixed_step).lower()
        if self.mixed_step not in ("off", "on"):
            raise ValueError(f"mixed_step={self.mixed_step!r} (want off|on)")
        self.preempt_mode = str(self.preempt_mode).lower()
        if self.preempt_mode not in ("recompute", "swap"):
            raise ValueError(f"preempt_mode={self.preempt_mode!r} (want recompute|swap)")
        if isinstance(self.kv_dtype, str):
            try:
                self.kv_dtype = _KV_DTYPES[self.kv_dtype.lower()]
            except KeyError:
                raise ValueError(
                    f"kv_dtype={self.kv_dtype!r} (want one of {sorted(_KV_DTYPES)})"
                ) from None
        if self.kv_dtype not in set(_KV_DTYPES.values()):
            raise ValueError(f"kv_dtype={self.kv_dtype} (want bf16, f32 or fp8)")
        self.prefix_host_gb = float(self.prefix_host_gb)
        if self.prefix_host_gb < 0:
            raise ValueError(f"prefix_host_gb={self.prefix_host_gb} (want >= 0)")
        # The fault planes' fields (JAX :388-421).
        for name in ("watchdog_mult", "guard_logit_max", "guard_entropy_min",
                     "weight_audit_every", "canary_every"):
            setattr(self, name, float(getattr(self, name)))
            if getattr(self, name) < 0:
                raise ValueError(f"{name}={getattr(self, name)} (want >= 0)")
        self.watchdog_min_s = float(self.watchdog_min_s)
        if self.watchdog_min_s <= 0:
            raise ValueError(f"watchdog_min_s={self.watchdog_min_s} (want > 0)")
        self.logit_guard = str(self.logit_guard).lower()
        if self.logit_guard not in ("off", "on"):
            raise ValueError(f"logit_guard={self.logit_guard!r} (want off|on)")


#: Fields of EngineConfig this engine does not honour yet → the ROADMAP.md
#: queue 1 item that brings them.
_UNPORTED_FIELDS = {
    "tp_overlap": "M13",
}

#: Hard ceiling on one in-process fault recovery (extract, free, rebuild,
#: re-insert; JAX :4896): past it the process is wedged beyond in-process
#: recovery and exits, so the janitor reclaims its queue and its jobs
#: requeue.
REBUILD_HARD_EXIT_S = 180.0


def _env_flag(name: str, default: bool) -> bool:
    """A boolean variable that pins over its config field (JAX :743-760)."""
    value = os.environ.get(name, "").lower()
    if value in ("0", "false", "no", "off"):
        return False
    if value in ("1", "true", "yes", "on"):
        return True
    return default


def priority_settings(cfg: EngineConfig) -> Tuple[bool, bool, int]:
    """``(priority_classes, priority_preempt, interactive_decode_block)``:
    each ``LLMQ_*`` variable pins over its field, and the small interactive
    block is 0 without the classes (JAX :743-774). The engine is the one
    reader of ``LLMQ_PRIORITY_PREEMPT`` and ``LLMQ_INTERACTIVE_DECODE_BLOCK``."""
    classes = _env_flag("LLMQ_PRIORITY_CLASSES", cfg.priority_classes)
    preempt = _env_flag("LLMQ_PRIORITY_PREEMPT", cfg.priority_preempt)
    ik = cfg.interactive_decode_block
    env_ik = os.environ.get("LLMQ_INTERACTIVE_DECODE_BLOCK", "").strip()
    if env_ik:
        try:
            ik = int(env_ik)
        except ValueError:
            raise ValueError(
                f"LLMQ_INTERACTIVE_DECODE_BLOCK={env_ik!r} is not an int") from None
    if ik < 0:
        raise ValueError(f"interactive_decode_block={ik} (want >= 0)")
    return classes, preempt, ik if classes else 0


def _env_number(name: str, default: float) -> float:
    """A numeric variable that pins over its config field (JAX :816-890)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


def _check_ported(cfg: EngineConfig) -> None:
    act = os.environ.get("LLMQ_ACT_STATS", "").lower()
    if act in ("1", "true", "yes", "on"):
        raise NotImplementedError(
            f"LLMQ_ACT_STATS={act!r} (the activation-stat taps) is not ported yet "
            "(ROADMAP.md queue 1, M12b)"
        )
    defaults = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    for name, item in _UNPORTED_FIELDS.items():
        value = getattr(cfg, name)
        if value != defaults[name]:
            raise NotImplementedError(
                f"EngineConfig.{name}={value!r} is not ported yet "
                f"(ROADMAP.md queue 1, {item})"
            )


def _prefill_buckets(cfg: EngineConfig) -> List[int]:
    """Prompt buckets up to max_model_len: powers of two, plus quarter
    steps between octaves above 128 (a 200-token prompt pads to 224, not
    256), and max_model_len itself on top."""
    buckets = []
    b = cfg.min_prefill_bucket
    while b < cfg.max_model_len:
        buckets.append(b)
        if b >= 128:
            for quarter in (b + b // 4, b + b // 2, b + 3 * b // 4):
                if quarter < cfg.max_model_len:
                    buckets.append(quarter)
        b *= 2
    buckets.append(cfg.max_model_len)
    return sorted(set(buckets))


# Pipeline entry: (dispatch index, kind, host token buffers (one tensor, two
# for verify, none for a chunk that only carries its guard fold), copy-done
# event or None, [(row, Sequence, epoch), ...], per-row first valid
# iteration of a mixed block or None, host guard fold (stats, bad) or None).
_Pending = Tuple[int, str, Tuple[Any, ...], Optional[Any], List[Tuple[int, Sequence, int]],
                 Optional[np.ndarray], Optional[Tuple[Any, Any]]]
# Kinds that run decode iterations (each counts in the page lookahead).
_DECODE_KINDS = ("decode", "verify", "mixed")
# The watchdog kind of the fetch that waits for a dispatch's tokens (JAX
# :2763-2814).
_FETCH_KIND = {"decode": "decode_block", "verify": "verify", "mixed": "mixed",
               "prefill": "prefill"}

# Device decode state, leaf order as in JAX (:1300); speculation appends
# "history".
_STATE_LEAVES = (
    "tokens", "ctx", "bt", "active", "keys", "steps",
    "temps", "topks", "topps", "limits", "mins", "stop_ids", "history",
)


def advance_state(st: tuple, out: torch.Tensor, active: torch.Tensor) -> tuple:
    """One decode step's state update, on the device: count the step,
    deactivate rows that hit a stop id (past min_tokens) or their limit."""
    (tokens, ctx, bt, _, keys, steps, temps, topks, topps,
     limits, mins, stop_ids) = st
    act = active.to(steps.dtype)
    new_steps = steps + act
    hit_stop = (out[:, None] == stop_ids).any(dim=1) & (new_steps > mins)
    hit_limit = new_steps >= limits
    still = active & ~(hit_stop | hit_limit)
    return (
        torch.where(active, out, tokens),
        ctx + act,
        bt,
        still,
        keys,
        new_steps,
        temps,
        topks,
        topps,
        limits,
        mins,
        stop_ids,
    )


def suppress_stops(
    logits: torch.Tensor, stop_ids: torch.Tensor, steps: torch.Tensor, mins: torch.Tensor
) -> torch.Tensor:
    """Mask stop/EOS logits of rows still under min_tokens, so the
    forbidden token can never be sampled (vLLM semantics). No host sync:
    padding ids (-1) route to a dropped extra column."""
    S, V = logits.shape
    ids = torch.where(stop_ids < 0, V, stop_ids).long()
    hit = torch.zeros((S, V + 1), dtype=torch.bool, device=logits.device)
    hit.scatter_(1, ids, True)
    block = hit[:, :V] & (steps < mins)[:, None]
    return torch.where(block, sampling_mod.NEG_INF, logits)


def draft_lookup(history: torch.Tensor, ctx: torch.Tensor, n_draft: int,
                 n_gram: int) -> torch.Tensor:
    """On-device prompt-lookup drafter (JAX ``draft_lookup``, :1412): the
    ``n_draft`` tokens that followed the most recent earlier occurrence of
    the ``n_gram``-token suffix ending at ``history[ctx]``, per row of
    ``history`` [S, M]; -1 where there is no match (or fewer than
    ``n_gram`` tokens so far), which never equals an emitted token."""
    S, M = history.shape
    dev = history.device
    sfx_pos = ctx[:, None] - (n_gram - 1) + torch.arange(n_gram, device=dev)
    sfx = torch.gather(history, 1, sfx_pos.clamp(0, M - 1).long())  # [S, n_gram]
    match = torch.ones((S, M), dtype=torch.bool, device=dev)
    for t in range(n_gram):
        # Shifted so position p asks whether the n-gram ENDING at p matches.
        match &= torch.roll(history == sfx[:, t : t + 1], (n_gram - 1) - t, dims=1)
    p_idx = torch.arange(M, device=dev)[None, :]
    match &= (p_idx >= n_gram - 1) & (p_idx < ctx[:, None]) & (ctx[:, None] + 1 >= n_gram)
    j = torch.where(match, p_idx, -1).amax(dim=1)  # [S]
    d_pos = j[:, None] + 1 + torch.arange(n_draft, device=dev)[None, :]
    drafts = torch.gather(history, 1, d_pos.clamp(0, M - 1).long())
    return torch.where((j >= 0)[:, None], drafts, -1)


def _assign(leaves, values) -> None:
    """Write each new value into its static leaf (a leaf passed through
    unchanged is left alone)."""
    for leaf, value in zip(leaves, values):
        if value is not leaf:
            leaf.copy_(value)


class EngineCore:
    """Synchronous engine: owns the device state and the step loop body.

    ``cuda_graphs`` (on the card): each decode-type dispatch is one
    captured CUDA graph's replay; False dispatches the same work eagerly.
    The CPU always dispatches eagerly."""

    def __init__(
        self,
        model_config: ModelConfig,
        params: Params,
        tokenizer: Tokenizer,
        *,
        engine_config: Optional[EngineConfig] = None,
        device: DeviceLike = "cuda",
        cuda_graphs: bool = True,
    ) -> None:
        self.device = resolve_device(device)
        self.model_config = model_config
        self.tokenizer = tokenizer
        self.cfg = engine_config or EngineConfig()
        _check_ported(self.cfg)
        if self.cfg.enable_prefix_caching and not self.cfg.prefill_chunk_size:
            raise ValueError(
                "enable_prefix_caching requires prefill_chunk_size: only chunked "
                "prefill can start mid-prompt (the bucketed prefill always computes "
                "positions 0..T)"
            )
        # The variable pins over the config, as in the JAX engine (:733).
        mixed = os.environ.get("LLMQ_MIXED_STEP", "").strip().lower()
        self.mixed_step = mixed if mixed in ("on", "off") else self.cfg.mixed_step
        if self.mixed_step == "on" and not self.cfg.prefill_chunk_size:
            raise ValueError(
                "mixed_step=on requires prefill_chunk_size: the fused dispatch "
                "piggybacks a prefill *chunk* onto the decode batch (bucketed "
                "whole-prompt prefill has no chunks)"
            )
        # Swap preemption and the priority classes: each variable pins over
        # its field, as in the JAX engine (:737-774).
        preempt = os.environ.get("LLMQ_PREEMPT_MODE", "").lower()
        self.preempt_mode = preempt if preempt in ("recompute", "swap") else self.cfg.preempt_mode
        (self.priority_classes, self.priority_preempt,
         self.interactive_decode_block) = priority_settings(self.cfg)
        self._spec = self.cfg.spec_tokens > 0
        # The fault planes: each variable pins over its field (JAX
        # :816-890). The guard and its thresholds are fixed here, as JAX
        # traces them into its programs.
        self.watchdog_mult = _env_number("LLMQ_WATCHDOG_MULT", self.cfg.watchdog_mult)
        self.watchdog_min_s = _env_number("LLMQ_WATCHDOG_MIN_S", self.cfg.watchdog_min_s)
        self.watchdog: Optional[DispatchWatchdog] = None
        guard = os.environ.get("LLMQ_LOGIT_GUARD", "").lower()
        self.logit_guard = guard if guard in ("on", "off") else self.cfg.logit_guard
        self._guard = self.logit_guard == "on"
        self.guard_logit_max = _env_number("LLMQ_GUARD_LOGIT_MAX", self.cfg.guard_logit_max)
        self.guard_entropy_min = _env_number("LLMQ_GUARD_ENTROPY_MIN",
                                             self.cfg.guard_entropy_min)
        self.weight_audit_every = _env_number("LLMQ_WEIGHT_AUDIT_EVERY",
                                              self.cfg.weight_audit_every)
        self.canary_every = _env_number("LLMQ_CANARY_EVERY", self.cfg.canary_every)
        # Called on the engine thread as (kind) after every dispatch, inside
        # its watchdog bracket (the chaos injectors' hook, JAX :3771).
        self.on_dispatch: Optional[Any] = None
        self.model = Transformer(model_config, params).to(self.device)
        self._decode_kernel = self.model.decode_kernel
        self._vocab = model_config.vocab_size

        num_pages = self.cfg.num_pages or self._auto_num_pages()
        sched_cfg = SchedulerConfig(
            max_num_seqs=self.cfg.max_num_seqs,
            num_pages=num_pages,
            page_size=self.cfg.page_size,
            max_model_len=self.cfg.max_model_len,
            enable_prefix_caching=self.cfg.enable_prefix_caching,
        )
        self.scheduler = Scheduler(sched_cfg)
        self.scheduler.on_preempt = self._on_scheduler_preempt
        self._pages_per_seq = sched_cfg.pages_per_seq
        self.k_pages, self.v_pages = make_kv_pages(
            model_config, num_pages, self.cfg.page_size,
            dtype=self.cfg.kv_dtype, device=self.device,
        )
        logger.info(
            "KV cache: %d pages x %d tokens (%.2f GiB total), %d slots on %s",
            num_pages, self.cfg.page_size,
            2 * self.k_pages.numel() * self.k_pages.element_size() / 2**30,
            self.cfg.max_num_seqs, self.device,
        )
        self._kv_name = snapshot_mod.dtype_name(self.k_pages.dtype)
        # The host prefix tier: the variable pins over the config (JAX
        # :775-811); hooked up before the first request, so the allocator's
        # evictions demote from the start.
        host_gb = self.cfg.prefix_host_gb
        env_gb = os.environ.get("LLMQ_PREFIX_HOST_GB", "").strip()
        if env_gb:
            try:
                host_gb = float(env_gb)
            except ValueError:
                raise ValueError(f"LLMQ_PREFIX_HOST_GB={env_gb!r} is not a number") from None
        self.prefix_host_gb = host_gb
        self.prefix_store: Optional[prefix_mod.PrefixStore] = None
        if host_gb > 0:
            if not self.cfg.enable_prefix_caching:
                raise ValueError(
                    "prefix_host_gb > 0 requires enable_prefix_caching: the host tier "
                    "extends the device prefix cache (there is nothing to demote without it)"
                )
            self.prefix_store = prefix_mod.PrefixStore(
                int(host_gb * 2**30), page_size=self.cfg.page_size, model_sig=self._model_sig())
            self.scheduler.on_demote = self._demote_page
            self.scheduler.host_lookup = self.prefix_store.match_chain
            logger.info("prefix host tier: %.2f GiB budget (%d-token pages)", host_gb,
                        self.cfg.page_size)
        self._eos_ids = set(model_config.eos_token_ids) | set(tokenizer.eos_token_ids)
        self._buckets = _prefill_buckets(self.cfg)

        # Host mirrors of the device decode state, rebuilt at every resync.
        S = self.cfg.max_num_seqs
        self._stop_capacity = self.cfg.stop_id_capacity
        self._h_tokens = np.zeros((S,), np.int32)
        self._h_ctx = np.zeros((S,), np.int32)
        self._h_bt = np.zeros((S, self._pages_per_seq), np.int32)
        self._h_active = np.zeros((S,), bool)
        self._h_keys = np.zeros((S, 2), np.int64)  # threefry key data (uint32 words)
        self._h_steps = np.zeros((S,), np.int32)
        self._h_temp = np.zeros((S,), np.float32)
        self._h_topk = np.zeros((S,), np.int32)
        self._h_topp = np.ones((S,), np.float32)
        self._h_limits = np.zeros((S,), np.int32)
        self._h_mins = np.zeros((S,), np.int32)
        self._h_stopids = np.full((S, self._stop_capacity), -1, np.int32)
        # Speculation only: prompt + output tokens per slot, history[ctx] the
        # current token; the last column takes the writes JAX drops.
        self._h_history = (np.zeros((S, self.cfg.max_model_len + 1), np.int32)
                           if self._spec else None)
        self._max_kv_pos = self._pages_per_seq * self.cfg.page_size
        self._mixed_in: Optional[Dict[str, torch.Tensor]] = None
        self._graphs = (DispatchGraphs(self.device)
                        if cuda_graphs and self.device.type == "cuda" else None)

        # Run-ahead pipeline state.
        self._pending: Deque[_Pending] = deque()
        self._pending_decodes = 0
        self._defer_since: Optional[float] = None
        # (dispatch watermark, pages, leading cacheable count)
        self._deferred_pages: List[Tuple[int, List[int], int]] = []
        # Swap captures awaiting their deferred-release watermark: (dispatch
        # watermark, seq, pages, KV positions, epoch at the preemption),
        # gathered to the host before those pages return to the allocator.
        self._pending_swaps: List[Tuple[int, Sequence, List[int], int, int]] = []
        self._dispatch_idx = 0
        self._processed_idx = 0
        self._dirty = True
        self._mode = "greedy"
        self._suppress = False  # some resident row has min_tokens > 0
        self._dev_state: Optional[tuple] = None
        self._cancel_rids: Dict[str, float] = {}
        # Called on the engine thread as (seq, token) for every token that
        # survives the stop check (AsyncEngine's token callbacks).
        self.on_token: Optional[Any] = None
        # Flipped by the first deadline-carrying / interactive request, so
        # deployments without them keep the exact sweep-free FIFO path.
        self._deadlines_enabled = False
        self._priority_enabled = False

        # Counters for stats/heartbeats.
        self.total_prompt_tokens = 0
        self.total_generated_tokens = 0
        self.decode_steps = 0
        self.decode_dispatches = 0
        self.prefills = 0
        self.prefill_dispatches = 0
        self.prefill_tokens = 0
        self.cancellations = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.mixed_steps = 0
        self.mixed_prefill_tokens = 0
        self.swap_preempts = 0  # preemptions whose KV went to the host
        self.swap_refused = 0  # captures the host-memory governor declined
        self.kv_restores = 0  # admissions that wrote host KV back
        self.snapshots_extracted = 0
        self.snapshots_inserted = 0
        self.prefill_done = 0  # prefill-only requests finished at the boundary
        # rid -> the snapshot taken at the prefill boundary, popped by
        # _output_for when the finished RequestOutput is built.
        self._prefill_snapshots: Dict[str, RequestSnapshot] = {}
        self.prefix_demotes = 0  # pages parked in the host tier on eviction
        self.prefix_promotes = 0  # pages written back from the host tier
        self.prefix_chunks_exported = 0  # pages serialized for peers
        self.prefix_chunks_ingested = 0  # shipped pages accepted
        self.deadline_expirations = 0
        self.priority_preemptions = 0  # batch rows evicted for interactive ones
        # Finished cleanly ("stop" / "length") and tokens, by class.
        self.class_finished = {"interactive": 0, "batch": 0}
        self.class_tokens = {"interactive": 0, "batch": 0}
        self.hbm_oom_events = 0  # allocation faults the ladder absorbed
        # The integrity plane's counters (their stats keys appear once the
        # knobs are on or the counters moved).
        self.guard_trips = 0  # dispatches whose guard fired
        self.weight_audits = 0
        self.weight_audit_mismatches = 0  # leaves whose digest changed
        self.kv_spot_checks = 0
        self.canary_runs = 0
        self.canary_failures = 0  # replays that were not bit-exact
        self._last_audit_mismatch: List[str] = []  # replaced by each audit
        self._weight_baseline: Optional[Dict[str, Tuple[int, int]]] = None
        self._canary_golden: Optional[List[int]] = None
        self._next_weight_audit = 0.0
        self._next_canary = 0.0
        # The OOM ladder's position (0 -> 3, never reset) and the rungs
        # taken, in order (at most three entries).
        self._oom_rung = 0
        self._oom_ladder_log: List[str] = []
        self._started_at = time.monotonic()
        self._register_metrics()

        # The swap blobs and the prefix tier report into the shared budget
        # (names per engine, so several engines in one process coexist).
        self._gov_names: List[str] = []
        gov = get_governor()
        if gov.enabled:
            tag = f"engine-{id(self):x}"
            gov.register(f"swap:{tag}", self._swap_restore_bytes)
            self._gov_names.append(f"swap:{tag}")
            if self.prefix_store is not None:
                store = self.prefix_store
                gov.register(f"prefix:{tag}", lambda: store.occupancy_bytes,
                             evict_fn=store.evict_bytes)
                self._gov_names.append(f"prefix:{tag}")

        self._resync()

        # The watchdog reads the per-kind histograms, so it starts last
        # (JAX :1218-1233); the baselines follow, on a working engine.
        if self.watchdog_mult > 0:
            self.watchdog = DispatchWatchdog(mult=self.watchdog_mult,
                                             min_s=self.watchdog_min_s,
                                             percentile_fn=self._dispatch_p99)
            logger.info("dispatch watchdog: p99 x %.1f, floor %.1fs", self.watchdog_mult,
                        self.watchdog_min_s)
        if self.weight_audit_every > 0:
            with self._wd("weight_audit"):
                self._weight_baseline = integrity_mod.digest_params(self.params)
            self._next_weight_audit = time.monotonic() + self.weight_audit_every
            logger.info("weight audit: %d leaves digested, sweeping every %.1fs",
                        len(self._weight_baseline), self.weight_audit_every)
        if self.canary_every > 0:
            self._canary_golden = self._generate_canary()
            self._next_canary = time.monotonic() + self.canary_every
            logger.info("canary self-test: %d golden tokens, replaying every %.1fs",
                        len(self._canary_golden), self.canary_every)

    @property
    def params(self) -> Params:
        """The parameter tree (the JAX layout: ``embed``, ``final_norm``,
        ``lm_head``, ``layers``), over the model's own tensors."""
        return {**_unflatten(self.model.top), "layers": _unflatten(self.model.layers)}

    def _dispatch_p99(self, kind: str) -> Optional[float]:
        """The watchdog's deadline source: the p99 host span of one dispatch
        kind, or None (the floor) before any landed."""
        hist = self._dispatch_hists.get(kind)
        return None if hist is None else hist.percentile(0.99)

    def _wd(self, kind: str):
        """The watchdog bracket of one device call; the shared no-op
        context with the watchdog off (the default)."""
        wd = self.watchdog
        return NO_GUARD if wd is None else wd.guard(kind)

    def stop_watchdog(self) -> None:
        """Stop the monitor thread (teardown, fault rebuild)."""
        if self.watchdog is not None:
            self.watchdog.stop()

    def _register_metrics(self) -> None:
        """The engine's histograms and gauges (JAX :1060-1212): host-side
        only, a bucket increment a record. Per-engine instances, so the
        ``stats()`` percentiles never mix across the engines of one
        process; ``register`` replaces same-named series, so the latest
        engine owns the exported ones."""
        self.ttft_hist = Histogram("llmq_ttft_seconds", "Enqueue-to-first-token latency")
        self.itl_hist = Histogram("llmq_itl_seconds", "Inter-token latency at the host boundary",
                                  buckets=ITL_BUCKETS)
        # Interactive requests observe into both the unlabeled series and
        # these; batch gets no series of its own.
        self.ttft_hist_interactive = Histogram(
            "llmq_ttft_seconds", "Enqueue-to-first-token latency (interactive class)",
            labels={"class": "interactive"})
        self.itl_hist_interactive = Histogram(
            "llmq_itl_seconds", "Inter-token latency at the host boundary (interactive class)",
            buckets=ITL_BUCKETS, labels={"class": "interactive"})
        # Keyed by dispatch kind, a fixed set; the rings carry maxlen.
        self._dispatch_rings: Dict[str, Deque[float]] = {}
        self._dispatch_hists: Dict[str, Histogram] = {}
        # The gauges read this engine through a weak reference: the
        # process's registry outlives it and must not hold its weights and
        # pools (a read after it is gone gives 0).
        ref = weakref.ref(self)

        def pool_used(e):
            total = e.scheduler.config.num_pages - 1
            return (total - e.scheduler.allocator.available) / max(1, total)

        def store(fn):
            return lambda e: fn(e.prefix_store) if e.prefix_store is not None else 0

        gauges = [
            ("llmq_engine_tokens_per_sec", "Generated tokens per second since engine start",
             None,
             lambda e: e.total_generated_tokens / max(1e-9, time.monotonic() - e._started_at)),
            ("llmq_engine_kv_page_utilization", "Fraction of the KV page pool in use", None,
             pool_used),
            ("llmq_engine_batch_occupancy", "Fraction of decode slots holding a running sequence",
             None, lambda e: len(e.scheduler.running) / max(1, e.cfg.max_num_seqs)),
            ("llmq_prefix_hit_pages", "KV pages reused via the prefix cache (device + host tier)",
             None, lambda e: e.scheduler.prefix_hits),
            ("llmq_prefix_miss_pages", "Full prompt pages that had to prefill (prefix cache miss)",
             None, lambda e: e.scheduler.prefix_misses),
            ("llmq_prefix_demote_pages", "Evicted device pages parked in the host prefix tier",
             None, lambda e: e.prefix_demotes),
            ("llmq_prefix_promote_pages", "Pages restored from the host prefix tier to device",
             None, lambda e: e.prefix_promotes),
            ("llmq_prefix_host_evictions",
             "Host prefix tier entries dropped by the byte-budget LRU", None,
             store(lambda st: st.evictions)),
            ("llmq_prefix_host_bytes", "Host prefix tier occupancy in bytes", None,
             store(lambda st: st.occupancy_bytes)),
            ("llmq_prefix_host_entries", "Host prefix tier resident page count", None, store(len)),
            ("llmq_priority_preemptions",
             "Batch sequences preempted so interactive work could admit", None,
             lambda e: e.priority_preemptions),
        ]
        for cls in ("interactive", "batch"):
            gauges.append(("llmq_class_tokens", f"Tokens generated for {cls}-class requests",
                           {"class": cls}, lambda e, c=cls: e.class_tokens[c]))
        for cls in ("interactive", "batch"):
            gauges.append(("llmq_class_finished",
                           f"{cls.capitalize()}-class requests finished cleanly (goodput)",
                           {"class": cls}, lambda e, c=cls: e.class_finished[c]))
        gauges += [
            ("llmq_integrity_guard_trips", "Dispatches whose on-device logit guard fired", None,
             lambda e: e.guard_trips),
            ("llmq_integrity_weight_audit_mismatches",
             "Parameter leaves whose HBM digest diverged from the build-time baseline", None,
             lambda e: e.weight_audit_mismatches),
            ("llmq_integrity_canary_failures",
             "Golden-prompt canary replays that were not bit-exact", None,
             lambda e: e.canary_failures),
        ]
        reg = get_registry()
        for metric in (self.ttft_hist, self.itl_hist, self.ttft_hist_interactive,
                       self.itl_hist_interactive, self.scheduler.queue_wait_hist,
                       self.scheduler.preempt_delay_hist):
            reg.register(metric)
        for name, help_text, labels, read in gauges:
            reg.register(Gauge(name, help_text, labels=labels,
                               fn=lambda read=read: read(ref())))

    def _record_dispatch(self, kind: str, seconds: float) -> None:
        """Record the host span of one dispatch call into its kind's ring
        and histogram (JAX :3754). Launches are asynchronous, so this is the
        host's launch cost, not the device's time: spikes mean the host
        waited on the device."""
        ring = self._dispatch_rings.get(kind)
        if ring is None:
            ring = self._dispatch_rings[kind] = deque(maxlen=DISPATCH_RING)
            hist = self._dispatch_hists[kind] = Histogram(
                "llmq_dispatch_seconds", "Host wall-time of one device dispatch call",
                labels={"kind": kind})
            get_registry().register(hist)
        ring.append(seconds)
        self._dispatch_hists[kind].observe(seconds)
        if self.on_dispatch is not None:
            self.on_dispatch(kind)

    def _auto_num_pages(self) -> int:
        """Size the KV pool from free device memory (vLLM
        gpu_memory_utilization parity); a conservative cap on the CPU. An
        MoE model's per-layer transient (``moe_transient_bytes`` at the
        widest captured dispatch) is kept out of the pool's budget."""
        cfg = self.model_config
        itemsize = torch.empty((), dtype=self.cfg.kv_dtype).element_size()
        page_bytes = (
            2 * cfg.num_layers * self.cfg.page_size * cfg.num_kv_heads * cfg.head_dim_ * itemsize
        )
        max_useful = (
            self.cfg.max_num_seqs * (-(-self.cfg.max_model_len // self.cfg.page_size) + 1) + 1
        )
        if self.device.type != "cuda":
            return min(max_useful, 4096)
        free, total = torch.cuda.mem_get_info(self.device)
        budget = int(total * self.cfg.hbm_utilization) - (total - free)
        budget -= self._moe_transient_bytes()
        return int(min(max(2, budget // page_bytes), max_useful))

    def _moe_transient_bytes(self) -> int:
        """``models.transformer.moe_transient_bytes`` at the most rows a
        captured dispatch of this engine runs (decode, verify, mixed)."""
        S = self.cfg.max_num_seqs
        rows = max(S * (self.cfg.spec_tokens + 1),
                   S * self.cfg.prefill_chunk_size if self.mixed_step == "on" else S)
        quantized = any(qm.is_quantized(self.model.layer_params(0).get(name))
                        for name in ("expert_gate_proj", "expert_up_proj", "expert_down_proj"))
        return moe_transient_bytes(self.model_config, self.model.top["final_norm"].dtype, rows,
                                   quantized)

    # --- request intake ---------------------------------------------------
    def add_request(
        self,
        rid: str,
        *,
        prompt: Optional[str] = None,
        messages: Optional[List[Dict[str, str]]] = None,
        prompt_ids: Optional[List[int]] = None,
        params: Optional[SamplingParams] = None,
        deadline_at: Optional[float] = None,
        prefill_only: bool = False,
        priority: str = "batch",
    ) -> Sequence:
        if prompt_ids is None:
            if messages is not None:
                prompt_ids = self.tokenizer.apply_chat_template(messages)
            elif prompt is not None:
                prompt_ids = self.tokenizer.encode(prompt)
            else:
                raise ValueError("request needs prompt, messages, or prompt_ids")
        if not prompt_ids:
            prompt_ids = [0]
        # Own copy: the scheduler caps max_tokens in place.
        params = dataclasses.replace(params) if params else SamplingParams()
        need = len(set(params.stop_token_ids) | (set() if params.ignore_eos else self._eos_ids))
        if need > self._stop_capacity:
            self._grow_stop_capacity(need)
        if priority not in ("interactive", "batch"):
            raise ValueError(f"priority={priority!r} (want interactive|batch)")
        if not self.priority_classes:
            priority = "batch"  # classes disabled: everything is FIFO batch
        seq = Sequence(rid=rid, prompt_ids=list(prompt_ids), params=params,
                       deadline_at=deadline_at, prefill_only=prefill_only, priority=priority)
        if deadline_at is not None:
            self._deadlines_enabled = True
        if priority == "interactive" and not self._priority_enabled:
            # Priority-aware admission from the first interactive request on.
            self._priority_enabled = True
            self.scheduler.config.priority_aware = True
        self.total_prompt_tokens += len(seq.prompt_ids)
        self.scheduler.add(seq)
        return seq

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.running) or self.scheduler.has_waiting or bool(self._pending)

    # --- one engine iteration --------------------------------------------
    def step(self) -> List[RequestOutput]:
        """Admit + prefill new sequences, dispatch one decode step for the
        batch, process lagged results. Returns the requests whose finish
        was observed this iteration (results lag dispatch by <= runahead)."""
        finished: List[RequestOutput] = []
        if self._deadlines_enabled:
            self._expire_deadlines(finished)
        if self._cancel_rids:
            self._sweep_cancels(finished)
        pre_wave = [s.rid for s in self._decodable_seqs()]
        while self._try_admit(finished):
            if any(rid in self.scheduler.running for rid in pre_wave):
                self._dispatch_decode(finished)
        if self.scheduler.running:
            self._dispatch_decode(finished)
        elif self._pending:
            self._process_oldest(finished)
        self._flush_deferred()
        return finished

    def _decodable_seqs(self) -> List[Sequence]:
        return [s for s in self.scheduler.running.values() if s.prefilled]

    def _expire_deadlines(self, finished: List[RequestOutput]) -> None:
        """Waiting or running sequences past their wall-clock deadline
        finish with ``deadline_exceeded`` (JAX :2569). Mid-prefill rows
        expire on a later sweep, once prefilled."""
        now = time.time()
        for seq in [s for s in self.scheduler.waiting
                    if s.deadline_at is not None and now > s.deadline_at]:
            self.scheduler.waiting.remove(seq)
            self.scheduler.finish(seq, "deadline_exceeded")
            finished.append(self._output_for(seq))
            self.deadline_expirations += 1
        for seq in [s for s in self.scheduler.running.values()
                    if s.prefilled and s.deadline_at is not None and now > s.deadline_at]:
            self._finish_seq(seq, "deadline_exceeded", device_detected=False, finished=finished)
            self.deadline_expirations += 1

    def cancel_request(self, rid: str) -> None:
        """Cancel a waiting/running request at the next step's sweep: it
        finishes with ``finish_reason="cancelled"``. Unknown rids age out."""
        self._cancel_rids[rid] = time.monotonic()

    def _sweep_cancels(self, finished: List[RequestOutput]) -> None:
        now = time.monotonic()
        for seq in [s for s in self.scheduler.waiting if s.rid in self._cancel_rids]:
            self.scheduler.waiting.remove(seq)
            self.scheduler.finish(seq, "cancelled")
            finished.append(self._output_for(seq))
            del self._cancel_rids[seq.rid]
            self.cancellations += 1
        for seq in [
            s for s in self.scheduler.running.values()
            if s.prefilled and s.rid in self._cancel_rids
        ]:
            self._finish_seq(seq, "cancelled", device_detected=False, finished=finished)
            del self._cancel_rids[seq.rid]
            self.cancellations += 1
        for rid, t in list(self._cancel_rids.items()):
            if now - t > _CANCEL_TTL_S:
                del self._cancel_rids[rid]

    def _interactive_victim(self) -> Optional[Sequence]:
        """The youngest running prefilled batch sequence (JAX :2638): the
        victim when interactive work would otherwise queue for a slot."""
        candidates = [s for s in self.scheduler.running.values()
                      if s.prefilled and s.priority != "interactive"]
        return max(candidates, key=lambda s: s.admitted_at) if candidates else None

    def _try_admit(self, finished: List[RequestOutput]) -> bool:
        """Admit + prefill (or restore) up to one batch; True if anything
        was admitted (the caller loops until the admissible backlog is
        drained)."""
        while len(self._pending) > self.cfg.runahead:
            self._process_oldest(finished)
        self._flush_deferred()
        free = sum(s is None for s in self.scheduler.slots)
        # SLO preemption: an interactive waiter facing a full slot table
        # evicts the youngest prefilled batch row (swapped under
        # preempt_mode=swap), one victim per admission round.
        int_waiting = self._priority_enabled and any(
            s.priority == "interactive" for s in self.scheduler.waiting)
        if int_waiting and free == 0 and self.priority_preempt:
            victim = self._interactive_victim()
            if victim is not None:
                self._self_preempt_deferred(victim)
                self.priority_preemptions += 1
                free = 1
        want = (
            min(self.cfg.max_prefill_batch, len(self.scheduler.waiting), len(self.scheduler.slots))
            if self.scheduler.has_waiting
            else 0
        )
        # Wait for enough free slots to fill a prefill batch rather than
        # prefilling singletons as slots trickle free; never defer when
        # nothing runs, nor for longer than admit_max_wait_s.
        can_admit = bool(want) and free > 0
        full = free >= (want if self.scheduler.running else 1)
        if not can_admit or full:
            self._defer_since = None
        elif self._defer_since is None:
            self._defer_since = time.monotonic()
        overdue = (
            self._defer_since is not None
            and time.monotonic() - self._defer_since > self.cfg.admit_max_wait_s
        )
        # Interactive waiters never sit out the batch-admission deferral.
        if not (can_admit and (full or overdue or int_waiting)):
            return False
        self._defer_since = None
        admitted = self.scheduler.admit(max_new=self.cfg.max_prefill_batch)
        # Host-tier promotion before anything else touches the wave: admit()
        # registered the promoted pages' hashes (later admits may share
        # them), which is sound only if their KV is in place before any
        # dispatch can read the pages.
        self._promote_host_pages(admitted)
        todo, restored = [], []
        for seq in admitted:
            if seq.params.max_tokens <= 0:
                self.scheduler.finish(seq, "length")
                finished.append(self._output_for(seq))
            elif seq.restore is not None:
                restored.append(seq)
            else:
                todo.append(seq)
        # Restores first: they mark the state dirty, and the prefill below
        # (or the next decode dispatch) resyncs once for the whole wave.
        if restored:
            self._restore_batch(restored)
        if todo:
            self._prefill_batch(todo, finished)
        return bool(admitted)

    # --- run-ahead pipeline ----------------------------------------------
    def _drain(self, finished: List[RequestOutput]) -> None:
        while self._pending:
            self._process_oldest(finished)
        self._flush_deferred()

    def _push_pending(
        self, kind: str, out: Any, snapshot: List[Tuple[int, Sequence]],
        starts: Optional[np.ndarray] = None, guard: Optional[Tuple[Any, Any]] = None,
    ) -> None:
        """Start the device→host copy of a dispatch's tokens (a tensor, a
        tuple of them, or None) and of its guard fold, and queue it (JAX
        :3171)."""
        outs = () if out is None else (out if isinstance(out, tuple) else (out,))
        tensors = outs + (tuple(guard) if guard is not None else ())
        if tensors[0].is_cuda:
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = tensors, None
        self._dispatch_idx += 1
        if kind in _DECODE_KINDS:
            self._pending_decodes += 1
        # Epoch stamps: a row snapshotted before a preemption must not be
        # appended after the sequence is re-admitted.
        stamped = [(row, seq, seq.epoch) for row, seq in snapshot]
        n = len(outs)
        self._pending.append((self._dispatch_idx, kind, host[:n], event, stamped, starts,
                              host[n:] if guard is not None else None))

    def _live(self, seq: Sequence, epoch: int) -> bool:
        """Still running in the epoch it was snapshotted in: a row that
        finished or was preempted while its dispatch was in flight (or at
        an earlier iteration of the same block) gets its lagged tokens
        discarded."""
        return (seq.finish_reason is None and seq.rid in self.scheduler.running
                and seq.epoch == epoch)

    def _process_oldest(self, finished: List[RequestOutput]) -> None:
        idx, kind, host, event, snapshot, starts, guard = self._pending.popleft()
        if kind in _DECODE_KINDS:
            self._pending_decodes -= 1
        if event is not None:
            # Where a wedged kernel blocks the engine thread (the GIL is
            # released meanwhile, so the watchdog's monitor runs).
            with self._wd(_FETCH_KIND[kind]):
                event.synchronize()
        if guard is not None:
            # The verdict before any of this dispatch's tokens reaches a
            # sequence: a tripped dispatch's outputs are suspect.
            self._eval_guard(kind, guard, snapshot)
        if not host:  # a chunk that carried only its guard fold
            self._processed_idx = idx
            return
        arrays = [h.numpy() for h in host]
        if kind == "verify":
            # ([K, S, Q] candidates, [K, S] emitted counts): per iteration
            # and row the first count tokens are real, k-major so each
            # token re-checks the row (a stop string at candidate i drops
            # candidates i+1.. of the same row).
            emit, counts = arrays
            for k in range(emit.shape[0]):
                for row, seq, epoch in snapshot:
                    n = int(counts[k, row])
                    if n <= 0 or not self._live(seq, epoch):
                        continue
                    self.spec_proposed += self.cfg.spec_tokens
                    self.spec_accepted += n - 1
                    for i in range(n):
                        if not self._live(seq, epoch):
                            break
                        self._append_and_check(seq, int(emit[k, row, i]), finished)
        else:
            # A [K, rows] block (a prefill's [rows] is one iteration),
            # k-major: every row's token k before any row's token k + 1.
            tokens = arrays[0] if arrays[0].ndim == 2 else arrays[0][None]
            for k, k_tokens in enumerate(tokens):
                for row, seq, epoch in snapshot:
                    # A mixed block's piggy row starts at its final segment.
                    if starts is not None and k < starts[row]:
                        continue
                    if self._live(seq, epoch):
                        self._append_and_check(seq, int(k_tokens[row]), finished)
        self._processed_idx = idx

    def _eval_guard(self, kind: str, guard: Tuple[Any, Any],
                    snapshot: List[Tuple[int, Sequence, int]]) -> None:
        """Raise :class:`LogitGuardError` with the suspects if one
        dispatch's guard fold tripped (JAX :2839). A block's per-iteration
        folds ([K, 3], [K, rows]) are combined on the host."""
        with self._wd("guard"):
            stats = guard[0].numpy()
            bad = guard[1].numpy()
        if stats.ndim == 2:
            stats = np.array([stats[:, 0].sum(), stats[:, 1].max(), stats[:, 2].min()])
        if bad.ndim == 2:
            bad = bad.any(axis=0)
        if not bad.any():
            return
        checks = []
        if stats[0] > 0:
            checks.append("nonfinite")
        if self.guard_logit_max > 0 and stats[1] > self.guard_logit_max:
            checks.append("logit_max")
        if self.guard_entropy_min > 0 and np.isfinite(stats[2]) and \
                stats[2] < self.guard_entropy_min:
            checks.append("entropy_collapse")
        suspects = tuple(seq.rid for row, seq, _ in snapshot if row < bad.shape[0] and bad[row])
        self.guard_trips += 1
        raise LogitGuardError(
            check="+".join(checks) or "guard",
            detail=(f"nonfinite={stats[0]:.0f} max|logit|={stats[1]:.4g} "
                    f"min_entropy={stats[2]:.4g} rows={int(bad.sum())}"),
            suspects=suspects, kind=kind,
        )

    def _flush_deferred(self) -> None:
        # Swap captures first: each shares its watermark with the deferred
        # pages of the same preemption, and its pages must reach the host
        # before they return to the allocator. At the watermark every
        # dispatch that may write them has completed (its event waited).
        while self._pending_swaps and self._pending_swaps[0][0] <= self._processed_idx:
            _, seq, pages, valid, epoch = self._pending_swaps.pop(0)
            self._capture_swap(seq, pages, valid, epoch)
        while self._deferred_pages and self._deferred_pages[0][0] <= self._processed_idx:
            _, pages, cacheable = self._deferred_pages.pop(0)
            self.scheduler.release_pages(pages, cacheable)

    # --- swap preemption ----------------------------------------------------
    def _kv_gather(self, pages: List[int], kind: str = "snapshot_gather"
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Pool pages to the host as ``[L, n, page, H, D]`` raw bits (JAX
        ``_kv_gather_np`` :2314 over ``gather_kv_pages``): one
        ``index_select`` and one copy a pool, the copy waiting for it, in
        the watchdog bracket ``kind``."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        with self._wd(kind):
            return (snapshot_mod.pages_to_host(self.k_pages, idx),
                    snapshot_mod.pages_to_host(self.v_pages, idx))

    def _kv_insert(self, pages: List[int], k: np.ndarray, v: np.ndarray) -> None:
        """Write host raw-bit pages into the pools in place (JAX
        ``_kv_insert_np`` :2339 rebinds donated pools; here the pools keep
        their storage, so the captured graphs stay valid)."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        snapshot_mod.pages_from_host(self.k_pages, idx, k)
        snapshot_mod.pages_from_host(self.v_pages, idx, v)

    def _swap_out(self, seq: Sequence, pages: List[int], valid: int) -> None:
        """Gather ``seq``'s first ``pages_for(valid)`` pages to the host as
        its restore, if the governor admits them (else it recomputes)."""
        n = snapshot_mod.pages_for(valid, self.cfg.page_size)
        if n == 0 or n > len(pages) or not self._admit_swap_capture(n):
            return
        k, v = self._kv_gather(pages[:n])
        seq.restore = KVRestore(k=k, v=v, valid=valid, dtype=self._kv_name)
        self.swap_preempts += 1

    def _capture_swap(self, seq: Sequence, pages: List[int], valid: int, epoch: int) -> None:
        """A swap-preempted sequence's pages to the host at its watermark
        (JAX :2912); skipped (it re-prefills, always correct) when the
        sequence moved on meanwhile: re-admitted, finished, preempted
        again, or already carrying a restore."""
        if (seq.epoch != epoch or seq.finish_reason is not None
                or seq.rid in self.scheduler.running or seq.restore is not None):
            return
        self._swap_out(seq, pages, valid)

    def _page_host_bytes(self) -> int:
        """Host bytes one swapped KV page costs (K + V)."""
        return 2 * self.k_pages.numel() * self.k_pages.element_size() // self.k_pages.shape[1]

    def _admit_swap_capture(self, n_pages: int) -> bool:
        """Ask the host-memory governor before buffering ``n_pages`` of
        swapped KV; a refusal downgrades the preemption to recompute."""
        if get_governor().admit_swap(n_pages * self._page_host_bytes()):
            return True
        self.swap_refused += 1
        return False

    def _swap_restore_bytes(self) -> int:
        """Governor gauge: host bytes of restores awaiting re-admission."""
        return sum(s.restore.k.nbytes + s.restore.v.nbytes
                   for s in list(self.scheduler.waiting) if s.restore is not None)

    def _on_scheduler_preempt(self, seq: Sequence, deferred: bool) -> None:
        """Scheduler ``on_preempt`` hook (JAX :2985): an immediate
        preemption (a scheduler-picked victim, only with the pipeline
        drained) gathers the victim's pages here, while it owns them;
        deferred ones queue their capture in ``_self_preempt_deferred``."""
        if (deferred or self.preempt_mode != "swap" or not seq.prefilled or not seq.pages
                or seq.restore is not None):
            return
        if self._pending:
            raise RuntimeError("immediate preemption with dispatches in flight")
        self._swap_out(seq, seq.pages, seq.num_tokens - 1)

    # --- host prefix tier -------------------------------------------------
    def _demote_page(self, page: int, hashes: List[bytes]) -> None:
        """Scheduler ``on_demote`` hook (JAX :3012): park an evicted cache
        page's KV in the host tier under every chain hash that named it.
        The gather is safe with dispatches in flight: a cached page has
        refcount 0 and its deferred release passed its watermark, so no
        queued dispatch writes it, and the gather, queued behind them all,
        copies it to the host before the allocator hands the page out."""
        k, v = self._kv_gather([page])
        for h in hashes:
            self.prefix_store.put(h, k, v)
        self.prefix_demotes += 1

    def _promote_host_pages(self, admitted: List[Sequence]) -> None:
        """Write host-tier KV into the pages admit() reserved for it, in
        place (``index_copy_``: the pools keep their storage and the
        captured graphs stay valid), before the wave's first dispatch. The
        sequences are unprefilled: their prefill scatter brings their
        decode rows up, so no resync is needed."""
        for seq in admitted:
            hr, seq.host_restore = seq.host_restore, None
            if not hr:
                continue
            k = np.concatenate([e.k for _, _, e in hr], axis=1)
            v = np.concatenate([e.v for _, _, e in hr], axis=1)
            self._kv_insert([page for page, _, _ in hr], k, v)
            self.prefix_promotes += len(hr)

    def flush_prefix_to_host(self) -> int:
        """Demote every evictable (refcount-0) cached page to the host tier
        now instead of under pool pressure (before a planned teardown, and
        to drive demote -> promote deterministically). Returns the number
        of pages dropped from the device cache."""
        pages = list(self.scheduler.allocator._cached)
        for page in pages:
            self.scheduler.allocator.drop_cached(page)  # fires on_evict
        return len(pages)

    def export_prefix_chunks(self, digests_hex: List[str]) -> List[str]:
        """Serialize the named prefix pages for a peer (base64 chunk wire
        form). Each digest resolves against the host tier first, then the
        device cache (gathered on demand); misses are skipped: shipping is
        best-effort and the requester prefills what does not arrive."""
        out: List[str] = []
        sig = self._model_sig()
        for hx in digests_hex:
            try:
                key = bytes.fromhex(hx)
            except ValueError:
                continue
            entry = (self.prefix_store.get(key)
                     if self.prefix_store is not None and key in self.prefix_store else None)
            if entry is not None:  # None too if the governor evicted it since the test
                k, v = entry.k, entry.v
            elif key in self.scheduler._prefix_cache:
                k, v = self._kv_gather([self.scheduler._prefix_cache[key]])
            else:
                continue
            blob = prefix_mod.chunk_to_bytes(key, k, v, model_sig=sig,
                                             page_size=self.cfg.page_size)
            out.append(prefix_mod.chunk_to_b64(blob))
            self.prefix_chunks_exported += 1
        return out

    def ingest_prefix_chunks(self, chunks_b64: List[str]) -> int:
        """Accept shipped prefix pages into the host tier (they promote on
        the next matching admission). Returns the number accepted, 0 with
        the tier off. A malformed or incompatible chunk raises: a fleet
        whose shapes disagree must fail loudly, not recompute forever."""
        if self.prefix_store is None:
            return 0
        n = 0
        sig = self._model_sig()
        for c in chunks_b64:
            key, k, v, chunk_sig, page_size = prefix_mod.chunk_from_bytes(
                prefix_mod.chunk_from_b64(c))
            prefix_mod.check_chunk_compat(chunk_sig, page_size, want_sig=sig,
                                          want_page_size=self.cfg.page_size)
            if self.prefix_store.put(key, k, v):
                n += 1
                self.prefix_chunks_ingested += 1
        return n

    def missing_prefix_digests(self, digests_hex: List[str]) -> List[str]:
        """The chain digests held in NEITHER the device prefix cache nor the
        host tier: the want-list a worker sends an affinity peer before it
        recomputes a prefix. Host-side lookups only."""
        missing: List[str] = []
        for hx in digests_hex:
            try:
                key = bytes.fromhex(hx)
            except ValueError:
                continue
            if key in self.scheduler._prefix_cache:
                continue
            if self.prefix_store is not None and key in self.prefix_store:
                continue
            missing.append(hx)
        return missing

    def _resync(self) -> None:
        """Rebuild the device decode state from scheduler truth, in place
        (a leaf whose shape changed is made anew and the captured graphs
        are dropped). Only valid after a full drain."""
        if self._pending:
            raise RuntimeError("resync with in-flight steps")
        fills = [
            (self._h_tokens, 0), (self._h_ctx, 0), (self._h_active, False),
            (self._h_bt, 0), (self._h_temp, 0.0), (self._h_topk, 0),
            (self._h_topp, 1.0), (self._h_keys, 0), (self._h_steps, 0),
            (self._h_limits, 0), (self._h_mins, 0), (self._h_stopids, -1),
        ]
        if self._spec:
            fills.append((self._h_history, 0))
        for arr, fill in fills:
            arr[...] = fill
        modes = []
        for i, seq in enumerate(self.scheduler.slots):
            if seq is None or not seq.prefilled:
                continue  # unprefilled slots join via the prefill scatter
            p = seq.params
            self._h_tokens[i] = seq.last_token
            self._h_ctx[i] = seq.num_tokens - 1
            self._h_bt[i, : len(seq.pages)] = seq.pages
            self._h_active[i] = True
            self._h_temp[i] = p.temperature
            self._h_topk[i] = p.top_k
            self._h_topp[i] = p.top_p
            self._h_keys[i] = make_base_key(p.seed, request_tag(seq.rid))
            self._h_steps[i] = len(seq.output_ids)
            self._h_limits[i] = p.max_tokens
            self._h_mins[i] = p.min_tokens
            self._h_stopids[i] = self._stop_ids_for(seq)
            if self._spec:
                ids = seq.prompt_ids + seq.output_ids
                self._h_history[i, : len(ids)] = ids
            modes.append(sampling_mod.required_mode(p))
        self._mode = sampling_mod.join_modes(modes) if modes else "greedy"
        self._suppress = bool((self._h_mins > 0).any())
        state = (
            self._h_tokens, self._h_ctx, self._h_bt, self._h_active,
            self._h_keys, self._h_steps, self._h_temp, self._h_topk,
            self._h_topp, self._h_limits, self._h_mins, self._h_stopids,
        ) + ((self._h_history,) if self._spec else ())
        old = self._dev_state
        if old is None or any(t.shape != a.shape for t, a in zip(old, state)):
            self._dev_state = tuple(torch.from_numpy(a.copy()).to(self.device) for a in state)
            if self._graphs is not None:
                self._graphs.reset()
        else:
            for leaf, arr in zip(old, state):
                leaf.copy_(torch.from_numpy(arr))
        self._dirty = False

    def _upload(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy host ``arr`` into the static device tensor ``dst`` behind
        the dispatches already queued, without waiting for them."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if dst.is_cuda:
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _grow_stop_capacity(self, need: int) -> None:
        """Widen the per-slot stop-id arrays to the next power of two >=
        ``need``; the state is marked dirty, so the next dispatch drains
        and resyncs at the new shape (and captures its graphs anew)."""
        E = 1 << max(need - 1, 1).bit_length()
        self._stop_capacity = E
        self._h_stopids = np.full((self.cfg.max_num_seqs, E), -1, np.int32)
        self._dirty = True

    def _stop_ids_for(self, seq: Sequence) -> np.ndarray:
        """Per-slot device stop-token ids ([-1]-padded)."""
        ids = list(dict.fromkeys(seq.params.stop_token_ids))
        if not seq.params.ignore_eos:
            ids.extend(i for i in self._eos_ids if i not in ids)
        row = np.full((self._stop_capacity,), -1, np.int32)
        row[: len(ids)] = ids
        return row

    # --- device steps ------------------------------------------------------
    def _sample(self, logits, keys, steps, temps, topks, topps, mode) -> torch.Tensor:
        gumbel = None if mode == "greedy" else step_gumbel(keys, steps, self._vocab)
        return sample_tokens(logits, gumbel, temps, topks, topps, mode=mode)

    def _guard_fold(self, logits: torch.Tensor, mask: torch.Tensor):
        """The guard's (stats, bad) over raw logits (before the stop
        suppression's sentinels), or None with the guard off."""
        if not self._guard:
            return None
        return logit_guard_stats(logits, mask, max_abs=self.guard_logit_max,
                                 min_entropy=self.guard_entropy_min)

    def _split_guard(self, out: Any) -> Tuple[Any, Any]:
        """A dispatch's (tokens, guard fold): with the guard on the step
        functions return both, off the fold is None (JAX :3161)."""
        return out if self._guard else (out, None)

    def _decode_iter(self, st: tuple, mode: str, suppress: bool) -> Tuple[torch.Tensor, Any]:
        """One decode iteration (JAX ``decode_step``, :1358) over the state
        ``st``, updated in place; returns the step's tokens [S] int32 and
        its guard fold."""
        (tokens, ctx, bt, active, keys, steps, temps, topks,
         topps, _limits, mins, stop_ids) = st[:12]
        logits = self.model.decode(tokens, ctx, self.k_pages, self.v_pages, bt, active)
        g = self._guard_fold(logits, active)
        if suppress:
            logits = suppress_stops(logits, stop_ids, steps, mins)
        next_tokens = self._sample(logits, keys, steps, temps, topks, topps, mode)
        out = torch.where(active, next_tokens, 0).to(torch.int32)
        _assign(st[:12], advance_state(st[:12], out, active))
        return out, g

    def _verify_iter(self, st: tuple, mode: str, suppress: bool) -> Tuple[torch.Tensor, ...]:
        """One speculative iteration (JAX ``verify_step``, :1445): draft,
        score the Q = spec_tokens + 1 candidate positions in one model
        call, accept the longest prefix the model itself emits, advance
        each row by its count. Returns (emit [S, Q], count [S]), int32;
        the host appends ``emit[row, :count]``."""
        (tokens, ctx, bt, active, keys, steps, temps, topks,
         topps, limits, mins, stop_ids, history) = st
        S, dev = tokens.shape[0], tokens.device
        M, Q = self.cfg.max_model_len, self.cfg.spec_tokens + 1
        drafts = draft_lookup(history[:, :M], ctx, Q - 1, self.cfg.spec_ngram)
        qtok = torch.cat([tokens[:, None], drafts.clamp(min=0)], dim=1)
        pos_grid = ctx[:, None] + torch.arange(Q, dtype=ctx.dtype, device=dev)[None, :]
        # Inactive rows and positions past the page map write the scratch
        # page and attend nothing; the grid keeps K3's leading-run form.
        qpos = torch.where(active[:, None] & (pos_grid < self._max_kv_pos), pos_grid, -1)
        logits = self.model.verify(qtok, qpos, self.k_pages, self.v_pages, bt)
        V = logits.shape[-1]
        g = self._guard_fold(logits.reshape(S * Q, V), active.repeat_interleave(Q))
        if g is not None:  # a row's verdict folds its Q candidate positions
            g = (g[0], g[1].reshape(S, Q).any(dim=1))
        steps_grid = steps[:, None] + torch.arange(Q, dtype=steps.dtype, device=dev)[None, :]
        if suppress:
            logits = suppress_stops(
                logits.reshape(S * Q, V), stop_ids.repeat_interleave(Q, dim=0),
                steps_grid.reshape(-1), mins.repeat_interleave(Q),
            ).reshape(S, Q, V)
        emit = spec_verify_tokens(logits, drafts, keys, steps, temps, topks, topps,
                                  mode=mode).to(torch.int32)
        # Position i is reached iff every earlier draft was accepted.
        accepted = (emit[:, :-1] == drafts).to(torch.int32).cumprod(dim=1).bool()
        reached = torch.cat([torch.ones((S, 1), dtype=torch.bool, device=dev), accepted], 1)
        # A stop or limit hit at position i emits i's token and cuts the rest.
        new_steps_grid = steps_grid + 1
        hit_stop = ((emit[:, :, None] == stop_ids[:, None, :]).any(dim=2)
                    & (new_steps_grid > mins[:, None]))
        stop_here = hit_stop | (new_steps_grid >= limits[:, None])
        here = stop_here.to(torch.int32)
        stopped_before = (here.cumsum(dim=1) - here) > 0
        emitted = active[:, None] & reached & ~stopped_before  # [S, Q]
        count = emitted.sum(dim=1).to(ctx.dtype)
        new_tok = torch.gather(emit, 1, (count - 1).clamp(min=0)[:, None].long())[:, 0]
        still = active & ~(emitted & stop_here).any(dim=1)
        hist_pos = torch.where(emitted, pos_grid + 1, M)  # column M: dropped
        history.scatter_(1, hist_pos.long(), emit)
        _assign((tokens, ctx, active, steps),
                (torch.where(count > 0, new_tok, tokens), ctx + count, still, steps + count))
        return (torch.where(emitted, emit, 0), count), g

    def _mixed_iter(self, st: tuple, seg: Dict[str, torch.Tensor], k: int, mode: str,
                    suppress: bool) -> torch.Tensor:
        """One mixed iteration (the JAX ``mixedfill_step`` scan body,
        :1690): decode every active row and prefill iteration ``k``'s
        segment of the piggy sequence in one [S, C] grid through K3; the
        decode rows' math is ``decode_step``'s. When the piggy's final
        segment lands, its first token is sampled and its row scattered
        into the state, so later iterations decode it. Returns the
        iteration's tokens [S] int32."""
        (tokens, ctx, bt, active, keys, steps, temps, topks,
         topps, limits, mins, stop_ids) = st[:12]
        S, dev = tokens.shape[0], tokens.device
        slot = seg["slots"][0]
        final = seg["final"][k]
        qtok, qpos, is_chunk = mixed_query_grid(
            tokens, ctx, active, seg["tokens"][k], seg["positions"][k], slot, self._max_kv_pos
        )
        gather = torch.where(is_chunk, seg["last"][k], 0)
        # The piggy's block table rides in with the segment: its pages join
        # the state only at the final segment's scatter.
        row = slot.clamp(min=0).long().reshape(1)
        bt_used = bt.clone()
        bt_used[row] = seg["bt"]
        logits = self.model.mixed(qtok, qpos, self.k_pages, self.v_pages, bt_used, gather)
        # Active decode rows, and the piggy's row at the iteration of its
        # final segment (earlier segments gather pad positions).
        g = self._guard_fold(logits, active | ((torch.arange(S, device=dev) == slot) & final
                                               & (seg["slots"][0] >= 0)))
        d_logits = suppress_stops(logits, stop_ids, steps, mins) if suppress else logits
        next_tokens = self._sample(d_logits, keys, steps, temps, topks, topps, mode)
        out = torch.where(active, next_tokens, 0).to(torch.int32)
        if self._spec:
            # Drafting pauses in mixed dispatches; history[ctx] stays the
            # current token for the next verify dispatch.
            M = self.cfg.max_model_len
            st[12].scatter_(1, torch.where(active, ctx + 1, M)[:, None].long(), out[:, None])
        _assign(st[:12], advance_state(st[:12], out, active))
        # The piggy's activation after the decode advance (JAX order).
        valid = final & (seg["slots"][0] >= 0)
        out1, values = self._first_tokens(logits.index_select(0, row), seg, mode, suppress)
        for leaf, name in zip(st, _STATE_LEAVES):
            leaf[row] = torch.where(valid, values[name], leaf[row])
        return torch.where((torch.arange(S, device=dev) == slot) & final, out1[0], out), g

    def _block(self, kind: str, st: tuple, seg, mode: str, suppress: bool, K: int) -> Any:
        """``K`` iterations of ``kind`` over the state ``st`` (JAX
        ``decode_block_step`` :1375, ``verify_block_step`` :1549, the mixed
        scan): a [K, S] token block, or ([K, S, Q], [K, S]) for verify;
        with the guard on, paired with the per-iteration folds ([K, 3],
        [K, S])."""
        outs, folds = [], []
        for k in range(K):
            if kind == "decode":
                out, g = self._decode_iter(st, mode, suppress)
            elif kind == "verify":
                out, g = self._verify_iter(st, mode, suppress)
            else:
                out, g = self._mixed_iter(st, seg, k, mode, suppress)
            outs.append(out)
            folds.append(g)
        if kind == "verify":
            result = tuple(torch.stack(part) for part in zip(*outs))
        else:
            result = torch.stack(outs)
        if not self._guard:
            return result
        return result, (torch.stack([g[0] for g in folds]), torch.stack([g[1] for g in folds]))

    def _dispatch_block(self, kind: str, seg=None, mode: Optional[str] = None,
                        K: Optional[int] = None) -> Any:
        """Run one decode-type dispatch of ``K`` iterations (``decode_block``
        by default) in sampling ``mode`` (the state's by default): on the
        card a replay of its captured graph, one per K (captured on first
        use, after a warm-up on inactive copies of the state and inputs),
        else eagerly."""
        mode, suppress = mode or self._mode, self._suppress
        K = K or self.cfg.decode_block
        if self._graphs is None:
            return self._block(kind, self._dev_state, seg, mode, suppress, K)

        def warm():
            dead = tuple(t.clone() for t in self._dev_state)
            dead[3].zero_()  # no active row: KV writes go to the scratch page
            dead_seg = None
            if seg is not None:
                dead_seg = {name: t.clone() for name, t in seg.items()}
                dead_seg["positions"].fill_(-1)
                dead_seg["final"].zero_()
            self._block(kind, dead, dead_seg, mode, suppress, K)

        # The guard is fixed at build, so an engine's graphs are all guarded
        # or all not; the key says which.
        return self._graphs.run(
            (kind, mode, suppress, K) + (("guard",) if self._guard else ()),
            lambda: self._block(kind, self._dev_state, seg, mode, suppress, K),
            warm, steps=K,
        )

    def _first_tokens(
        self, logits: torch.Tensor, args: Dict[str, torch.Tensor], mode: str, suppress: bool
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Shared tail of the prefill paths and the mixed step (JAX
        ``sample_and_scatter``, :1583): each row's first token ([B] int32)
        and the decode-state values of its row."""
        if suppress:
            logits = suppress_stops(logits, args["stop_ids"], args["steps"], args["mins"])
        nt = self._sample(
            logits, args["keys"], args["steps"], args["temps"], args["topks"],
            args["topps"], mode,
        )
        out = nt.to(torch.int32)
        new_steps = args["steps"] + 1
        hit_stop = (out[:, None] == args["stop_ids"]).any(dim=1) & (new_steps > args["mins"])
        alive = ~(hit_stop | (new_steps >= args["limits"]))
        values = {
            "tokens": out, "ctx": args["lengths"], "bt": args["bt"], "active": alive,
            "keys": args["keys"], "steps": new_steps, "temps": args["temps"],
            "topks": args["topks"], "topps": args["topps"], "limits": args["limits"],
            "mins": args["mins"], "stop_ids": args["stop_ids"],
        }
        if self._spec:
            # The row's prompt + output and its fresh first sample at
            # position lengths (the new ctx): history[ctx] == current token.
            hist = torch.cat([args["history"], torch.zeros_like(args["history"][:, :1])], 1)
            M = self.cfg.max_model_len
            hist.scatter_(1, args["lengths"].clamp(max=M)[:, None].long(), out[:, None])
            values["history"] = hist
        return out, values

    def _sample_and_scatter(
        self, logits: torch.Tensor, args: Dict[str, torch.Tensor], rows, mode: str
    ) -> torch.Tensor:
        """Sample every prefill row's first token ([B] int32) and scatter
        ``rows`` (a slice or an index tensor) into the decode state in
        place."""
        out, values = self._first_tokens(logits, args, mode, self._suppress)
        idx = args["slots"][rows].long()
        for leaf, name in zip(self._dev_state, _STATE_LEAVES):
            leaf[idx] = values[name][rows]
        return out

    def _prefill_fn(self, args: Dict[str, torch.Tensor], n: int, mode: str) -> Tuple[Any, Any]:
        """Prefill rows, sample each row's first token, and scatter the
        first ``n`` (valid) rows into the decode state in place; returns
        the tokens and the guard fold of the valid rows."""
        logits = self.model.prefill(
            args["tokens"], args["lengths"], self.k_pages, self.v_pages, args["bt"]
        )
        g = self._guard_fold(logits, args["slots"] >= 0)
        return self._sample_and_scatter(logits, args, slice(0, n), mode), g

    def _pack_sampling_rows(self, rows: List[Sequence], B: int) -> Dict[str, np.ndarray]:
        """Per-row decode-state values shared by both prefill paths. Padding
        rows keep slot −1 and limit 1."""
        E = self._stop_capacity
        host = dict(
            slots=np.full((B,), -1, np.int32), keys=np.zeros((B, 2), np.int64),
            steps=np.zeros((B,), np.int32), temps=np.zeros((B,), np.float32),
            topks=np.zeros((B,), np.int32), topps=np.ones((B,), np.float32),
            limits=np.full((B,), 1, np.int32), mins=np.zeros((B,), np.int32),
            stop_ids=np.full((B, E), -1, np.int32),
        )
        for r, seq in enumerate(rows):
            p = seq.params
            host["slots"][r] = seq.slot
            host["keys"][r] = make_base_key(p.seed, request_tag(seq.rid))
            host["steps"][r] = len(seq.output_ids)
            host["temps"][r] = p.temperature
            host["topks"][r] = p.top_k
            host["topps"][r] = p.top_p
            host["limits"][r] = p.max_tokens
            host["mins"][r] = p.min_tokens
            host["stop_ids"][r] = self._stop_ids_for(seq)
        if self._spec:
            # The rows' prompt + output: the drafter's corpus (JAX
            # _pack_history_rows, :3601).
            host["history"] = np.zeros((B, self.cfg.max_model_len), np.int32)
            for r, seq in enumerate(rows):
                ids = seq.prompt_ids + seq.output_ids
                host["history"][r, : len(ids)] = ids
        return host

    def _to_device(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    # --- prefill ----------------------------------------------------------
    def _prefill_batch(self, seqs: List[Sequence], finished: List[RequestOutput]) -> None:
        """Prefill admitted sequences in bucket-grouped batches; each
        batch scatters its rows straight into the device decode state,
        so admission costs no pipeline drain."""
        if self._dirty:
            self._drain(finished)
            self._resync()
        if self.cfg.prefill_chunk_size:
            if self.mixed_step == "on":
                self._prefill_mixed(seqs, finished)
            else:
                self._prefill_chunked(seqs, finished)
            return
        by_bucket: Dict[int, List[Sequence]] = {}
        for seq in seqs:
            bucket = next(b for b in self._buckets if b >= seq.num_tokens)
            by_bucket.setdefault(bucket, []).append(seq)
        for bucket, group in by_bucket.items():
            for i in range(0, len(group), self.cfg.max_prefill_batch):
                self._prefill_chunk(group[i : i + self.cfg.max_prefill_batch], bucket)

    def _prefill_chunk(self, chunk: List[Sequence], bucket: int) -> None:
        # Pad to {1, max_prefill_batch} rows, as the JAX engine does.
        B = 1 if len(chunk) == 1 else self.cfg.max_prefill_batch
        tokens = np.zeros((B, bucket), np.int32)
        lengths = np.zeros((B,), np.int32)
        bt = np.zeros((B, self._pages_per_seq), np.int32)
        for r, seq in enumerate(chunk):
            ids = seq.prompt_ids + seq.output_ids
            tokens[r, : len(ids)] = ids
            lengths[r] = len(ids)
            bt[r, : len(seq.pages)] = seq.pages
        chunk_mode = sampling_mod.join_modes(sampling_mod.required_mode(s.params) for s in chunk)
        if any(s.params.min_tokens > 0 for s in chunk):
            self._suppress = True
        with self._wd("prefill"):  # the upload waits behind the queued work too
            args = self._to_device(
                dict(tokens=tokens, lengths=lengths, bt=bt, **self._pack_sampling_rows(chunk, B))
            )
            t0 = time.monotonic()
            for seq in chunk:
                if seq.t_prefill_start == 0.0:
                    seq.t_prefill_start = t0
            out, g = self._prefill_fn(args, len(chunk), chunk_mode)
            self._record_dispatch("prefill", time.monotonic() - t0)
        for seq in chunk:
            seq.prefilled = True
            self.prefill_tokens += seq.num_tokens
        self.prefills += len(chunk)
        self.prefill_dispatches += 1
        self._push_pending("prefill", out, list(enumerate(chunk)), guard=g)
        self._mode = sampling_mod.join_modes((self._mode, chunk_mode))

    def _prefill_chunked(self, seqs: List[Sequence], finished: List[RequestOutput]) -> None:
        """Chunked prefill: run each admitted group's prompts through
        fixed [B, C] chunks, C positions at a time, each row from its own
        ``prefix_len`` on (the prefix-cached positions already sit in its
        shared leading pages), and interleave one decode step for the
        already-running batch between chunks."""
        C = self.cfg.prefill_chunk_size
        B = self.cfg.max_prefill_batch
        # Interleave decode only for sequences decodable BEFORE this wave:
        # a cold-start wave must not decode its own fresh rows at tiny
        # occupancy.
        pre_wave = [s.rid for s in self._decodable_seqs()]
        for i in range(0, len(seqs), B):
            rows = seqs[i : i + B]
            # Chunk-invariant per-row values, snapshotted ONCE: interleaved
            # decode steps append tokens to rows that went final in an
            # earlier chunk, and a re-read length would mark such a row
            # final again (block tables are the exception: pages only grow,
            # and the final scatter should carry the freshest map).
            lens = [seq.num_tokens for seq in rows]
            ids0 = [seq.prompt_ids + seq.output_ids for seq in rows]
            prefix0 = [seq.prefix_len for seq in rows]
            lengths0 = np.zeros((B,), np.int32)
            lengths0[: len(rows)] = lens
            inv = self._to_device(dict(lengths=lengths0, **self._pack_sampling_rows(rows, B)))
            chunk_mode = sampling_mod.join_modes(
                sampling_mod.required_mode(s.params) for s in rows
            )
            if any(s.params.min_tokens > 0 for s in rows):
                self._suppress = True
            maxlen = max(lens)
            for lo in range(0, maxlen, C):
                tokens = np.zeros((B, C), np.int32)
                positions = np.full((B, C), -1, np.int32)
                bt = np.zeros((B, self._pages_per_seq), np.int32)
                last = np.zeros((B,), np.int32)
                snapshot: List[Tuple[int, Sequence]] = []
                any_rows = False
                for r, seq in enumerate(rows):
                    n = lens[r]
                    hi = min(n, lo + C)
                    row_start = max(lo, prefix0[r])
                    if lo >= n or hi <= prefix0[r] or seq.rid not in self.scheduler.running:
                        continue  # nothing to compute: a padding row
                    any_rows = True
                    self.prefill_tokens += hi - row_start
                    tokens[r, : hi - row_start] = ids0[r][row_start:hi]
                    positions[r, : hi - row_start] = np.arange(row_start, hi)
                    bt[r, : len(seq.pages)] = seq.pages
                    if row_start <= n - 1 < hi:
                        last[r] = n - 1 - row_start
                        snapshot.append((r, seq))
                if not any_rows:
                    continue  # the whole chunk lies inside every row's prefix
                with self._wd("prefill"):
                    chunk = self._to_device(dict(tokens=tokens, positions=positions, bt=bt,
                                                 last=last))
                    t0 = time.monotonic()
                    for seq in rows:
                        if seq.t_prefill_start == 0.0:
                            seq.t_prefill_start = t0
                    # The JAX chunkfill_step: every row extends its cached
                    # K/V; rows whose prompt ends here sample their first
                    # token and join the decode state. The guard watches
                    # every row's chunk logits, final or not (JAX :1648).
                    logits = self.model.prefill_chunk(
                        chunk["tokens"], chunk["positions"], self.k_pages, self.v_pages,
                        chunk["bt"], chunk["last"],
                    )
                    g = self._guard_fold(logits, inv["slots"] >= 0)
                    self.prefill_dispatches += 1
                    if snapshot:  # rows whose prompt finished in this chunk
                        final = torch.tensor([r for r, _ in snapshot], device=self.device)
                        out = self._sample_and_scatter(logits, {**inv, "bt": chunk["bt"]}, final,
                                                       chunk_mode)
                    self._record_dispatch("prefill", time.monotonic() - t0)
                if snapshot:
                    for _, seq in snapshot:
                        seq.prefilled = True
                        self.scheduler.register_prefix(seq)
                    self.prefills += len(snapshot)
                    self._push_pending("prefill", out, snapshot, guard=g)
                    self._mode = sampling_mod.join_modes((self._mode, chunk_mode))
                elif g is not None:  # the verdict rides the pipeline alone
                    self._push_pending("prefill", None, [], guard=g)
                if lo + C < maxlen and any(rid in self.scheduler.running for rid in pre_wave):
                    self._dispatch_decode(finished)

    def _prefill_mixed(self, seqs: List[Sequence], finished: List[RequestOutput]) -> None:
        """Piggyback scheduling (JAX ``_prefill_mixed``, :3412): prefill
        each admitted sequence by fusing its chunk segments into the decode
        dispatches. Every mixed dispatch advances the running batch by
        ``decode_block`` tokens while the piggy's prompt comes in under the
        per-iteration budget (``mixed_token_budget``); one sequence at a
        time. When its final segment lands before a dispatch's last
        iteration, the remaining iterations decode it (pages for those
        positions are ensured first; under pool pressure the plan moves the
        final segment to the last iteration, which needs none). With
        nothing decodable the plain chunk loop runs instead."""
        C = self.cfg.prefill_chunk_size
        K = self.cfg.decode_block
        for seq in seqs:
            if not self._decodable_seqs():
                self._prefill_chunked([seq], finished)
                continue
            epoch0 = seq.epoch
            # Chunk-invariant values, snapshotted once: mixed dispatches
            # append tokens to OTHER rows, never to the mid-prefill piggy.
            n = seq.num_tokens
            ids0 = seq.prompt_ids + seq.output_ids
            cur = seq.prefix_len  # cached prefix pages already hold KV
            seq_mode = sampling_mod.required_mode(seq.params)
            piggy = dict(lengths=np.asarray([n], np.int32), **self._pack_sampling_rows([seq], 1))
            if seq.params.min_tokens > 0:
                self._suppress = True
            while cur < n:
                if seq.rid not in self.scheduler.running or seq.epoch != epoch0:
                    break  # preempted mid-prefill; re-admission restarts
                # This dispatch's K segments under the token budget (decode
                # rows first, the remainder to the piggy's prompt).
                decode_rows = len(self._decodable_seqs())
                segs: List[Tuple[int, int]] = []
                pos, final_k = cur, None
                for k in range(K):
                    take = mixed_token_budget(C, decode_rows, n - pos)
                    segs.append((pos, take))
                    pos += take
                    if take and pos >= n:
                        final_k = k
                if final_k is not None and final_k < K - 1:
                    # The iterations after activation decode the piggy,
                    # writing positions n..n+K-2-final_k: pages first.
                    extra = K - 1 - final_k
                    try:
                        self.scheduler.ensure_pages(seq, self._page_target(seq, extra),
                                                    allow_preempt=False)
                    except OutOfPages:
                        self._drain(finished)
                        self._flush_deferred()
                        try:
                            self.scheduler.ensure_pages(seq, self._page_target(seq, extra),
                                                        allow_preempt=False)
                        except OutOfPages:
                            # Re-plan: the final segment at the LAST
                            # iteration (empty middles are pure decode).
                            start, take = segs[final_k]
                            for k in range(final_k, K - 1):
                                segs[k] = (start, 0)
                            segs[K - 1] = (start, take)
                            final_k = K - 1
                # The decode rows' own lookahead and dirty resync: the mixed
                # dispatch IS their decode dispatch.
                if not self._ensure_decode_pages(finished):
                    break
                if seq.rid not in self.scheduler.running or seq.epoch != epoch0:
                    break
                host = dict(
                    tokens=np.zeros((K, C), np.int32), positions=np.full((K, C), -1, np.int32),
                    final=np.zeros((K,), bool), last=np.zeros((K,), np.int32),
                    bt=np.zeros((1, self._pages_per_seq), np.int32), **piggy,
                )
                for k, (start, take) in enumerate(segs):
                    if take:
                        host["tokens"][k, :take] = ids0[start : start + take]
                        host["positions"][k, :take] = np.arange(start, start + take)
                if final_k is not None:
                    host["final"][final_k] = True
                    host["last"][final_k] = n - 1 - segs[final_k][0]
                host["bt"][0, : len(seq.pages)] = seq.pages  # live: grow-only
                seg = self._mixed_inputs(host)
                # The dispatch must cover the piggy's sampler needs too.
                mode = sampling_mod.join_modes((self._mode, seq_mode))
                if seq.t_prefill_start == 0.0:
                    seq.t_prefill_start = time.monotonic()
                t0 = time.monotonic()
                with self._wd("mixed"):
                    out = self._dispatch_block("mixed", seg, mode)
                    self._record_dispatch("mixed", time.monotonic() - t0)
                out, g = self._split_guard(out)
                taken = sum(t for _, t in segs)
                self.mixed_steps += 1
                self.mixed_prefill_tokens += taken
                self.prefill_tokens += taken
                self.decode_steps += K
                self.decode_dispatches += 1
                if final_k is not None:
                    seq.prefilled = True
                    self.scheduler.register_prefix(seq)
                    self.prefills += 1
                    self._mode = mode
                # Snapshot after marking prefilled, so the piggy's row is
                # in it; its tokens before final_k are skipped by starts.
                starts = np.zeros((self.cfg.max_num_seqs,), np.int32)
                if final_k is not None:
                    starts[seq.slot] = final_k
                self._push_pending(
                    "mixed", out,
                    [(i, s) for i, s in enumerate(self.scheduler.slots)
                     if s is not None and s.prefilled],
                    starts, guard=g,
                )
                while len(self._pending) > self.cfg.runahead:
                    self._process_oldest(finished)
                cur = pos

    def _mixed_inputs(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Upload a mixed dispatch's inputs into their static device
        buffers (made anew, and the graphs dropped, when a shape changes:
        a wider stop-id set)."""
        bufs = self._mixed_in
        if bufs is None or any(bufs[k].shape != v.shape for k, v in host.items()):
            bufs = self._mixed_in = {k: torch.from_numpy(v.copy()).to(self.device)
                                     for k, v in host.items()}
            if self._graphs is not None:
                self._graphs.reset()
            return bufs
        for name, arr in host.items():
            self._upload(bufs[name], arr)
        return bufs

    # --- decode -----------------------------------------------------------
    def _ensure_decode_pages(self, finished: List[RequestOutput]) -> bool:
        """Page lookahead for every decodable row, then the dirty drain +
        resync. Returns False when nothing is left running.

        Every position an in-flight or about-to-dispatch step may write
        must have a page now: pages are only ever added to a block table,
        so the grown table swaps into the device state without a drain.
        Only allocator exhaustion (preemption needed) forces a drain."""
        # Each in-flight decode-type dispatch covers decode_block positions
        # (times spec_tokens + 1 under speculation: a verify iteration writes
        # every candidate), and this dispatch another block; + 1 slack.
        K, Q = self.cfg.decode_block, self.cfg.spec_tokens + 1
        lookahead = (self._pending_decodes + 1) * K * Q + 1
        decodable = self._decodable_seqs()
        needs_pages = any(
            -(-self._page_target(seq, lookahead) // self.cfg.page_size) > len(seq.pages)
            for seq in decodable
        )
        if needs_pages:
            grown = False
            for seq in decodable:
                if seq.rid not in self.scheduler.running:
                    continue  # preempted by an earlier iteration's ensure
                try:
                    # Amortize: top up a full page beyond the need.
                    before = len(seq.pages)
                    self.scheduler.ensure_pages(
                        seq,
                        self._page_target(seq, lookahead + self.cfg.page_size),
                        allow_preempt=False,
                    )
                    grown = grown or len(seq.pages) > before
                except OutOfPages:
                    # Pool exhausted: catch the host up so deferred pages
                    # return and preemption can free a victim safely.
                    self._drain(finished)
                    if seq.rid not in self.scheduler.running:
                        continue
                    try:
                        self.scheduler.ensure_pages(
                            seq,
                            self._page_target(seq, lookahead),
                            preemptible=lambda s: s.prefilled,
                        )
                    except OutOfPages:
                        if len(self.scheduler.running) == 1:
                            # Alone and still short: the pool is the cap.
                            self._finish_seq(seq, "length", device_detected=False,
                                             finished=finished)
                        else:
                            # Others hold the pool: retry later, keeping
                            # the generated tokens (recompute preemption).
                            self._self_preempt_deferred(seq)
                        continue
                    self._dirty = True
            if grown and not self._dirty:
                self._swap_block_tables()
        if self._dirty:
            self._drain(finished)
            if not self.scheduler.running:
                return False
            self._resync()
        return True

    def _dispatch_decode(self, finished: List[RequestOutput]) -> None:
        if not self._ensure_decode_pages(finished):
            return
        kind = "verify" if self._spec else "decode"
        # The dispatch kind's name in the metrics, JAX's (:3778).
        label = "verify" if self._spec else "decode_block"
        K = self.cfg.decode_block
        if 0 < self.interactive_decode_block < K and any(
            s.prefilled and s.priority == "interactive" for s in self.scheduler.running.values()
        ):
            # An interactive row is resident: the small-K block brings its
            # tokens home every interactive_decode_block iterations (JAX
            # :3779-3790); pure-batch dispatches keep the big block.
            K = self.interactive_decode_block
            label += "_small"
        t0 = time.monotonic()
        with self._wd(label):
            out = self._dispatch_block(kind, K=K)
            self._record_dispatch(label, time.monotonic() - t0)
        out, g = self._split_guard(out)
        self.decode_steps += K
        self.decode_dispatches += 1
        self._push_pending(
            kind,
            out,
            [
                (i, seq)
                for i, seq in enumerate(self.scheduler.slots)
                if seq is not None and seq.prefilled
            ],
            guard=g,
        )
        while len(self._pending) > self.cfg.runahead:
            self._process_oldest(finished)

    def _self_preempt_deferred(self, seq: Sequence) -> None:
        """Preempt ``seq`` itself; its pages return to the allocator only
        after every in-flight step that may write them is processed. Under
        ``preempt_mode="swap"`` its pages are queued for a host capture at
        that same watermark, and re-admission writes them back instead of
        re-prefilling (JAX :3813-3841)."""
        swap = self.preempt_mode == "swap" and seq.prefilled and bool(seq.pages)
        pages_copy = list(seq.pages) if swap else None
        kv_valid = seq.num_tokens - 1
        pages, cacheable = self.scheduler.preempt(seq, defer_pages=True)
        if swap:
            # The epoch after the bump: the capture fires only for this
            # preemption, not a later one of the same sequence.
            self._pending_swaps.append((self._dispatch_idx, seq, pages_copy, kv_valid, seq.epoch))
        if pages:
            self._deferred_pages.append((self._dispatch_idx, pages, cacheable))
        self._dirty = True

    def _swap_block_tables(self) -> None:
        """Ship grown block tables into the device state, in place, without
        a drain (queued dispatches read the old tables first)."""
        self._h_bt[...] = 0
        for i, seq in enumerate(self.scheduler.slots):
            if seq is not None:
                self._h_bt[i, : len(seq.pages)] = seq.pages
        self._upload(self._dev_state[2], self._h_bt)

    def _page_target(self, seq: Sequence, lookahead: int) -> int:
        """KV positions ``seq`` must have pages for, capped by its own
        finish horizon and the per-sequence page map."""
        horizon = len(seq.prompt_ids) + seq.params.max_tokens + 1
        cap = self._pages_per_seq * self.cfg.page_size
        return min(seq.num_tokens + lookahead, horizon, cap)

    def _append_and_check(self, seq: Sequence, token: int, finished: List[RequestOutput]) -> None:
        if seq.prefill_only and not seq.output_ids:
            # The prefill boundary (JAX :3866): the prompt KV is complete and
            # the device sampled the first token. Drop it (the adopting
            # engine re-derives the key chain and samples it again), snapshot
            # the prompt KV while the pages are held and finish. The
            # snapshot's kv_valid = len(prompt) - 1 is insert_request's
            # contract for an empty output: the adopter computes only the
            # last prompt position again.
            self._prefill_snapshots[seq.rid] = self._snapshot_seq(seq)
            self.prefill_done += 1
            self._finish_seq(seq, "prefill_done", device_detected=False, finished=finished)
            return
        seq.output_ids.append(token)
        self.total_generated_tokens += 1
        interactive = seq.priority == "interactive"
        self.class_tokens["interactive" if interactive else "batch"] += 1
        now = time.monotonic()
        if seq.t_first_token == 0.0:
            seq.t_first_token = now
            if seq.t_enqueue > 0.0:
                self.ttft_hist.observe(now - seq.t_enqueue)
                if interactive:
                    self.ttft_hist_interactive.observe(now - seq.t_enqueue)
        elif seq.t_last_token > 0.0:
            # The host-boundary gap: the tokens of one fused block arrive in
            # a burst, hence ITL_BUCKETS' sub-millisecond end.
            self.itl_hist.observe(now - seq.t_last_token)
            if interactive:
                self.itl_hist_interactive.observe(now - seq.t_last_token)
        seq.t_last_token = now
        # Stops are checked BEFORE the page top-up: a stopping sequence
        # needs no more pages.
        n_before = len(seq.output_ids)
        reason = self._stop_reason(seq, token)
        if reason is not None:
            # The token streams iff it survived the stop check (length
            # finishes keep it; stop tokens are popped; a stop-string hit
            # pre-truncates the text).
            if (self.on_token is not None and len(seq.output_ids) == n_before
                    and seq.finish_text is None):
                self.on_token(seq, token)
            # Token stops and length caps were detected on the device
            # (advance_state); only stop strings force a resync.
            self._finish_seq(seq, reason, device_detected=seq.finish_text is None,
                             finished=finished)
            return
        if self.on_token is not None:
            self.on_token(seq, token)
        try:
            # Pages were pre-allocated at dispatch time; a no-op except
            # under pool exhaustion.
            self.scheduler.ensure_pages(seq, seq.num_tokens + 1, allow_preempt=False)
        except OutOfPages:
            self._flush_deferred()
            try:
                self.scheduler.ensure_pages(seq, seq.num_tokens + 1, allow_preempt=False)
                return
            except OutOfPages:
                pass
            if len(self.scheduler.running) == 1 and not self._deferred_pages:
                self._finish_seq(seq, "length", device_detected=False, finished=finished)
            else:
                self._self_preempt_deferred(seq)

    def _finish_seq(
        self, seq: Sequence, reason: str, *, device_detected: bool,
        finished: List[RequestOutput],
    ) -> None:
        pages, cacheable = self.scheduler.finish(seq, reason, defer_pages=True)
        if pages:
            self._deferred_pages.append((self._dispatch_idx, pages, cacheable))
        if not device_detected:
            self._dirty = True
        finished.append(self._output_for(seq))

    def _stop_reason(self, seq: Sequence, token: int) -> Optional[str]:
        p = seq.params
        # Token stops are popped from the output, so the surviving output
        # must still hold min_tokens afterwards (strict compare).
        past_min_tok = len(seq.output_ids) > p.min_tokens
        past_min = len(seq.output_ids) >= p.min_tokens
        if past_min_tok and token in p.stop_token_ids:
            seq.output_ids.pop()
            return "stop"
        if past_min_tok and not p.ignore_eos and token in self._eos_ids:
            seq.output_ids.pop()
            return "stop"
        if len(seq.output_ids) >= p.max_tokens:
            return "length"
        if p.stop and past_min:
            # Incremental detokenization: only the tail past the cached
            # head is decoded per token; the head trails the end by a
            # window wide enough that a match never hides in it.
            window = max(len(s) for s in p.stop) + 8
            tail = self._detok_tail(seq, window)
            seam = max(len(s) for s in p.stop) - 1
            hay = seq.detok_text[-seam:] + tail if seam > 0 else tail
            if any(s in hay for s in p.stop):
                text = seq.detok_text + tail
                hits = [i for i in (text.find(s) for s in p.stop) if i >= 0]
                if hits:
                    seq.finish_text = text[: min(hits)]  # earliest match
                    self._trim_to_match(seq, p.stop)
                    return "stop"
        return None

    def _detok_tail(self, seq: Sequence, window: int) -> str:
        n = len(seq.output_ids)
        if seq.detok_len > n:  # output was truncated past the cache
            seq.detok_len, seq.detok_text = 0, ""
        if n - seq.detok_len > window:
            m = n - window
            seq.detok_text += self.tokenizer.decode(seq.output_ids[seq.detok_len : m])
            seq.detok_len = m
        return self.tokenizer.decode(seq.output_ids[seq.detok_len :])

    def _trim_to_match(self, seq: Sequence, stops) -> None:
        """Drop output tokens past the stop-string match so token_ids and
        usage agree with the truncated text."""
        seam = max(len(s) for s in stops) - 1
        head_tail = seq.detok_text[-seam:] if seam > 0 else ""
        lo = seq.detok_len
        for n in range(lo, len(seq.output_ids) + 1):
            head = head_tail + self.tokenizer.decode(seq.output_ids[lo:n])
            if any(s in head for s in stops):
                seq.output_ids = seq.output_ids[:n]
                return

    def _output_for(self, seq: Sequence) -> RequestOutput:
        if (seq.finish_reason or "stop") in ("stop", "length"):
            self.class_finished["interactive" if seq.priority == "interactive" else "batch"] += 1
        text = seq.finish_text
        if text is None:
            text = self.tokenizer.decode(seq.output_ids)
        timing: Optional[Dict[str, float]] = None
        if seq.t_enqueue > 0.0:
            timing = {
                "enqueued": seq.t_enqueue,
                "admitted": seq.t_admit,
                "prefill_start": seq.t_prefill_start,
                "first_token": seq.t_first_token,
                "last_token": seq.t_last_token,
                "finished": time.monotonic(),
                "preempt_count": float(seq.preempt_count),
            }
        return RequestOutput(
            rid=seq.rid,
            text=text,
            token_ids=list(seq.output_ids),
            prompt_tokens=len(seq.prompt_ids),
            completion_tokens=len(seq.output_ids),
            finish_reason=seq.finish_reason or "stop",
            timing=timing,
            snapshot=self._prefill_snapshots.pop(seq.rid, None),
        )

    # --- snapshot plane ---------------------------------------------------
    def _model_sig(self) -> Dict[str, Any]:
        """The shape contract a snapshot's KV pages must match (JAX
        :4078; ``kv_dtype`` as ``str(jnp.dtype(...))`` writes it). Weights
        are not part of it: peers serve the same checkpoint."""
        return {
            "num_layers": int(self.model_config.num_layers),
            "num_kv_heads": int(self.model_config.num_kv_heads),
            "head_dim": int(self.model_config.head_dim_),
            "kv_dtype": self._kv_name,
        }

    def _snapshot_seq(self, seq: Sequence) -> RequestSnapshot:
        """Host state of one unfinished sequence (JAX :4091). KV pages come
        from its pending swap restore, or a gather (prefilled and running),
        or not at all (waiting or mid-prefill: insertion re-prefills)."""
        p = seq.params
        kv_k = kv_v = None
        kv_valid = 0
        if seq.restore is not None:
            kv_k, kv_v, kv_valid = seq.restore.k, seq.restore.v, seq.restore.valid
        elif seq.prefilled and seq.rid in self.scheduler.running and seq.pages:
            kv_valid = seq.num_tokens - 1
            n = snapshot_mod.pages_for(kv_valid, self.cfg.page_size)
            if 0 < n <= len(seq.pages):
                kv_k, kv_v = self._kv_gather(seq.pages[:n])
            else:
                kv_valid = 0
        return RequestSnapshot(
            rid=seq.rid, model_sig=self._model_sig(), page_size=self.cfg.page_size,
            prompt_ids=list(seq.prompt_ids), output_ids=list(seq.output_ids),
            params=dataclasses.replace(p),
            key_data=np.asarray(make_base_key(p.seed, request_tag(seq.rid)), np.uint32),
            epoch=seq.epoch, preempt_count=seq.preempt_count, detok_len=seq.detok_len,
            detok_text=seq.detok_text, kv_valid=kv_valid, kv_k=kv_k, kv_v=kv_v,
            kv_dtype=self._kv_name,
        )

    def _remove_extracted(self, seq: Sequence) -> None:
        if seq.rid in self.scheduler.running:
            was_prefilled = seq.prefilled
            # The pipeline is drained (extraction drains first), so the
            # pages release now.
            self.scheduler.finish(seq, "extracted")
            if was_prefilled:
                self._dirty = True
        else:
            try:
                self.scheduler.waiting.remove(seq)
            except ValueError:
                pass
        seq.restore = None

    def extract_request(self, rid: str, *,
                        finished: Optional[List[RequestOutput]] = None) -> RequestSnapshot:
        """Pull one in-flight request out as a :class:`RequestSnapshot`
        and remove it (JAX :4147). Drains the run-ahead pipeline first;
        outputs observed during that drain go to ``finished`` (a request
        that finishes in it raises KeyError here). Greedy continuation
        after :meth:`insert_request` equals never extracting."""
        out = finished if finished is not None else []
        self._drain(out)
        seq = self.scheduler.running.get(rid)
        if seq is None:
            seq = next((s for s in self.scheduler.waiting if s.rid == rid), None)
        if seq is None or seq.finish_reason is not None:
            raise KeyError(f"no in-flight request {rid!r} to extract")
        snap = self._snapshot_seq(seq)
        self._remove_extracted(seq)
        self.snapshots_extracted += 1
        return snap

    def extract_all(self, *, finished: Optional[List[RequestOutput]] = None
                    ) -> List[RequestSnapshot]:
        """Extract every unfinished request (drain-with-handoff; JAX
        :4174). See :meth:`extract_request`."""
        out = finished if finished is not None else []
        self._drain(out)
        snaps: List[RequestSnapshot] = []
        for seq in list(self.scheduler.running.values()) + list(self.scheduler.waiting):
            if seq.finish_reason is not None:
                continue
            snaps.append(self._snapshot_seq(seq))
            self._remove_extracted(seq)
            self.snapshots_extracted += 1
        return snaps

    def discard_pending(self, *, reuse_pool: bool = False) -> None:
        """Drop every in-flight dispatch result unread (JAX :4193), for
        recovery: the sequences' host state up to the last processed step
        is consistent, and re-inserting their snapshots recomputes the
        lost iterations (same key chain, same step counts). With
        ``reuse_pool`` the deferred pages go back to the allocator (any
        in-flight write to them is stream-ordered before their next use);
        else their bookkeeping is dropped with the pool."""
        self._pending.clear()
        self._pending_decodes = 0
        self._pending_swaps.clear()  # dropped captures re-prefill instead
        self._processed_idx = self._dispatch_idx
        if reuse_pool:
            for _, pages, cacheable in self._deferred_pages:
                self.scheduler.release_pages(pages, cacheable)
        self._deferred_pages.clear()
        self._dirty = True

    def extract_for_rebuild(self, *, reuse_pool: bool = False
                            ) -> Tuple[List[Tuple[RequestSnapshot, Optional[float]]], List[str]]:
        """Best-effort snapshot of every in-flight request after a device
        fault, for re-insertion into a rebuilt (or, with ``reuse_pool``,
        the same) engine (JAX :4222). The in-flight results are dropped
        unread (:meth:`discard_pending`), then each sequence snapshots on
        its own: a gather from a faulted device can itself fail. Returns
        ``([(snapshot, deadline_at)], lost rids)``; the lost requeue."""
        self.discard_pending(reuse_pool=reuse_pool)
        snaps: List[Tuple[RequestSnapshot, Optional[float]]] = []
        lost: List[str] = []
        for seq in list(self.scheduler.running.values()) + list(self.scheduler.waiting):
            if seq.finish_reason is not None:
                continue
            try:
                snap = self._snapshot_seq(seq)
            except Exception:  # noqa: BLE001 — per-row isolation
                logger.exception("fault recovery: snapshot of %s failed; the request will "
                                 "requeue instead", seq.rid)
                lost.append(seq.rid)
                # Removed all the same: left behind in the same-pool restore,
                # it would go on generating for a future already requeued.
                self._remove_extracted(seq)
                continue
            snaps.append((snap, seq.deadline_at))
            self._remove_extracted(seq)
            self.snapshots_extracted += 1
        return snaps, lost

    def degrade_for_oom(self) -> Optional[str]:
        """One rung of the OOM ladder a call, in order (JAX :4262): demote
        the refcount-0 prefix pages to the host tier, halve the run-ahead,
        swap-preempt one victim. Returns the rung taken, or None when the
        ladder is dry (the caller then rebuilds). Rungs never reset: a
        pool that ran out once stays degraded for this engine's life."""
        self.hbm_oom_events += 1
        while self._oom_rung < 3:
            rung = self._oom_rung
            self._oom_rung += 1
            if rung == 0:
                if self.prefix_store is not None:
                    dropped = self.flush_prefix_to_host()
                    if dropped > 0:
                        self._oom_ladder_log.append("demote_prefix")
                        logger.warning("hbm_oom ladder: demoted %d prefix pages to the host "
                                       "tier", dropped)
                        return "demote_prefix"
            elif rung == 1:
                if self.cfg.runahead > 1:
                    self.cfg.runahead = max(1, self.cfg.runahead // 2)
                    self._oom_ladder_log.append("shrink_runahead")
                    logger.warning("hbm_oom ladder: run-ahead shrunk to %d", self.cfg.runahead)
                    return "shrink_runahead"
            else:
                victim = next((s for s in reversed(list(self.scheduler.running.values()))
                               if s.prefilled and s.finish_reason is None), None)
                if victim is not None:
                    # The swap flavour for this one preemption: the rung
                    # frees device memory without a re-prefill on top.
                    prev, self.preempt_mode = self.preempt_mode, "swap"
                    try:
                        self._self_preempt_deferred(victim)
                    finally:
                        self.preempt_mode = prev
                    self._oom_ladder_log.append("preempt_swap")
                    logger.warning("hbm_oom ladder: swap-preempted %s", victim.rid)
                    return "preempt_swap"
        return None

    def release(self) -> None:
        """Free this engine's device memory before a rebuilt one is made
        (a second full-size engine beside it would not fit): stop the
        watchdog, drop the captured graphs, the pools, the decode state and
        the weights, and return the cached blocks to the device. The
        engine takes no dispatch after it."""
        self.stop_watchdog()
        self.close()
        if self._graphs is not None:
            self._graphs.reset()
        self.model = None
        self.k_pages = self.v_pages = None
        self._dev_state = self._mixed_in = None
        self._pending.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def insert_request(self, snap: RequestSnapshot, *,
                       deadline_at: Optional[float] = None) -> Sequence:
        """Re-insert an extracted request, here or on another engine (JAX
        :4323). Its KV pages go to whatever pages admission hands out
        (repacked on the host if the page size differs); the key chain is
        re-derived from (seed, rid) and checked against the snapshot's bit
        for bit. A snapshot without KV re-prefills prompt + output."""
        sig, mine = dict(snap.model_sig), self._model_sig()
        if sig != mine:
            raise SnapshotCompatError(
                f"snapshot model signature {sig} does not match engine {mine}")
        if snap.rid in self.scheduler.running or any(
                s.rid == snap.rid for s in self.scheduler.waiting):
            raise ValueError(f"request {snap.rid!r} is already in flight on this engine")
        params = dataclasses.replace(snap.params)
        expect = np.asarray(make_base_key(params.seed, request_tag(snap.rid)), np.uint32)
        got = np.asarray(snap.key_data, np.uint32)
        if got.shape != expect.shape or not np.array_equal(got, expect):
            raise SnapshotCompatError(
                "sampling-key chain mismatch: the snapshot's base key does not re-derive "
                "from (seed, rid) on this engine")
        need = len(set(params.stop_token_ids) | (set() if params.ignore_eos else self._eos_ids))
        if need > self._stop_capacity:
            self._grow_stop_capacity(need)
        seq = Sequence(
            rid=snap.rid, prompt_ids=[int(t) for t in snap.prompt_ids], params=params,
            output_ids=[int(t) for t in snap.output_ids],
            # A fresh epoch lineage; +1 as a preemption would have done.
            epoch=snap.epoch + 1, preempt_count=snap.preempt_count,
            detok_len=snap.detok_len, detok_text=snap.detok_text, deadline_at=deadline_at,
        )
        if deadline_at is not None:
            self._deadlines_enabled = True
        if snap.kv_k is not None and snap.kv_v is not None and snap.kv_valid > 0:
            if snap.kv_valid != seq.num_tokens - 1:
                raise SnapshotCompatError(
                    f"snapshot KV covers {snap.kv_valid} positions but "
                    f"{seq.num_tokens - 1} are needed to continue decode")
            k, v = snap.kv_k, snap.kv_v
            if snap.page_size != self.cfg.page_size:
                n_dst = snapshot_mod.pages_for(snap.kv_valid, self.cfg.page_size)
                k = snapshot_mod.repack_pages(k, snap.kv_valid, self.cfg.page_size, n_dst)
                v = snapshot_mod.repack_pages(v, snap.kv_valid, self.cfg.page_size, n_dst)
            seq.restore = KVRestore(k=k, v=v, valid=snap.kv_valid, dtype=snap.kv_dtype)
        self.total_prompt_tokens += len(seq.prompt_ids)
        self.scheduler.add_restored(seq)
        self.snapshots_inserted += 1
        return seq

    def _restore_batch(self, seqs: List[Sequence]) -> None:
        """Write admitted sequences' host KV pages into the pools, in
        place, and mark them prefilled (JAX :4407); their decode-state
        rows join through the dirty resync of the next dispatch."""
        for seq in seqs:
            r, seq.restore = seq.restore, None
            n = r.k.shape[1]
            # admit() allocated pages for num_tokens + 1 positions, which
            # always covers ceil(valid / page) pages of data.
            assert n <= len(seq.pages), (n, len(seq.pages))
            self._kv_insert(seq.pages[:n], r.k, r.v)
            seq.prefilled = True
            if seq.t_prefill_start == 0.0:
                seq.t_prefill_start = time.monotonic()
            self.scheduler.register_prefix(seq)
            self.kv_restores += 1
        self._dirty = True

    # --- the integrity plane ----------------------------------------------
    def _canary_generate(self) -> List[int]:
        """The golden prompt greedily to its end on an idle engine (JAX
        :4429): fixed small ids, temperature 0, EOS ignored, so only the
        weights and the compute can change its tokens."""
        v = self.model_config.vocab_size
        self.add_request("__canary__", prompt_ids=[(i * 7 + 1) % v for i in range(8)],
                         params=SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True))
        tokens: List[int] = []
        for _ in range(256):  # 8 tokens need far fewer steps
            for out in self.step():
                if out.rid == "__canary__":
                    tokens = list(out.token_ids)
            if not self.has_work:
                break
        return tokens

    def _generate_canary(self) -> List[int]:
        """The golden canary tokens, recorded at build (fresh weights)."""
        golden = self._canary_generate()
        logger.info("canary golden recorded: %d token(s), fold=%s", len(golden),
                    integrity_mod.token_fold(golden))
        return golden

    def run_canary(self) -> bool:
        """Replay the golden prompt on an idle engine and compare its greedy
        tokens bit for bit with the recording (JAX :4466); a busy engine
        skips. A mismatch, or a raise (a guard trip) counts a failure."""
        if self._canary_golden is None or self.has_work:
            return True
        self.canary_runs += 1
        try:
            got = self._canary_generate()
        except Exception as exc:  # noqa: BLE001 — a trip IS a failure
            self.canary_failures += 1
            self.abort_all("canary_failed")  # reusable after the failed replay
            logger.error("canary replay raised: %s", exc)
            raise
        if got == self._canary_golden:
            return True
        self.canary_failures += 1
        logger.error("canary FAILURE: got %s (fold=%s) want %s (fold=%s)", got,
                     integrity_mod.token_fold(got), self._canary_golden,
                     integrity_mod.token_fold(self._canary_golden))
        return False

    def audit_weights(self) -> List[str]:
        """Digest every parameter leaf again and name those that changed
        since the build's baseline (JAX :4500): weight corruption, where
        the guard catches transient compute errors. Two reads of an intact
        buffer always agree."""
        if self._weight_baseline is None:
            return []
        self.weight_audits += 1
        with self._wd("weight_audit"):
            current = integrity_mod.digest_params(self.params)
        mismatched = integrity_mod.diff_digests(self._weight_baseline, current)
        if mismatched:
            self.weight_audit_mismatches += len(mismatched)
            self._last_audit_mismatch = list(mismatched)
            logger.error("weight audit: %d leaf/leaves changed in device memory since load: %s",
                         len(mismatched), mismatched[:8])
        return mismatched

    def kv_spot_check(self, max_pages: int = 4) -> List[str]:
        """Read-stability check of the KV pool (JAX :4527): gather a
        deterministic sample of in-use pages twice and compare their
        blake2b digests; names the pages that read back differently."""
        in_use = sorted({p for s in self.scheduler.running.values() for p in s.pages})
        if not in_use:
            return []
        stride = max(1, len(in_use) // max_pages)
        sample = in_use[::stride][:max_pages]
        self.kv_spot_checks += 1
        k1, v1 = self._kv_gather(sample, "kv_spot")
        k2, v2 = self._kv_gather(sample, "kv_spot")
        mismatched: List[str] = []
        for name, first, second in (("k", k1, k2), ("v", v1, v2)):
            # [L, n, page, H, D] -> one digest a sampled page
            da = integrity_mod.page_digests(np.moveaxis(first, 1, 0))
            db = integrity_mod.page_digests(np.moveaxis(second, 1, 0))
            mismatched.extend(f"{name}:page{p}" for p, x, y in zip(sample, da, db) if x != y)
        if mismatched:
            logger.error("kv spot check: %d page read(s) unstable: %s", len(mismatched),
                         mismatched)
        return mismatched

    def maybe_idle_integrity(self) -> Optional[str]:
        """The idle sweep between batches (JAX :4574): the checks whose
        cadence came due. Returns what is wrong (the caller contains it as
        a numerical fault), or None."""
        now = time.monotonic()
        if (self._weight_baseline is not None and self.weight_audit_every > 0
                and now >= self._next_weight_audit):
            self._next_weight_audit = now + self.weight_audit_every
            bad = self.audit_weights()
            bad.extend(self.kv_spot_check())
            if bad:
                return f"weight/KV audit mismatch: {bad[:8]}"
        if (self._canary_golden is not None and self.canary_every > 0
                and now >= self._next_canary and not self.has_work):
            self._next_canary = now + self.canary_every
            if not self.run_canary():
                return "canary replay diverged from golden tokens"
        return None

    def integrity_status(self) -> str:
        """``ok`` until an audit or a canary found corruption, then
        ``suspect`` (the heartbeat's ``integrity``)."""
        if self.weight_audit_mismatches or self.canary_failures or self._last_audit_mismatch:
            return "suspect"
        return "ok"

    def abort_all(self, note: str = "aborted") -> None:
        """Drop every running/waiting sequence and release their pages —
        recovery after a failed step."""
        if self._pending:
            last = self._pending[-1]
            if last[3] is not None:
                try:  # wait out in-flight steps; their results are dropped
                    last[3].synchronize()
                except RuntimeError:  # the failed step's own error
                    logger.exception("in-flight step failed during abort")
            self._processed_idx = last[0]
            self._pending.clear()
            self._pending_decodes = 0
        # Swap captures would gather untrusted KV; their sequences go anyway.
        self._pending_swaps.clear()
        self._flush_deferred()
        # The prefix cache must not survive an abort: a failed step leaves
        # the KV content untrusted, and a cached hash would hand it to
        # future requests. The host tier goes with it (its pages were
        # gathered from the same pools; the invalidation demotes nothing).
        self.scheduler.invalidate_prefix_cache()
        if self.prefix_store is not None:
            self.prefix_store.invalidate()
        for seq in list(self.scheduler.running.values()):
            self.scheduler.finish(seq, note)
        self.scheduler.waiting.clear()
        self._dirty = True

    # --- metrics ----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        elapsed = max(1e-9, time.monotonic() - self._started_at)
        s: Dict[str, Any] = self.scheduler.stats()
        s.update(
            prompt_tokens=self.total_prompt_tokens,
            generated_tokens=self.total_generated_tokens,
            decode_steps=self.decode_steps,
            decode_dispatches=self.decode_dispatches,
            prefills=self.prefills,
            prefill_dispatches=self.prefill_dispatches,
            prefill_tokens=self.prefill_tokens,
            tokens_per_sec=self.total_generated_tokens / elapsed,
            decode_kernel=decode_kernel_plan(self._decode_kernel, self.device)[0],
            kv_dtype=str(self.cfg.kv_dtype).replace("torch.", ""),
            device=str(self.device),
            decode_block=self.cfg.decode_block,
            spec_tokens=self.cfg.spec_tokens,
            spec_proposed=self.spec_proposed,
            spec_accepted=self.spec_accepted,
            acceptance_rate=(self.spec_accepted / self.spec_proposed
                             if self.spec_proposed else 0.0),
            mixed_step=self.mixed_step,
            mixed_steps=self.mixed_steps,
            mixed_prefill_tokens=self.mixed_prefill_tokens,
            preempt_mode=self.preempt_mode,
            swap_preempts=self.swap_preempts,
            kv_restores=self.kv_restores,
            snapshots_extracted=self.snapshots_extracted,
            snapshots_inserted=self.snapshots_inserted,
            prefix_demotes=self.prefix_demotes,
            prefix_promotes=self.prefix_promotes,
            prefix_chunks_exported=self.prefix_chunks_exported,
            prefix_chunks_ingested=self.prefix_chunks_ingested,
            # Latency percentiles (ms; None until a histogram has data) and
            # each dispatch kind's recent host spans from its ring.
            ttft_p50_ms=to_ms(self.ttft_hist.percentile(0.50)),
            ttft_p95_ms=to_ms(self.ttft_hist.percentile(0.95)),
            ttft_p99_ms=to_ms(self.ttft_hist.percentile(0.99)),
            itl_p50_ms=to_ms(self.itl_hist.percentile(0.50)),
            itl_p95_ms=to_ms(self.itl_hist.percentile(0.95)),
            itl_p99_ms=to_ms(self.itl_hist.percentile(0.99)),
            dispatch_ms={
                kind: {"recent_avg": round(sum(ring) / len(ring) * 1000.0, 3),
                       "count": self._dispatch_hists[kind].total}
                for kind, ring in list(self._dispatch_rings.items()) if ring
            },
            # Decode-type dispatches as CUDA graphs: None when eager.
            cuda_graphs=None if self._graphs is None else dict(
                graphs=len(self._graphs), captures=self._graphs.captures,
                replays=self._graphs.replays, warmup_steps=self._graphs.warmup_steps,
                graph_iterations=self._graphs.iterations(), capture_s=self._graphs.capture_s,
            ),
        )
        if self._spec:
            s["verify_kernel"] = verify_kernel_plan(self.device)[0]
        if self.mixed_step == "on":
            s["mixed_kernel"] = mixed_kernel_plan(self.device)[0]
        if self.prefix_store is not None:
            s.update(self.prefix_store.stats())
        # Superset-only keys, as in JAX (:4805-4839): the priority plane
        # once an interactive request arrived, the counters once moved.
        if self._priority_enabled:
            s["priority_preemptions"] = self.priority_preemptions
            s["interactive_decode_block"] = self.interactive_decode_block
            s["ttft_p50_ms_interactive"] = to_ms(self.ttft_hist_interactive.percentile(0.50))
            s["ttft_p95_ms_interactive"] = to_ms(self.ttft_hist_interactive.percentile(0.95))
            s["itl_p50_ms_interactive"] = to_ms(self.itl_hist_interactive.percentile(0.50))
            s["itl_p95_ms_interactive"] = to_ms(self.itl_hist_interactive.percentile(0.95))
            s["tokens_interactive"] = self.class_tokens["interactive"]
            s["tokens_batch"] = self.class_tokens["batch"]
            s["finished_interactive"] = self.class_finished["interactive"]
            s["finished_batch"] = self.class_finished["batch"]
        if self.cancellations:
            s["cancellations"] = self.cancellations
        if self.prefill_done:
            s["prefill_done"] = self.prefill_done
        if self.deadline_expirations:
            s["deadline_expirations"] = self.deadline_expirations
        if self.swap_refused:
            s["swap_refused"] = self.swap_refused
        # The fault planes, superset-only (JAX :4840-4876): the watchdog's
        # keys with the watchdog on, the OOM ladder's after a fault, each
        # integrity block once its knob is on or its counter moved.
        if self.watchdog is not None:
            s["watchdog_trips"] = self.watchdog.trips
            s["last_dispatch_ok_age_s"] = round(self.watchdog.last_ok_age_s(), 3)
            wedged = self.watchdog.wedged_kind()
            if wedged is not None:  # in flight and past its deadline now
                s["wedged_dispatch"] = wedged
        if self.hbm_oom_events:
            s["hbm_oom_events"] = self.hbm_oom_events
            s["oom_degradations"] = list(self._oom_ladder_log)
        if self.guard_trips:
            s["guard_trips"] = self.guard_trips
        if self.weight_audits:
            s["weight_audits"] = self.weight_audits
            s["weight_audit_mismatches"] = self.weight_audit_mismatches
            s["kv_spot_checks"] = self.kv_spot_checks
            if self._last_audit_mismatch:
                s["last_audit_mismatch"] = list(self._last_audit_mismatch)
        if self.canary_runs:
            s["canary_runs"] = self.canary_runs
            s["canary_failures"] = self.canary_failures
        if self._guard or self.weight_audit_every > 0 or self.canary_every > 0:
            s["integrity"] = self.integrity_status()
        gov = get_governor()
        if gov.enabled:
            s["host_mem"] = gov.stats()
        return s

    def close(self) -> None:
        """Take this engine's gauges out of the process's host-memory
        governor, which would otherwise keep the engine (and its pools)
        alive."""
        gov = get_governor()
        for name in self._gov_names:
            gov.unregister(name)
        self._gov_names = []


@dataclasses.dataclass
class HandoffOutput:
    """What :meth:`AsyncEngine.handoff` resolves an in-flight request with
    instead of a :class:`RequestOutput` (JAX :4884): its snapshot (None
    when it never entered the engine: nothing to carry) and the count of
    tokens already generated (the resume offset for result dedup)."""

    rid: str
    snapshot: Optional[RequestSnapshot]
    emitted: int = 0


def _hard_exit_wedged(reason: str) -> None:
    logger.critical("engine rebuild after %s exceeded %.0fs: the process is wedged beyond "
                    "in-process recovery; hard-exiting for the janitor's reclaim", reason,
                    REBUILD_HARD_EXIT_S)
    os._exit(86)


class AsyncEngine:
    """Async facade: the step loop on a dedicated thread, asyncio-awaitable
    results. All device work happens on the engine thread.

    Fault containment (JAX :4928-4951), wired by the worker:
    ``rebuild_core()`` returns a fresh ``EngineCore`` (``core_factory``,
    set by ``cli/worker.py::build_engine``, makes one: ``num_pages`` pins
    the pool to the first core's), and ``on_device_fault(reason)`` is the
    worker's breaker notification, called on the engine thread."""

    def __init__(self, core: EngineCore) -> None:
        self.core = core
        self.core_factory: Optional[Any] = None  # (num_pages) -> EngineCore
        self.load_checksums: Optional[Dict[str, str]] = None  # a checkpoint's load ledger
        self.rebuild_core: Optional[Any] = None
        self.on_device_fault: Optional[Any] = None
        self.engine_rebuilds = 0
        self.last_fault_reason: Optional[str] = None
        # The last rebuild's seconds: extract, free, build, reinsert.
        self.last_rebuild: Optional[Dict[str, float]] = None
        # Trips of the watchdogs of cores rebuilt away (stats never go back).
        self._prior_watchdog_trips = 0
        # Blame for numerical faults, rid -> trips: a first trip blames the
        # device (rebuild, re-run), a second convicts the request as poison.
        # Entries go on a clean finish or the verdict.
        self._numerical_probation: Dict[str, int] = {}
        # rid -> [(event, t_mono, fields)] recorded by the recovery; the
        # worker moves them onto the request's trace.
        self._fault_events: Dict[str, List[Tuple[str, float, Dict[str, Any]]]] = {}
        self._fault_lock = threading.Lock()
        # (rid, prompt, messages, prompt_ids, params, snapshot, deadline_at,
        #  prefill_only, priority)
        self._intake: "queue.Queue[tuple]" = queue.Queue()
        # Closures marshalled onto the engine thread, with their futures.
        self._calls: "queue.Queue[Tuple[Any, Future]]" = queue.Queue()
        self._futures: Dict[str, Future] = {}
        self._wake = threading.Event()
        self._stop = False
        self._draining = False
        self._handoff_requested = False
        self._handoff_event: Optional[threading.Event] = None
        self._handoff_results: List[HandoffOutput] = []
        # rid -> cb(token, n_out), fired on the engine thread per surviving token.
        self._token_cbs: Dict[str, Any] = {}
        core.on_token = self._dispatch_token
        # A device fault the engine could not contain (its rebuild failed or
        # none is wired): the port's worker stops on it (ROADMAP.md queue 3).
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="llmq-torch-engine", daemon=True)
        self._thread.start()

    async def generate(
        self,
        *,
        rid: str,
        prompt: Optional[str] = None,
        messages: Optional[List[Dict[str, str]]] = None,
        prompt_ids: Optional[List[int]] = None,
        params: Optional[SamplingParams] = None,
        deadline_at: Optional[float] = None,
        prefill_only: bool = False,
        priority: str = "batch",
    ) -> RequestOutput:
        fut = self._submit(rid, prompt, messages, prompt_ids, params, None, deadline_at,
                           prefill_only, priority)
        return await self._await(fut)

    async def resume(self, *, rid: str, snapshot: RequestSnapshot,
                     deadline_at: Optional[float] = None) -> RequestOutput:
        """Continue a request from a :class:`RequestSnapshot` (a peer's
        drain-with-handoff). Completes as :meth:`generate` does, or with a
        :class:`HandoffOutput` if this engine drains in turn."""
        fut = self._submit(rid, snapshot=snapshot, deadline_at=deadline_at)
        return await self._await(fut)

    def generate_sync(self, *, rid: str, timeout: Optional[float] = None, **kwargs) -> RequestOutput:
        return self._submit(rid, **kwargs).result(timeout=timeout)

    @staticmethod
    async def _await(fut: Future) -> Any:
        """Await a request without cancelling it: a caller that gives up
        (a job timeout) leaves the request to finish in the engine, as the
        JAX engine's does, and a retry of the same id joins it."""
        inner = asyncio.wrap_future(fut)
        inner.add_done_callback(lambda f: f.cancelled() or f.exception())  # retrieved
        return await asyncio.shield(inner)

    def _submit(self, rid: str, prompt: Optional[str] = None,
                messages: Optional[List[Dict[str, str]]] = None,
                prompt_ids: Optional[List[int]] = None,
                params: Optional[SamplingParams] = None,
                snapshot: Optional[RequestSnapshot] = None,
                deadline_at: Optional[float] = None, prefill_only: bool = False,
                priority: str = "batch") -> Future:
        if self._draining:
            raise RuntimeError("engine is draining for handoff")
        fut = self._futures.get(rid)
        if fut is not None and not fut.done():
            # A second request of an id the engine still holds (a worker's
            # redelivered or retried job) joins the first. The JAX engine
            # adds a second row of the id: the scheduler's id-keyed running
            # map then keeps one of the two, and the other, left out of
            # every step, holds its slot and pages for good (ROADMAP.md
            # queue 3 item 12).
            return fut
        fut = Future()
        self._futures[rid] = fut
        self._intake.put((rid, prompt, messages, prompt_ids, params, snapshot, deadline_at,
                          prefill_only, priority))
        self._wake.set()
        return fut

    def handoff(self, timeout: float = 120.0) -> List[HandoffOutput]:
        """Drain-with-handoff (thread-safe; JAX :5044): let the in-flight
        dispatches land, extract every unfinished request as a snapshot
        and resolve its future with a :class:`HandoffOutput`. New
        ``generate`` / ``resume`` calls fail from now on. Returns the
        handoffs; requests that finish during the drain resolve with
        their :class:`RequestOutput` and are not among them."""
        self._draining = True
        if not self._thread.is_alive():
            return []
        self._handoff_results = []
        self._handoff_event = threading.Event()
        self._handoff_requested = True
        self._wake.set()
        if not self._handoff_event.wait(timeout=timeout):
            logger.warning("engine handoff timed out after %.1fs", timeout)
        return self._handoff_results

    def stats(self) -> Dict[str, Any]:
        s = self.core.stats()
        if self._prior_watchdog_trips and "watchdog_trips" in s:
            # A worker-lifetime count: the faulted cores' watchdogs died.
            s["watchdog_trips"] += self._prior_watchdog_trips
        return s

    @property
    def watchdog_trips(self) -> int:
        """Watchdog trips across engine rebuilds."""
        wd = getattr(self.core, "watchdog", None)
        return self._prior_watchdog_trips + (wd.trips if wd else 0)

    # --- streaming / cancellation ----------------------------------------
    def _dispatch_token(self, seq: Sequence, token: int) -> None:
        """``EngineCore.on_token`` bridge (engine thread): a surviving token
        to its request's callback, if any. Callback errors are logged, not
        raised: a broken consumer must not stop the step loop."""
        cb = self._token_cbs.get(seq.rid)
        if cb is None:
            return
        try:
            cb(token, len(seq.output_ids))
        except Exception:  # noqa: BLE001 — the consumer's fault, not the engine's
            logger.exception("token callback for %s failed", seq.rid)

    def set_token_callback(self, rid: str, cb: Any) -> None:
        """Register ``cb(token, n_out)`` for one request's tokens: fired on
        the engine thread for each token that survives the stop check,
        ``n_out`` the output length including it (its 1-based index).
        Register before ``generate`` to see every token."""
        self._token_cbs[rid] = cb

    def clear_token_callback(self, rid: str) -> None:
        self._token_cbs.pop(rid, None)

    def cancel(self, rid: str) -> None:
        """Cancel one in-flight request (thread-safe, non-blocking): it
        finishes with finish_reason='cancelled' through the normal path."""
        if self._thread.is_alive():
            self._calls.put((lambda: self.core.cancel_request(rid), Future()))
            self._wake.set()

    def call_on_engine(self, fn, timeout: float = 30.0):
        """Run ``fn()`` on the engine thread and return its result: what
        touches the pools or the scheduler from another thread goes
        through here (JAX :5115)."""
        if not self._thread.is_alive():
            return fn()
        fut: Future = Future()
        self._calls.put((fn, fut))
        self._wake.set()
        return fut.result(timeout=timeout)

    def export_prefix_chunks(self, digests_hex: List[str]) -> List[str]:
        """Thread-safe :meth:`EngineCore.export_prefix_chunks`."""
        return self.call_on_engine(lambda: self.core.export_prefix_chunks(digests_hex))

    def ingest_prefix_chunks(self, chunks_b64: List[str]) -> int:
        """Thread-safe :meth:`EngineCore.ingest_prefix_chunks`."""
        return self.call_on_engine(lambda: self.core.ingest_prefix_chunks(chunks_b64))

    def missing_prefix_digests(self, digests_hex: List[str]) -> List[str]:
        """Thread-safe want-list; [] on any failure (a fetch treats
        "nothing missing" as "nothing to fetch")."""
        try:
            return self.call_on_engine(lambda: self.core.missing_prefix_digests(digests_hex),
                                       timeout=5.0)
        except Exception:  # noqa: BLE001
            return []

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=30)
        self.core.close()

    # --- fault recovery -----------------------------------------------------
    def pop_fault_events(self, rid: str) -> List[Tuple[str, float, Dict[str, Any]]]:
        """Take (and clear) one request's fault-recovery events:
        ``(name, t_mono, fields)``, which the worker puts on its trace."""
        with self._fault_lock:
            return self._fault_events.pop(rid, [])

    def _record_fault_event(self, rids: List[str], name: str, **fields: Any) -> None:
        t = time.monotonic()
        with self._fault_lock:
            for rid in rids:
                self._fault_events.setdefault(rid, []).append((name, t, dict(fields)))

    def _affected(self, reason: str) -> List[str]:
        """The requests in flight at a fault, with its event recorded."""
        affected = [rid for rid, fut in list(self._futures.items()) if not fut.done()]
        self._record_fault_event(affected, "device_fault", reason=reason)
        for rid in affected:
            emit_trace_event(rid, "device_fault", reason=reason)
        return affected

    def _reinsert(self, core: EngineCore, snaps, lost, drop=frozenset()) -> Tuple[int, int]:
        """Snapshots back into ``core`` one by one; the lost (and each that
        fails to insert) resolve with a snapshot-less HandoffOutput, which
        the worker requeues whole. Returns (restored, requeued)."""
        lost_set = set(lost) - drop
        restored = 0
        for snap, deadline_at in snaps:
            if snap.rid in drop:
                continue
            try:
                core.insert_request(snap, deadline_at=deadline_at)
                restored += 1
            except Exception:  # noqa: BLE001 — per-row isolation
                logger.exception("fault recovery: re-insert of %s failed; requeueing", snap.rid)
                lost_set.add(snap.rid)
        for rid in lost_set:
            self._resolve(rid, HandoffOutput(rid=rid, snapshot=None, emitted=0))
        return restored, len(lost_set)

    def _degrade_and_restore(self, exc: Exception) -> bool:
        """Absorb one OOM on the same engine (JAX :5183): one rung of the
        ladder, then every in-flight request restored from its host
        snapshot (the faulted dispatch's outputs are lost, and restoring
        recomputes them: greedy tokens stay identical). False when the
        ladder is dry or the restore faults: the caller rebuilds."""
        rung = None
        try:
            rung = self.core.degrade_for_oom()
        except Exception:  # noqa: BLE001 — the ladder is best-effort
            logger.exception("hbm_oom degradation failed")
        if rung is None:
            return False
        affected = self._affected(FAULT_OOM)
        try:
            snaps, lost = self.core.extract_for_rebuild(reuse_pool=True)
        except Exception:  # noqa: BLE001 — on to the rebuild
            logger.exception("hbm_oom restore: extraction failed; rebuilding instead")
            return False
        restored, requeued = self._reinsert(self.core, snaps, lost)
        self._record_fault_event(affected, "oom_degraded", rung=rung, restored=restored,
                                 requeued=requeued)
        logger.warning("hbm_oom (%s) absorbed by the degradation ladder (%s): %d request(s) "
                       "restored in place, %d requeued", exc, rung, restored, requeued)
        return True

    def _recover_numerical(self, exc: Exception) -> bool:
        """Blame-attributed recovery of a numerical fault (a guard trip, a
        failed audit or canary; JAX :5248): the suspects' first trip blames
        the device, so the core is rebuilt (weights made anew from their
        source) and they re-run from their snapshots; a suspect that trips
        again is poison and fails with ``DeviceFaultError`` (the worker
        quarantines it as ``numerical_fault``). False without a rebuild
        path."""
        if self.rebuild_core is None:
            return False
        suspects = tuple(getattr(exc, "suspects", ()) or ())
        poison = [r for r in suspects if r in self._numerical_probation]
        for rid in suspects:
            self._numerical_probation.setdefault(rid, 1)
        if poison:
            logger.error("numerical fault re-tripped by %s: poison job(s); quarantining "
                         "instead of rebuilding again", poison)
        if not self._rebuild_after_fault(FAULT_NUMERICAL, exc, drop=frozenset(poison)):
            return False
        failure = DeviceFaultError(
            FAULT_NUMERICAL, f"request re-tripped the numerics guard after a rebuild: {exc}")
        for rid in poison:
            self._numerical_probation.pop(rid, None)
            self._record_fault_event([rid], "poison_numerical")
            emit_trace_event(rid, "poison_numerical")
            fut = self._futures.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_exception(failure)
        # The rebuilt core checks its own fresh baselines before it takes
        # traffic: a chip still corrupting fails here, not on user requests.
        try:
            if self.core._weight_baseline is not None:
                self.core.audit_weights()
            if self.core._canary_golden is not None:
                self.core.run_canary()
        except Exception:  # noqa: BLE001 — re-verification is best-effort
            logger.exception("post-rebuild integrity re-verify failed")
        return True

    def _rebuild_after_fault(self, reason: str, exc: Exception,
                             drop: frozenset = frozenset()) -> bool:
        """Contain a classified device fault by rebuilding the engine in
        process (JAX :5302), on the engine thread. The order keeps one
        full-size engine on the card at a time: snapshot every in-flight
        request to the host, free the old engine (graphs, pools, weights,
        cached blocks), then build the new one (same ``num_pages``) and
        re-insert the snapshots. ``drop`` names requests whose fate is
        decided (the poison verdicts). A recovery that hangs trips the
        hard-exit backstop. False when no rebuild is wired or it failed."""
        logger.error("device fault (%s): %s; attempting an in-process engine rebuild", reason,
                     exc)
        self.last_fault_reason = reason
        if self.on_device_fault is not None:
            try:
                self.on_device_fault(reason)
            except Exception:  # noqa: BLE001 — an observer must not block us
                logger.exception("on_device_fault callback failed")
        affected = self._affected(reason)
        timer = threading.Timer(REBUILD_HARD_EXIT_S, _hard_exit_wedged, args=(reason,))
        timer.daemon = True
        timer.start()
        try:
            old = self.core
            t0 = time.monotonic()
            try:
                snaps, lost = old.extract_for_rebuild()
            except Exception:  # noqa: BLE001 — extraction is best-effort
                logger.exception("fault recovery: extraction failed outright; every "
                                 "in-flight request will requeue")
                snaps, lost = [], list(affected)
            t1 = time.monotonic()
            # The failed call's frames may hold the pools (a kernel's
            # arguments): drop their locals, or the frees below free nothing.
            traceback.clear_frames(exc.__traceback__)
            wd = old.watchdog
            if wd is not None:
                self._prior_watchdog_trips += wd.trips
            try:
                old.release()
            except Exception:  # noqa: BLE001 — a faulted device may refuse the frees
                logger.exception("fault recovery: freeing the faulted engine failed")
            t2 = time.monotonic()
            try:
                new_core = self.rebuild_core()
                if new_core.device.type == "cuda":  # the build's device work, timed too
                    torch.cuda.synchronize(new_core.device)
            except Exception:  # noqa: BLE001 — on to the batch abort
                logger.exception("fault recovery: rebuild failed; aborting the batch")
                return False
            t3 = time.monotonic()
            self.core = new_core
            new_core.on_token = self._dispatch_token  # streams survive the rebuild
            self.engine_rebuilds += 1
            restored, requeued = self._reinsert(new_core, snaps, lost, drop)
            self.last_rebuild = dict(extract_s=t1 - t0, free_s=t2 - t1, build_s=t3 - t2,
                                     reinsert_s=time.monotonic() - t3)
            self._record_fault_event(affected, "engine_rebuilt", restored=restored,
                                     requeued=requeued)
            for rid in affected:
                emit_trace_event(rid, "engine_rebuilt")
            logger.warning("engine rebuilt in-process after %s: %d request(s) restored, %d "
                           "requeued", reason, restored, requeued)
            return True
        finally:
            timer.cancel()

    # --- engine thread ----------------------------------------------------
    def _resolve(self, rid: str, value: Any) -> None:
        fut = self._futures.pop(rid, None)
        if fut is not None and not fut.done():
            fut.set_result(value)

    def _fail_all(self, exc: BaseException) -> None:
        for rid, fut in list(self._futures.items()):
            self._futures.pop(rid, None)
            if not fut.done():
                fut.set_exception(exc)

    def _run_handoff(self) -> None:
        """Drain, extract, resolve (JAX :5411-5458). Outputs that finish in
        the drain resolve normally, the unfinished with a HandoffOutput
        carrying their snapshot, intake stragglers with a snapshot-less
        one (the worker requeues those whole)."""
        self._handoff_requested = False
        results: List[HandoffOutput] = []
        try:
            outs: List[RequestOutput] = []
            snaps = self.core.extract_all(finished=outs)
            for out in outs:
                self._resolve(out.rid, out)
            for snap in snaps:
                results.append(HandoffOutput(snap.rid, snap, len(snap.output_ids)))
            while True:
                try:
                    item = self._intake.get_nowait()
                except queue.Empty:
                    break
                results.append(HandoffOutput(item[0], None, 0))
            for ho in results:
                self._resolve(ho.rid, ho)
        except Exception:  # noqa: BLE001 — a handoff must never wedge shutdown
            logger.exception("engine handoff failed; aborting the batch")
            self.core.abort_all("handoff_failed")
            self._fail_all(RuntimeError("engine handoff failed"))
        finally:
            self._handoff_results = results
            if self._handoff_event is not None:
                self._handoff_event.set()

    def _run(self) -> None:
        while not self._stop:
            if self._handoff_requested:
                self._run_handoff()
            while True:
                try:
                    fn, call_fut = self._calls.get_nowait()
                except queue.Empty:
                    break
                try:
                    call_fut.set_result(fn())
                except Exception as exc:  # noqa: BLE001 — the caller's error
                    call_fut.set_exception(exc)
            added = False
            while True:
                try:
                    (rid, prompt, messages, prompt_ids, params, snapshot, deadline_at,
                     prefill_only, priority) = self._intake.get_nowait()
                except queue.Empty:
                    break
                try:
                    if snapshot is not None:
                        self.core.insert_request(snapshot, deadline_at=deadline_at)
                    else:
                        self.core.add_request(
                            rid, prompt=prompt, messages=messages, prompt_ids=prompt_ids,
                            params=params, deadline_at=deadline_at, prefill_only=prefill_only,
                            priority=priority,
                        )
                    added = True
                except Exception as exc:  # noqa: BLE001 — invalid request
                    fut = self._futures.pop(rid, None)
                    if fut is not None and not fut.done():
                        fut.set_exception(exc)
            if not self.core.has_work and not added:
                # The idle sweep (audit, spot check, canary on their
                # cadences; nothing at the defaults): evidence of corruption
                # takes the numerical containment a guard trip takes.
                try:
                    suspicion = self.core.maybe_idle_integrity()
                except Exception as idle_exc:  # noqa: BLE001 — the replay tripped
                    suspicion = f"canary replay raised: {idle_exc}"
                if suspicion is not None and not self._recover_numerical(
                        DeviceFaultError(FAULT_NUMERICAL, suspicion)):
                    logger.error("numerical fault with no rebuild path: %s", suspicion)
                self._wake.wait(timeout=0.02)
                self._wake.clear()
                continue
            try:
                for out in self.core.step():
                    self._numerical_probation.pop(out.rid, None)
                    self._resolve(out.rid, out)
            except Exception as exc:  # noqa: BLE001 — keep the loop alive
                self._contain(exc)
        try:  # catch the host up so deferred pages release
            self.core._drain([])
        except Exception:  # noqa: BLE001 — best-effort cleanup
            logger.exception("drain on shutdown failed")
        self.core.stop_watchdog()

    def _contain(self, exc: Exception) -> None:
        """A failed step (JAX :5530-5560): a classified device fault goes
        down the ladder, the numerical recovery or a rebuild; what none of
        them contains aborts the batch and fails its requests, a device
        fault with ``DeviceFaultError`` (its class in the worker's
        headers), anything else with ``RuntimeError``. An uncontained
        device fault sets ``error``: the port's worker stops on it."""
        reason = classify_failure(exc)
        if reason == FAULT_OOM and self._degrade_and_restore(exc):
            return
        if reason == FAULT_NUMERICAL and self._recover_numerical(exc):
            return
        if reason is not None and self.rebuild_core is not None and \
                self._rebuild_after_fault(reason, exc):
            return
        logger.error("engine step failed", exc_info=exc)
        if reason is not None and self.error is None:
            self.error = exc
        failure: Exception = (DeviceFaultError(reason, f"engine step failed: {exc}")
                              if reason is not None else RuntimeError("engine step failed"))
        failure.__cause__ = exc
        try:
            self.core.abort_all("error")
        except Exception:  # noqa: BLE001 — the callers get the failure anyway
            logger.exception("abort after a failed step failed")
        # The queued requests fail too: added next round, they would finish
        # for futures nobody awaits.
        while True:
            try:
                self._intake.get_nowait()
            except queue.Empty:
                break
        self._fail_all(failure)
