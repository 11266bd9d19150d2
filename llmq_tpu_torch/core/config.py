"""Environment-driven configuration of the port's worker.

The port's own copy of ``llmq_tpu/core/config.py`` ``Config``: every
field of the reference, with the same variable, read with the same
precedence (the ``LLMQ_*`` / ``TPU_*`` name first, the reference's
``VLLM_*`` / ``BROKER_URL`` / ``RABBITMQ_URL`` aliases after it, then a
``.env`` file in the working directory, then the default), re-read on
every ``get_config()`` call so tests can monkeypatch the environment.

Each field is in one of two states. Most are read by the modules that
serve them: the broker section by the broker manager and its resilient
session (``broker/manager.py``, ``broker/resilient.py``), the queue and
job policy by ``broker/manager.py``, ``broker/memory.py`` and
``workers/base.py``, the engine section by ``cli/worker.py`` and the
engine. Two of the reference's fields, ``priority_preempt`` and
``interactive_decode_block``, have no field here: the engine reads their
variables itself over its own ``EngineConfig`` fields
(``engine/engine.py::priority_settings``), as the reference's engine
does. ``chunk_size`` is the client's (``cli/submit.py``) and
``serve_port`` the gateway's (``gateway/server.py``): no worker of either
package reads them.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from pydantic import BaseModel, Field


def load_env_file(path: str | os.PathLike = ".env", *, override: bool = False) -> None:
    """Minimal ``.env`` loader: KEY=VALUE lines, ``#`` comments, optional quotes."""
    p = Path(path)
    if not p.is_file():
        return
    for raw in p.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        if line.startswith("export "):
            line = line[len("export "):]
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        if key and (override or key not in os.environ):
            os.environ[key] = value


_ENV_LOADED = False


def _ensure_env_loaded() -> None:
    global _ENV_LOADED
    if not _ENV_LOADED:
        load_env_file()
        _ENV_LOADED = True


def _env(name: str, *aliases: str) -> Optional[str]:
    for key in (name, *aliases):
        value = os.getenv(key)
        if value is not None:
            return value
    return None


def _env_int(name: str, *aliases: str, default: Optional[int] = None) -> Optional[int]:
    value = _env(name, *aliases)
    return int(value) if value not in (None, "") else default


def _env_float(name: str, *aliases: str, default: Optional[float] = None) -> Optional[float]:
    value = _env(name, *aliases)
    return float(value) if value not in (None, "") else default


class Config(BaseModel):
    """Worker configuration snapshot (one env read per instantiation)."""

    # --- broker -----------------------------------------------------------
    broker_url: str = Field(
        default_factory=lambda: _env("LLMQ_BROKER_URL", "BROKER_URL", "RABBITMQ_URL")
        or "tcp://127.0.0.1:5672/",
        description="Broker endpoint: memory:// (in-process), file:///path (durable on-disk), "
        "tcp://host:port/ (the llmq broker daemon), or any of them behind a chaos+ prefix "
        "(seeded fault injection).",
    )
    queue_prefetch: int = Field(
        default_factory=lambda: _env_int("LLMQ_QUEUE_PREFETCH", "VLLM_QUEUE_PREFETCH",
                                         default=100),
        description="Messages prefetched (in flight) per worker consumer.",
    )
    reconnect_base_delay_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_RECONNECT_BASE_S", default=0.5),
        description="First re-dial backoff after a mid-run connection loss (doubles per "
        "attempt, with jitter).",
    )
    reconnect_max_delay_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_RECONNECT_MAX_S", default=30.0),
        description="Backoff ceiling for broker reconnect attempts.",
    )
    outbox_limit: int = Field(
        default_factory=lambda: _env_int("LLMQ_OUTBOX_LIMIT", default=10_000),
        description="Publishes parked during a broker outage before publishers block.",
    )

    # --- engine -----------------------------------------------------------
    hbm_utilization: float = Field(
        default_factory=lambda: _env_float(
            "TPU_HBM_UTILIZATION", "VLLM_GPU_MEMORY_UTILIZATION", default=0.9
        ),
        description="Fraction of device memory the engine may claim for the KV cache.",
    )
    max_num_seqs: Optional[int] = Field(
        default_factory=lambda: _env_int("LLMQ_MAX_NUM_SEQS", "VLLM_MAX_NUM_SEQS"),
        description="Max sequences resident in one continuous-batching step.",
    )
    max_model_len: Optional[int] = Field(
        default_factory=lambda: _env_int("LLMQ_MAX_MODEL_LEN", "VLLM_MAX_MODEL_LEN"),
        description="Context-window cap (prompt + generation).",
    )
    max_tokens: int = Field(
        default_factory=lambda: _env_int("LLMQ_MAX_TOKENS", "VLLM_MAX_TOKENS", default=8192),
        description="Default max new tokens per request (per-job override allowed).",
    )
    prefill_chunk_size: Optional[int] = Field(
        default_factory=lambda: _env_int("LLMQ_PREFILL_CHUNK"),
        description="Chunked prefill: positions per chunk (None = bucketed).",
    )
    kv_dtype: Optional[str] = Field(
        default_factory=lambda: _env("LLMQ_KV_DTYPE", "VLLM_KV_CACHE_DTYPE"),
        description="KV cache storage dtype (fp8 = float8_e5m2).",
    )
    enable_prefix_caching: bool = Field(
        default_factory=lambda: (_env("LLMQ_PREFIX_CACHING") or "").lower()
        in ("1", "true", "yes"),
        description="Reuse cached KV for shared prompt prefixes (needs prefill_chunk_size).",
    )
    prefix_affinity: bool = Field(
        default_factory=lambda: (_env("LLMQ_PREFIX_AFFINITY") or "").lower()
        in ("1", "true", "yes"),
        description="Prefix-affinity routing: workers advertise hot prefix-chain digests in "
        "heartbeats, and the submit path routes a job sharing an advertised prompt prefix to "
        "the per-worker queue <queue>.w.<worker_id> of the worker holding those KV pages (the "
        "shared queue on no fresh match). Workers also serve cross-worker page fetches on "
        "<queue>.kv.<worker_id>.",
    )
    decode_block: int = Field(
        default_factory=lambda: _env_int("LLMQ_DECODE_BLOCK", default=1),
        description="Fused multi-step decode: device iterations per dispatch (1 = off).",
    )
    spec_tokens: int = Field(
        default_factory=lambda: _env_int("LLMQ_SPEC_TOKENS", default=0),
        description="Speculative decoding: draft tokens verified per step (0 = off).",
    )
    tp_overlap: str = Field(
        default_factory=lambda: (_env("LLMQ_TP_OVERLAP") or "off").lower(),
        description="Tensor-parallel collective overlap: on, auto or off.",
    )
    mixed_step: str = Field(
        default_factory=lambda: (_env("LLMQ_MIXED_STEP") or "off").lower(),
        description="Piggyback scheduling of prefill chunks into decode: on or off.",
    )

    # --- disaggregated prefill/decode serving -----------------------------
    worker_role: str = Field(
        default_factory=lambda: (_env("LLMQ_WORKER_ROLE") or "unified").lower(),
        description="Disaggregated serving role. 'unified' (default) runs prefill and decode "
        "on one worker. 'prefill' consumes the shared job queue, runs the prompt phase only "
        "and hands the request off at the phase boundary (an adoption offer to a decode "
        "peer, the snapshot republished to <q>.decode as the fallback). 'decode' consumes "
        "<q>.decode and its private adoption queue <q>.d.<worker_id> and continues the "
        "handed-off requests. 'auto' starts as prefill and switches roles on fleet "
        "queue-depth skew with hysteresis (role_dwell_s / role_switch_*).",
    )
    role_dwell_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_ROLE_DWELL_S", default=60.0),
        description="Auto-role hysteresis: least seconds a worker stays in its role before "
        "the depth-ratio controller may switch it again.",
    )
    role_switch_hi: float = Field(
        default_factory=lambda: _env_float("LLMQ_ROLE_SWITCH_HI", default=2.0),
        description="Auto-role band: a decode worker switches to prefill when (shared depth "
        "+ 1) / (decode depth + 1) exceeds this ratio.",
    )
    role_switch_lo: float = Field(
        default_factory=lambda: _env_float("LLMQ_ROLE_SWITCH_LO", default=0.5),
        description="Auto-role band: a prefill worker switches to decode when (shared depth "
        "+ 1) / (decode depth + 1) falls below this ratio.",
    )
    role_check_interval_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_ROLE_CHECK_INTERVAL_S", default=5.0),
        description="Auto-role controller cadence: seconds between fleet queue-depth polls.",
    )
    handoff_timeout_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_HANDOFF_TIMEOUT_S", default=2.0),
        description="Seconds a prefill worker waits for a decode peer to accept a KV "
        "adoption offer before it republishes the snapshot on <q>.decode.",
    )
    result_digest: bool = Field(
        default_factory=lambda: (_env("LLMQ_RESULT_DIGEST") or "").lower()
        in ("1", "true", "yes", "on"),
        description="Workers attach the emitted token_ids and their blake2b-16 token_digest "
        "to every result. Off by default.",
    )

    # --- priority classes -------------------------------------------------
    priority_classes: bool = Field(
        default_factory=lambda: (_env("LLMQ_PRIORITY_CLASSES") or "1").lower()
        not in ("0", "false", "no", "off"),
        description="SLO priority classes: workers also consume the per-queue fast lane "
        "<q>.interactive, and the engine admits interactive work first. On by default; "
        "LLMQ_PRIORITY_CLASSES=0 forces pure FIFO.",
    )
    serve_port: int = Field(
        default_factory=lambda: _env_int("LLMQ_SERVE_PORT", default=8100),
        description="HTTP port of the streaming gateway (`serve`); no worker reads it.",
    )

    # --- queue/job policy -------------------------------------------------
    job_ttl_minutes: int = Field(
        default_factory=lambda: _env_int("LLMQ_JOB_TTL_MINUTES", default=30),
        description="Job time-to-live; expired jobs are dropped by the broker.",
    )
    max_redeliveries: int = Field(
        default_factory=lambda: _env_int("LLMQ_MAX_REDELIVERIES", default=3),
        description="Redeliveries before a job is dead-lettered to <q>.failed.",
    )
    redelivery_backoff_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_REDELIVERY_BACKOFF_S", default=0.0),
        description="Base delay before a rejected job is redelivered; doubles per attempt. "
        "0 redelivers immediately.",
    )
    redelivery_backoff_max_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_REDELIVERY_BACKOFF_MAX_S", default=30.0),
        description="Ceiling on the exponential redelivery backoff.",
    )
    deadline_ms: int = Field(
        default_factory=lambda: _env_int("LLMQ_DEADLINE_MS", default=0),
        description="Default per-job completion deadline (ms from submit); the submit path "
        "sheds early when depth / observed rate cannot meet it. 0 disables.",
    )

    # --- resilience -------------------------------------------------------
    host_mem_gb: float = Field(
        default_factory=lambda: _env_float("LLMQ_HOST_MEM_GB", default=0.0),
        description="Shared host-RAM byte budget (GiB) of the prefix host tier, "
        "swap-preempt captures and resume blobs (utils/host_mem.HostMemoryGovernor); "
        "0 disables it.",
    )
    quarantine_attempts: int = Field(
        default_factory=lambda: _env_int("LLMQ_QUARANTINE_ATTEMPTS", default=0),
        description="Fleet-wide attempts before a job that keeps failing is quarantined to "
        "<q>.quarantine. 0 disables quarantine.",
    )
    peer_serve_concurrency: int = Field(
        default_factory=lambda: _env_int("LLMQ_PEER_SERVE_CONCURRENCY", default=2),
        description="Concurrent KV-ship fetch requests a worker serves to one peer before it "
        "replies busy (the requester recomputes at once instead of waiting out its timeout).",
    )
    breaker_failures: int = Field(
        default_factory=lambda: _env_int("LLMQ_BREAKER_FAILURES", default=0),
        description="Consecutive engine failures before a worker trips its circuit breaker "
        "and self-drains through the handoff path. 0 disables.",
    )
    job_timeout_s: Optional[float] = Field(
        default_factory=lambda: _env_float("LLMQ_JOB_TIMEOUT_S"),
        description="Per-job processing timeout: a job past it is cancelled and "
        "reject-requeued. None disables.",
    )
    drain_timeout_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_DRAIN_TIMEOUT_S", default=30.0),
        description="Seconds a shutting-down worker waits for its in-flight jobs to settle "
        "after handing them off.",
    )
    chunk_size: int = Field(
        default_factory=lambda: _env_int("LLMQ_CHUNK_SIZE", default=10000),
        description="Jobs submitted per publish chunk (the client's submit; no worker "
        "reads it).",
    )
    log_level: str = Field(
        default_factory=lambda: _env("LLMQ_LOG_LEVEL") or "INFO",
        description="Logging level.",
    )

    @property
    def job_ttl_ms(self) -> int:
        return self.job_ttl_minutes * 60 * 1000


def get_config() -> Config:
    """A fresh config (the environment is re-read on each call; a ``.env``
    file in the working directory is loaded once, under the environment)."""
    _ensure_env_loaded()
    return Config()
