"""Environment-driven configuration of the port's worker.

The port's own copy of the broker and engine sections of
``llmq_tpu/core/config.py`` ``Config`` (:76-195): the same variables,
read with the same precedence (the ``LLMQ_*`` / ``TPU_*`` name first, the
reference's ``VLLM_*`` / ``BROKER_URL`` / ``RABBITMQ_URL`` aliases after
it), re-read on every ``get_config()`` call so tests can monkeypatch the
environment. Of the broker section it keeps what the worker reads
(``broker_url``, ``queue_prefetch``; ``max_tokens`` of the engine
section), and of the resilience section the shared host-memory budget
(``host_mem_gb``, ``utils/host_mem.py``) and the drain timeout
(``drain_timeout_s``, the worker's drain-with-handoff) and the result
digest (``result_digest``: the emitted token ids on each result), of the
disaggregation section the worker's role (``worker_role``), and of the
priority section the switch of the ``<q>.interactive`` fast lane
(``priority_classes``). The reconnect and outbox settings of the resilient
session, the prefix-affinity section and the ``auto`` role's controller
settings come with the modules that read them (ROADMAP.md queue 1, M6),
as does the ``.env`` autoload.
"""

from __future__ import annotations

import os
from typing import Optional

from pydantic import BaseModel, Field


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
        description="Broker endpoint: memory:// (in-process) or tcp://host:port/ (the llmq "
        "broker daemon).",
    )
    queue_prefetch: int = Field(
        default_factory=lambda: _env_int("LLMQ_QUEUE_PREFETCH", "VLLM_QUEUE_PREFETCH",
                                         default=100),
        description="Messages prefetched (in flight) per worker consumer.",
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
        "and republishes each job with its prompt-KV snapshot to <q>.decode. 'decode' "
        "consumes <q>.decode and continues the handed-off requests. 'auto' switches between "
        "the two on fleet queue depths (the reference's; not ported yet, ROADMAP.md M6).",
    )

    # --- priority classes -------------------------------------------------
    priority_classes: bool = Field(
        default_factory=lambda: (_env("LLMQ_PRIORITY_CLASSES") or "1").lower()
        not in ("0", "false", "no", "off"),
        description="SLO priority classes: workers also consume the per-queue fast lane "
        "<q>.interactive, and the engine admits interactive work first. On by default; "
        "LLMQ_PRIORITY_CLASSES=0 forces pure FIFO.",
    )

    # --- resilience -------------------------------------------------------
    host_mem_gb: float = Field(
        default_factory=lambda: _env_float("LLMQ_HOST_MEM_GB", default=0.0),
        description="Shared host-RAM byte budget (GiB) of the prefix host tier, "
        "swap-preempt captures and resume blobs (utils/host_mem.HostMemoryGovernor); "
        "0 disables it.",
    )
    drain_timeout_s: float = Field(
        default_factory=lambda: _env_float("LLMQ_DRAIN_TIMEOUT_S", default=30.0),
        description="Seconds a shutting-down worker waits for its in-flight jobs to settle "
        "after handing them off.",
    )
    result_digest: bool = Field(
        default_factory=lambda: (_env("LLMQ_RESULT_DIGEST") or "").lower()
        in ("1", "true", "yes", "on"),
        description="Workers attach the emitted token_ids and their blake2b-16 token_digest "
        "to every result. Off by default.",
    )


def get_config() -> Config:
    """A fresh config (the environment is re-read on each call)."""
    return Config()
