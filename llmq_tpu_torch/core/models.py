"""Job / Result / stats schemas (copy of ``llmq_tpu/core/models.py``).

Same wire contract, so job files and result consumers of the JAX
package work unchanged: ``Job`` requires exactly one of ``prompt`` /
``messages`` and passes its extra fields through to the ``Result``;
``Result`` carries id/prompt/result/worker_id/duration_ms/timestamp plus
``usage`` token accounting and the passthrough extras.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from pydantic import BaseModel, ConfigDict, Field, model_validator

from llmq_tpu_torch.utils import clock

_RESERVED_JOB_FIELDS = {
    "id",
    "prompt",
    "messages",
    "chat_mode",
    "stop",
    "sampling",
    "deadline_ms",
    "deadline_at",
}

# SLO classes a job may declare via the ``priority`` passthrough extra.
JOB_PRIORITIES = ("interactive", "batch")


def utcnow() -> datetime:
    """Current UTC time through the injectable clock."""
    return datetime.fromtimestamp(clock.wall(), tz=timezone.utc)


class SamplingOptions(BaseModel):
    """Per-request sampling configuration (engine-level contract)."""

    temperature: float = Field(default=0.7, ge=0.0)
    top_p: float = Field(default=1.0, gt=0.0, le=1.0)
    top_k: int = Field(default=0, ge=0, description="0 disables top-k")
    max_tokens: Optional[int] = Field(default=None, ge=1)
    min_tokens: int = Field(default=0, ge=0)
    seed: Optional[int] = None
    stop: Optional[List[str]] = None

    model_config = ConfigDict(extra="forbid")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


class Job(BaseModel):
    """A unit of work: one prompt (or chat) to run through a model."""

    id: str = Field(..., description="Unique job identifier")
    prompt: Optional[str] = Field(
        None, description="Prompt template; ``{var}`` placeholders resolve from extras"
    )
    messages: Optional[List[Dict[str, Any]]] = Field(
        None, description="Chat messages for chat-template models"
    )
    chat_mode: bool = Field(default=False, description="Force chat-template application")
    stop: Optional[List[str]] = Field(None, description="Stop sequences; None = EOS only")
    sampling: Optional[SamplingOptions] = Field(None, description="Per-job sampling overrides")
    deadline_ms: Optional[int] = Field(
        None, ge=1, description="Completion-deadline budget (ms from submit)."
    )
    deadline_at: Optional[float] = Field(
        None, description="Absolute deadline (epoch seconds), stamped at submit."
    )

    model_config = ConfigDict(extra="allow")

    @model_validator(mode="after")
    def _prompt_xor_messages(self) -> "Job":
        if self.prompt is not None and self.messages is not None:
            raise ValueError(
                "Cannot specify both 'prompt' and 'messages'. Use one or the other."
            )
        if self.prompt is None and self.messages is None:
            raise ValueError("Must specify either 'prompt' or 'messages'.")
        priority = (self.__pydantic_extra__ or {}).get("priority")
        if priority is not None and priority not in JOB_PRIORITIES:
            raise ValueError(f"priority must be one of {JOB_PRIORITIES}, got {priority!r}")
        return self

    @property
    def priority_class(self) -> str:
        """Effective SLO class: the ``priority`` extra, default ``batch``."""
        return (self.__pydantic_extra__ or {}).get("priority") or "batch"

    def extras(self) -> Dict[str, Any]:
        """Extra (non-schema) fields — template variables / passthrough data."""
        return {k: v for k, v in self.model_dump().items() if k not in _RESERVED_JOB_FIELDS}

    def get_formatted_prompt(self) -> str:
        """Resolve ``{var}`` placeholders in ``prompt`` from the job's extras."""
        if self.prompt is None:
            raise ValueError("Cannot format prompt: prompt is None")
        from llmq_tpu_torch.core.template import resolve_template_string

        return resolve_template_string(self.prompt, self.extras())


class Result(BaseModel):
    """Outcome of one job; extra fields from the job are passed through."""

    id: str = Field(..., description="Job ID this result corresponds to")
    prompt: str = Field(..., description="The formatted prompt that was processed")
    result: str = Field(..., description="Generated text")
    worker_id: str = Field(..., description="Worker that processed this job")
    duration_ms: float = Field(..., description="Processing duration (ms)")
    timestamp: datetime = Field(default_factory=utcnow)
    usage: Optional[Dict[str, int]] = Field(
        None, description="Token accounting: prompt_tokens/completion_tokens"
    )
    token_ids: Optional[List[int]] = Field(None, description="Emitted token ids (opt-in)")
    token_digest: Optional[str] = Field(None, description="Digest over token_ids (opt-in)")

    model_config = ConfigDict(extra="allow")

    def verify_token_digest(self) -> Optional[bool]:
        """Recompute the payload digest: None when the producing worker
        attached none, else whether it matches the token ids."""
        if self.token_digest is None or self.token_ids is None:
            return None
        from llmq_tpu_torch.utils.hashing import token_fold

        return token_fold(self.token_ids) == self.token_digest


class QueueStats(BaseModel):
    """Depth/consumer snapshot of one queue."""

    queue_name: str
    message_count: Optional[int] = None
    message_count_ready: Optional[int] = None
    message_count_unacknowledged: Optional[int] = None
    consumer_count: Optional[int] = None
    message_bytes: Optional[int] = None
    message_bytes_ready: Optional[int] = None
    message_bytes_unacknowledged: Optional[int] = None
    processing_rate: Optional[float] = None
    stats_source: str = "unknown"


class WorkerHealth(BaseModel):
    """Worker heartbeat record, published to ``<queue>.health``."""

    worker_id: str
    status: str
    last_seen: datetime
    jobs_processed: int
    avg_duration_ms: Optional[float] = None
    queue: Optional[str] = None
    engine_stats: Optional[Dict[str, Any]] = None
    reconnects: Optional[int] = Field(
        None, description="Broker session reconnects survived (ResilientBroker session stats).")
    metrics: Optional[Dict[str, Any]] = Field(
        None, description="Compact metrics-registry summary (obs/metrics.py "
        "MetricsRegistry.summary(): histograms as ms percentiles); None while it is empty.")
    prefix_chains: Optional[List[str]] = Field(
        None, description="Hot prefix-chain digests (hex) for prefix-affinity routing; None "
        "without it.")
    last_dispatch_ok_age_s: Optional[float] = Field(
        None, description="Seconds since the dispatch watchdog last saw a clean device call; "
        "None (omitted) when no watchdog runs.")
    integrity: Optional[str] = Field(
        None, description="Numerics-integrity verdict ('ok' / 'suspect'); None (omitted) when "
        "every integrity knob is off.")
    role: Optional[str] = Field(
        None, description="The disaggregated role served ('prefill' / 'decode'); None (omitted) "
        "for unified workers.")


class ErrorInfo(BaseModel):
    """Dead-letter record, read back from ``<queue>.failed``."""

    job_id: str
    error_message: str
    timestamp: datetime = Field(default_factory=utcnow)
    worker_id: Optional[str] = None
    redeliveries: int = 0
    failure_reason: Optional[str] = Field(
        None, description="Machine-readable failure class (engine_error:<type>, timeout, "
        "deadline_exceeded, ...); None where none was recorded.")
