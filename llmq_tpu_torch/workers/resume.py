"""Zero-loss worker handoff: resumable-job plumbing of the worker (copy
of ``llmq_tpu/workers/resume.py``).

When a draining worker (SIGTERM) still holds in-flight requests, the
engine's drain-with-handoff extracts each one as a
:class:`~llmq_tpu_torch.engine.snapshot.RequestSnapshot`. The worker
republishes the job to its own queue with the snapshot riding under
``RESUME_FIELD`` (base64 of the versioned, integrity-hashed snapshot
codec, never pickle), so a restarting or peer worker picks it up and
continues mid-stream instead of re-running the prompt from scratch. A
prefill-role worker hands every job on the same way, at the prefill
boundary, to the decode pool (:class:`PrefillDone`).

Because handoff republishes and broker redelivery can both put the same
job in front of a worker more than once, results are deduplicated on
``(job_id, resume offset)`` before publishing: a job claimed twice at the
same progress point publishes exactly one result. (A job resumed at a
*different* offset is a different unit of work by construction: the
earlier attempt never published, it handed off.)
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

# Job extra field carrying resume state across a handoff:
#   {"snapshot": "<base64 snapshot blob>", "offset": <tokens already emitted>}
RESUME_FIELD = "llmq_resume"


class JobHandoff(Exception):
    """Raised by a processor when the engine resolved a request with a
    handoff instead of a completion (drain-with-handoff in progress).
    Carries the serialized snapshot (None when the request never entered
    the engine: nothing to carry, requeue the job whole) and the number
    of tokens already generated."""

    def __init__(self, snapshot_b64: Optional[str], emitted: int = 0) -> None:
        super().__init__(f"request handed off with {emitted} tokens generated")
        self.snapshot_b64 = snapshot_b64
        self.emitted = emitted


class PrefillDone(Exception):
    """Raised by a prefill-role processor when the engine finished the
    prompt phase of a request (``finish_reason="prefill_done"``): the
    prompt KV is complete and snapshotted, no output token was kept. The
    worker hands the request to the decode pool (a snapshot republish on
    ``<q>.decode``) instead of publishing a result."""

    def __init__(self, snapshot_b64: str) -> None:
        super().__init__("prefill complete; handing off to the decode pool")
        self.snapshot_b64 = snapshot_b64


def resume_offset(extras: Optional[dict]) -> int:
    """The emitted-token offset a job's resume state claims (0 for a
    fresh job or malformed resume field)."""
    if not extras:
        return 0
    resume = extras.get(RESUME_FIELD)
    if not isinstance(resume, dict):
        return 0
    try:
        return max(0, int(resume.get("offset", 0)))
    except (TypeError, ValueError):
        return 0


class ResultDeduper:
    """Bounded memory of result publishes, keyed ``(job_id, offset)``.

    ``seen`` answers "did this worker already publish a result for this
    job at this progress point?": the guard that makes redelivered and
    resumed jobs publish exactly once per worker. Bounded FIFO, so a
    long-lived worker's memory doesn't grow without limit; evicting an
    old key merely re-opens the (already unlikely) duplicate window for
    that old job, it never blocks new publishes."""

    def __init__(self, capacity: int = 8192) -> None:
        self._capacity = max(1, capacity)
        self._order: deque = deque()
        self._keys: set = set()

    def seen(self, job_id: str, offset: int = 0) -> bool:
        return (job_id, offset) in self._keys

    def record(self, job_id: str, offset: int = 0) -> None:
        key: Tuple[str, int] = (job_id, offset)
        if key in self._keys:
            return
        self._keys.add(key)
        self._order.append(key)
        while len(self._order) > self._capacity:
            self._keys.discard(self._order.popleft())

    def __len__(self) -> int:
        return len(self._order)
