"""Device-fault taxonomy shared by the engine and the workers (copy of
``llmq_tpu/core/faults.py``).

The engine raises device-side failures (a wedged dispatch detected by
the watchdog, a device-runtime error, a device-memory allocation
failure, a mesh / topology mismatch); the worker classifies them into a
small fixed set of machine-readable reasons that flow into dead-letter /
quarantine headers (``x-failure-reason``) and the breaker. Kept
dependency-free (no torch) so the generic worker base imports it without
the engine stack.

One departure (ROADMAP.md queue 3): on the TPU a device-runtime failure
is jaxlib's ``XlaRuntimeError``; on the card it is a CUDA error, raised
by the port's own launch check (``ops/_build.py``: ``"<lib> kernel launch
failed: CUDA error <code> (<msg>)"``), by torch (``"CUDA error: ..."``,
``torch.AcceleratorError`` or ``RuntimeError``) or by cuBLAS
(``CUBLAS_STATUS_...``). Each classifies as ``xla_runtime_error``, the
wire name of the class. torch's ``OutOfMemoryError`` ("CUDA out of
memory") falls on the reference's ``"out of memory"`` match: ``hbm_oom``.
"""

from __future__ import annotations

from typing import Optional

# Failure classes. Values are wire-visible (headers, traces).
FAULT_HUNG = "hung_dispatch"
FAULT_XLA = "xla_runtime_error"
FAULT_OOM = "hbm_oom"
FAULT_MESH = "mesh_error"
FAULT_NUMERICAL = "numerical_fault"

# Every class above is recoverable by an in-process engine rebuild.
DEVICE_FAULT_REASONS = (
    FAULT_HUNG,
    FAULT_XLA,
    FAULT_OOM,
    FAULT_MESH,
    FAULT_NUMERICAL,
)


class HungDispatchError(RuntimeError):
    """A watchdog-bracketed device call exceeded its deadline.

    Raised on the engine thread when the overdue call eventually returns
    (a transient stall). A call that never returns cannot be unwound: the
    watchdog's trip state and the heartbeat's ``last_dispatch_ok_age_s``
    surface it instead."""

    def __init__(self, kind: str, elapsed: float, deadline: float):
        super().__init__(
            f"device dispatch {kind!r} exceeded its watchdog deadline "
            f"({elapsed:.2f}s elapsed > {deadline:.2f}s allowed)"
        )
        self.kind = kind
        self.elapsed = elapsed
        self.deadline = deadline


class LogitGuardError(RuntimeError):
    """The on-device numerics guard flagged the logits of a dispatch
    (non-finite values, out-of-bound magnitude, or an entropy collapse).
    ``suspects`` are the request ids riding the flagged rows: the
    recovery re-runs exactly those on a rebuilt core to decide job-poison
    vs device-fault."""

    def __init__(self, check: str, detail: str, suspects: tuple = (), kind: str = ""):
        super().__init__(f"logit guard tripped [{check}] on {kind or 'dispatch'}: {detail}")
        self.check = check
        self.detail = detail
        self.suspects = tuple(suspects)
        self.kind = kind


class DeviceFaultError(RuntimeError):
    """A classified device fault the engine could not recover from
    in-process (rebuild unavailable or failed, or the OOM ladder ran
    dry), or a job the numerics guard convicted as poison. The worker maps
    ``failure_reason`` straight into its quarantine / dead-letter headers."""

    def __init__(self, failure_reason: str, message: str):
        super().__init__(message)
        self.failure_reason = failure_reason


def classify_failure(exc: BaseException) -> Optional[str]:
    """Map an exception escaping the engine step loop to a device-fault
    class, or ``None`` for ordinary application errors. Matching is
    textual beyond the typed cases, as in the reference."""
    if isinstance(exc, HungDispatchError):
        return FAULT_HUNG
    if isinstance(exc, LogitGuardError):
        return FAULT_NUMERICAL
    if isinstance(exc, DeviceFaultError):
        return exc.failure_reason
    text = f"{type(exc).__name__}: {exc}".lower()
    # Order matters: an allocation failure is also a runtime error, so its
    # signature wins over the generic match.
    if "resource_exhausted" in text or "out of memory" in text:
        return FAULT_OOM
    if "mesh" in text or "device topology" in text or "slice_config" in text:
        return FAULT_MESH
    if "xlaruntimeerror" in text or "jaxruntimeerror" in text or (
        "xla" in text and "error" in text
    ):
        return FAULT_XLA
    # The card's device-runtime errors (module docstring).
    if "cuda error" in text or "acceleratorerror" in text or "cublas_status" in text:
        return FAULT_XLA
    return None
