"""Dispatch watchdog: detect wedged device calls from a side thread (copy
of ``llmq_tpu/engine/watchdog.py``).

A wedged device call (a kernel that never ends, a stuck copy, a deadlock
in the CUDA runtime) blocks the engine thread inside an uninterruptible
C++ call: on the card, the drain's ``event.synchronize()`` (which
releases the GIL, so this monitor runs meanwhile). The watchdog does not interrupt the call
(nothing can, short of killing the process); it *detects* the overrun
from a side thread so the rest of the process can act: advertise the
wedge in ``last_dispatch_ok_age_s``, raise :class:`HungDispatchError` once
the call returns, or let the janitor reclaim the worker.

Deadlines come from the live per-kind dispatch histograms:
``deadline = max(min_s, p99(kind) * mult)``; a kind without history uses
the floor. The feature defaults off (``mult <= 0``): no thread is started
and the engine's bracket is a shared no-op context.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Callable, Optional, Tuple

from llmq_tpu_torch.core.faults import HungDispatchError
from llmq_tpu_torch.utils import clock

logger = logging.getLogger(__name__)

# Shared no-op bracket for the default-off path.
NO_GUARD = contextlib.nullcontext()


def dispatch_deadline_s(p99: Optional[float], mult: float, min_s: float) -> float:
    """``max(min_s, p99 * mult)``, the floor alone without history."""
    if p99 is None:
        return float(min_s)
    return max(float(min_s), float(p99) * float(mult))


class DispatchWatchdog:
    """Monotonic-deadline monitor for device dispatch / fetch brackets.

    One bracket is active at a time (the engine thread is the only
    dispatcher); the monitor thread polls it and records a trip when the
    deadline passes: at once through ``on_trip`` (on the monitor thread),
    and, if the wedged call returns, as a :class:`HungDispatchError` from
    the bracket's ``__exit__`` on the engine thread."""

    def __init__(
        self,
        *,
        mult: float,
        min_s: float,
        percentile_fn: Callable[[str], Optional[float]],
        on_trip: Optional[Callable[[str, float, float], None]] = None,
        poll_s: float = 0.05,
    ) -> None:
        self.mult = float(mult)
        self.min_s = float(min_s)
        self._percentile = percentile_fn
        self._on_trip = on_trip
        self._poll_s = poll_s
        self._lock = threading.Lock()
        # (kind, started_monotonic, deadline_seconds) of the bracket in
        # flight, or None between brackets.
        self._current: Optional[Tuple[str, float, float]] = None
        # (kind, elapsed, deadline) recorded by the monitor for the current
        # bracket; cleared on bracket exit.
        self._tripped: Optional[Tuple[str, float, float]] = None
        self.trips = 0
        self._last_ok = clock.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="llmq-watchdog", daemon=True)
        self._thread.start()

    def deadline_for(self, kind: str) -> float:
        """``max(min_s, p99 * mult)``; the floor alone without history."""
        try:
            p99 = self._percentile(kind)
        except Exception:  # noqa: BLE001 — deadline math must never raise
            p99 = None
        return dispatch_deadline_s(p99, self.mult, self.min_s)

    def guard(self, kind: str) -> "_Guard":
        return _Guard(self, kind)

    def last_ok_age_s(self) -> float:
        """Seconds since a bracketed device call last completed cleanly;
        grows without bound while a call is wedged."""
        return clock.monotonic() - self._last_ok

    def wedged_kind(self) -> Optional[str]:
        """Kind of the currently overdue in-flight bracket, or None."""
        with self._lock:
            cur, tripped = self._current, self._tripped
        if cur is not None and tripped is not None:
            return cur[0]
        return None

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                cur, tripped = self._current, self._tripped
            if cur is None or tripped is not None:
                continue
            kind, started, deadline = cur
            elapsed = clock.monotonic() - started
            if elapsed <= deadline:
                continue
            with self._lock:
                # The bracket may have exited (or another begun) meanwhile.
                if self._current is not cur or self._tripped is not None:
                    continue
                self._tripped = (kind, elapsed, deadline)
                self.trips += 1
            logger.error("watchdog trip: %s dispatch wedged for %.2fs (deadline %.2fs); "
                         "engine thread cannot be interrupted", kind, elapsed, deadline)
            if self._on_trip is not None:
                try:
                    self._on_trip(kind, elapsed, deadline)
                except Exception:  # noqa: BLE001 — observer must not kill us
                    logger.exception("watchdog on_trip callback failed")


class _Guard:
    """One dispatch / fetch bracket. Raises :class:`HungDispatchError` on
    clean exit if the monitor tripped while the call was in flight; an
    exception already propagating out of the call takes precedence."""

    __slots__ = ("_wd", "_kind")

    def __init__(self, wd: DispatchWatchdog, kind: str) -> None:
        self._wd = wd
        self._kind = kind

    def __enter__(self) -> "_Guard":
        wd = self._wd
        deadline = wd.deadline_for(self._kind)
        with wd._lock:
            wd._current = (self._kind, clock.monotonic(), deadline)
            wd._tripped = None
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        wd = self._wd
        with wd._lock:
            tripped = wd._tripped
            wd._current = None
            wd._tripped = None
        if exc_type is None:
            if tripped is not None:
                raise HungDispatchError(*tripped)
            wd._last_ok = clock.monotonic()
        return False
