"""Injectable time source (copy of ``llmq_tpu/utils/clock.py``).

:class:`Clock` reads the real ``time.monotonic`` / ``time.time``; a test
may install another through :func:`set_clock`. Policy code reads time
through :func:`monotonic` / :func:`wall`.
"""

from __future__ import annotations

import time as _time


class Clock:
    """A monotonic + wall clock pair."""

    def monotonic(self) -> float:
        return _time.monotonic()

    def time(self) -> float:
        return _time.time()


_clock: Clock = Clock()


def set_clock(clock: Clock) -> None:
    """Install a process-wide clock (tests). ``Clock()`` restores real time."""
    global _clock
    _clock = clock


def monotonic() -> float:
    return _clock.monotonic()


def wall() -> float:
    return _clock.time()
