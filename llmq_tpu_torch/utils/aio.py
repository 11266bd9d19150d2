"""Asyncio task hygiene for the broker's dispatch loop.

``spawn`` replaces naked ``asyncio.ensure_future(...)`` fire-and-forget:
the task is parked in a registry set (a strong reference — the loop
itself only keeps a weak one) and a done-callback logs any
non-cancellation exception instead of letting it vanish.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Coroutine, Optional, Set

logger = logging.getLogger(__name__)


def spawn(
    coro: Coroutine,
    *,
    registry: Optional[Set["asyncio.Task"]] = None,
    name: Optional[str] = None,
    on_error: Optional[Callable[[BaseException], None]] = None,
) -> "asyncio.Task":
    """Schedule ``coro`` as a task that cannot leak silently.

    The registry (when given) holds the task until it finishes; callers own
    cancelling whatever is left in it at teardown. Exceptions are delivered
    to ``on_error`` or logged — never discarded.
    """
    task = asyncio.ensure_future(coro)
    if name is not None:
        task.set_name(name)
    if registry is not None:
        registry.add(task)

    def _done(t: "asyncio.Task") -> None:
        if registry is not None:
            registry.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is None:
            return
        if on_error is not None:
            on_error(exc)
        else:
            logger.error(
                "Background task %s crashed", t.get_name(), exc_info=exc
            )

    task.add_done_callback(_done)
    return task
