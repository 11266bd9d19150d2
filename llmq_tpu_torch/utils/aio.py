"""Asyncio task hygiene for the broker's dispatch loop and transports.

``spawn`` replaces naked ``asyncio.ensure_future(...)`` fire-and-forget:
the task is parked in a registry set (a strong reference — the loop
itself only keeps a weak one) and a done-callback logs any
non-cancellation exception instead of letting it vanish. ``reap`` /
``reap_all`` cancel and await tasks at teardown without swallowing the
reaper's own cancellation.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Coroutine, Iterable, Optional, Set

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


async def reap(task: Optional["asyncio.Future"], *, label: str = "task") -> None:
    """Cancel ``task`` and await it without swallowing our own cancellation.

    Any exception the task dies with (other than the cancellation we just
    requested) is logged: by the time a task is being reaped nobody is
    left to consume its result.
    """
    if task is None or task.done() and task.cancelled():
        return
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        if asyncio.current_task().cancelling():
            raise  # the reaper itself was cancelled: propagate
    except Exception:  # noqa: BLE001 — terminal: log, nobody else will
        logger.exception("%s raised while being cancelled", label)


async def reap_all(tasks: Iterable["asyncio.Future"], *, label: str = "tasks") -> None:
    """Cancel-and-await a collection (snapshot first: reaping mutates
    registries via done-callbacks)."""
    for task in list(tasks):
        await reap(task, label=label)


async def wait_drained(tasks: Set["asyncio.Task"], *, timeout: Optional[float] = None) -> bool:
    """Wait for in-flight tasks to finish on their own (graceful drain);
    returns False if ``timeout`` expired with tasks still pending."""
    pending = [t for t in tasks if not t.done()]
    if not pending:
        return True
    done, still_pending = await asyncio.wait(pending, timeout=timeout)
    return not still_pending
