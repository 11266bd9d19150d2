"""Unified host-memory governor (from ``llmq_tpu/utils/host_mem.py``).

Three subsystems buffer KV-derived bytes in host RAM: the prefix cold tier
(``engine/prefix_store.py``), snapshot swap-preemption (``engine/engine.py``
capture paths) and resume-republish blobs (the worker's handoffs). Sized
each on its own, their budgets would only compose by luck, and a worker
that overshoots container RAM is OOM-killed with every in-flight request.

:class:`HostMemoryGovernor` gives them one shared byte budget
(``LLMQ_HOST_MEM_GB``) with a ladder of degradations, each of which trades
throughput, never correctness:

1. **Evict cold prefixes.** Prefix pages are a pure cache; dropping one
   costs a re-prefill at worst.
2. **Refuse swap-preempt** (above ``SWAP_REFUSE_FRAC`` of the budget,
   after eviction). The engine falls back to recompute-preemption: the
   behaviour without swap, always correct, just slower on resume.
3. **Refuse KV-ship serves** (above ``SERVE_REFUSE_FRAC``). A peer that
   asked for prefix pages recomputes them locally instead; export
   buffers are the last optional allocation standing.

Resume-republish blobs are accounted but never refused: refusing one
would strand an in-flight request mid-drain.

A budget of 0 (the default) disables the governor: every ``admit_*``
answers yes and no eviction pressure is applied.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

# The shares of the byte budget above which a swap capture, then a serve of
# prefix pages to a peer, is refused: rising pressure sheds optional local
# buffering before it stops helping remote peers.
SWAP_REFUSE_FRAC = 0.85
SERVE_REFUSE_FRAC = 0.95


class HostMemoryGovernor:
    """One shared byte budget across host-RAM consumers.

    Consumers ``register(name, usage_fn, evict_fn=None)``: ``usage_fn``
    reports their current bytes, ``evict_fn(nbytes)`` (optional) frees, at
    least effort, toward ``nbytes`` and returns the bytes it freed.
    Admission checks see the *global* occupancy, not one store's.
    """

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = max(0, int(budget_bytes))
        self._lock = threading.Lock()
        self._usage_fns: Dict[str, Callable[[], int]] = {}
        self._evict_fns: Dict[str, Callable[[int], int]] = {}
        self.evictions_forced = 0
        self.swap_refusals = 0
        self.serve_refusals = 0

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    def register(
        self,
        name: str,
        usage_fn: Callable[[], int],
        evict_fn: Optional[Callable[[int], int]] = None,
    ) -> None:
        """Register (or replace) a consumer. Idempotent per name so
        engine restarts inside one process re-bind cleanly."""
        with self._lock:
            self._usage_fns[name] = usage_fn
            if evict_fn is not None:
                self._evict_fns[name] = evict_fn
            else:
                self._evict_fns.pop(name, None)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._usage_fns.pop(name, None)
            self._evict_fns.pop(name, None)

    def usage_bytes(self) -> int:
        """Sum of all registered consumers' current bytes (0 on any
        consumer error — a broken gauge must not wedge admission)."""
        with self._lock:
            fns = list(self._usage_fns.values())
        total = 0
        for fn in fns:
            try:
                total += max(0, int(fn()))
            except Exception:  # noqa: BLE001 — gauges are best-effort
                pass
        return total

    def _evict_toward(self, target_bytes: int) -> int:
        """Rung 1: ask the evictors (cold prefixes, the only ones) to free
        until global usage fits under ``target_bytes``. Returns the bytes
        freed."""
        freed = 0
        with self._lock:
            evictors = list(self._evict_fns.values())
        for evict in evictors:
            over = self.usage_bytes() - target_bytes
            if over <= 0:
                break
            try:
                got = int(evict(over))
            except Exception:  # noqa: BLE001 — an evictor's fault must not wedge admission
                got = 0
            if got > 0:
                freed += got
                self.evictions_forced += 1
        return freed

    def admit_swap(self, nbytes: int) -> bool:
        """May the engine buffer a swap-preempt capture of ``nbytes``?

        Evicts cold prefixes first; refuses only if, even after that, the
        capture would push usage past ``SWAP_REFUSE_FRAC`` of the budget.
        A refusal is safe: the caller falls back to recompute-preemption.
        """
        if not self.enabled:
            return True
        limit = int(self.budget_bytes * SWAP_REFUSE_FRAC)
        if self.usage_bytes() + nbytes <= limit:
            return True
        self._evict_toward(limit - nbytes)
        if self.usage_bytes() + nbytes <= limit:
            return True
        self.swap_refusals += 1
        return False

    def admit_serve(self) -> bool:
        """May this worker build an export buffer to serve a peer's fetch
        of prefix pages? Refused only near the top of the budget (the last
        rung); the peer recomputes, which is always correct."""
        if not self.enabled:
            return True
        if self.usage_bytes() <= int(self.budget_bytes * SERVE_REFUSE_FRAC):
            return True
        self.serve_refusals += 1
        return False

    def note_resume_blob(self, nbytes: int) -> None:
        """Account a resume-republish blob. Never refuses (that would
        strand an in-flight request mid-drain), but applies eviction
        pressure so the *next* optional allocation sees the cost."""
        if not self.enabled or nbytes <= 0:
            return
        if self.usage_bytes() + nbytes > self.budget_bytes:
            self._evict_toward(self.budget_bytes - nbytes)

    def stats(self) -> Dict[str, int]:
        return {
            "budget_bytes": self.budget_bytes,
            "usage_bytes": self.usage_bytes(),
            "evictions_forced": self.evictions_forced,
            "swap_refusals": self.swap_refusals,
            "serve_refusals": self.serve_refusals,
        }


_governor: Optional[HostMemoryGovernor] = None
_governor_lock = threading.Lock()


def get_governor() -> HostMemoryGovernor:
    """Process-wide governor, sized from ``LLMQ_HOST_MEM_GB`` on first
    use (0/unset = disabled — all admissions pass)."""
    global _governor
    with _governor_lock:
        if _governor is None:
            from llmq_tpu_torch.core.config import get_config

            gb = get_config().host_mem_gb or 0.0
            _governor = HostMemoryGovernor(int(gb * (1 << 30)))
        return _governor


def set_governor(governor: Optional[HostMemoryGovernor]) -> None:
    """Swap the process governor (tests / probes re-size budgets)."""
    global _governor
    with _governor_lock:
        _governor = governor
