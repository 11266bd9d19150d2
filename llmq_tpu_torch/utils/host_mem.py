"""Unified host-memory governor (from ``llmq_tpu/utils/host_mem.py``).

Several subsystems buffer KV-derived bytes in host RAM: snapshot
swap-preemption (``engine/engine.py`` capture paths) here, and the prefix
cold tier (``engine/prefix_store.py``, ROADMAP.md M11b) with it. Sized
each on its own, their budgets would only compose by luck, and a worker
that overshoots container RAM is OOM-killed with every in-flight request.

:class:`HostMemoryGovernor` gives them one shared byte budget
(``LLMQ_HOST_MEM_GB``). A swap capture that would push usage past
``SWAP_REFUSE_FRAC`` of it is refused, and the engine falls back to
recompute-preemption: the behaviour without swap, always correct, just
slower on resume.

The reference's other rungs (evicting cold prefixes, refusing KV-ship
serves, eviction pressure from resume-republish blobs) act only on the
prefix tier and its peers, so they come with M11b.

A budget of 0 (the default) disables the governor: every ``admit_swap``
answers yes.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

# The share of the byte budget above which a swap capture is refused.
SWAP_REFUSE_FRAC = 0.85


class HostMemoryGovernor:
    """One shared byte budget across host-RAM consumers.

    Consumers ``register(name, usage_fn)``; ``usage_fn`` reports their
    current bytes, so admission checks see the *global* occupancy, not
    one store's.
    """

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = max(0, int(budget_bytes))
        self._lock = threading.Lock()
        self._usage_fns: Dict[str, Callable[[], int]] = {}
        self.swap_refusals = 0

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    def register(self, name: str, usage_fn: Callable[[], int]) -> None:
        """Register (or replace) a consumer. Idempotent per name so
        engine restarts inside one process re-bind cleanly."""
        with self._lock:
            self._usage_fns[name] = usage_fn

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

    def admit_swap(self, nbytes: int) -> bool:
        """May the engine buffer a swap-preempt capture of ``nbytes``?

        Refuses if the capture would push usage past ``SWAP_REFUSE_FRAC``
        of budget. A refusal is safe — the caller falls back to
        recompute-preemption.
        """
        if not self.enabled:
            return True
        if self.usage_bytes() + nbytes <= int(self.budget_bytes * SWAP_REFUSE_FRAC):
            return True
        self.swap_refusals += 1
        return False


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
