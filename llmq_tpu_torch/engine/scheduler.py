"""Continuous-batching scheduler: slots, paged KV allocation, preemption.

Port of ``llmq_tpu/engine/scheduler.py`` without the prefix cache (its
chain hashing and refcount sharing come with ROADMAP M8) and without
priority classes (M11). The device half is a fixed-shape decode step over
``max_num_seqs`` slots; this module decides which sequence lives in which
slot and which physical KV pages back it.

Invariants (``check_invariants``):
  - every physical page in use belongs to exactly one running sequence;
    page 0 is a reserved scratch page and is never handed out,
  - every admitted sequence has pages covering len(tokens)+1 positions,
  - slots hold at most one sequence,
  - admission is FIFO; preemption evicts the youngest running sequence
    (its re-prefill wastes the least work) and keeps its generated tokens.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from llmq_tpu_torch.engine.sampling import SamplingParams


class OutOfPages(Exception):
    """No free KV pages; caller should preempt or defer."""


class PageAllocator:
    """Free-list allocator over the physical KV page pool. Page 0 is
    reserved: masked/padded positions scatter there, so it never backs
    live data."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._used: set = set()

    @property
    def available(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return int(page in self._used)

    def alloc(self, n: int = 1) -> List[int]:
        """Allocate n pages atomically; raises OutOfPages if short."""
        if n > len(self._free):
            raise OutOfPages(f"want {n} pages, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for page in pages:
            if page not in self._used:
                raise ValueError(f"double-free or foreign page {page}")
            self._used.discard(page)
            self._free.append(page)


@dataclasses.dataclass
class Sequence:
    """One request's generation state (host side)."""

    rid: str
    prompt_ids: List[int]
    params: SamplingParams
    output_ids: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    # Bumped on every preemption: in-flight device results snapshotted
    # under an older epoch must not be appended after re-admission.
    epoch: int = 0
    slot: int = -1
    admitted_at: int = -1  # scheduler tick of (last) admission, for LIFO preempt
    preempt_count: int = 0
    prefilled: bool = False  # KV cache holds this sequence (engine sets it)
    finish_reason: Optional[str] = None
    finish_text: Optional[str] = None  # pre-truncated text on stop-string hit
    # Incremental detokenization cache for stop strings: ``detok_text`` is
    # the decoded text of ``output_ids[:detok_len]``.
    detok_len: int = 0
    detok_text: str = ""
    # Host-side lifecycle stamps (time.monotonic(); 0.0 = not yet).
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_prefill_start: float = 0.0
    t_first_token: float = 0.0
    t_last_token: float = 0.0

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def last_token(self) -> int:
        return self.output_ids[-1] if self.output_ids else self.prompt_ids[-1]


@dataclasses.dataclass
class SchedulerConfig:
    max_num_seqs: int
    num_pages: int
    page_size: int
    max_model_len: int

    @property
    def pages_per_seq(self) -> int:
        return -(-self.max_model_len // self.page_size)  # ceil


class Scheduler:
    """Slot/page bookkeeping for the continuous batch."""

    def __init__(self, config: SchedulerConfig) -> None:
        self.config = config
        self.allocator = PageAllocator(config.num_pages)
        self.slots: List[Optional[Sequence]] = [None] * config.max_num_seqs
        self.waiting: Deque[Sequence] = deque()
        self.running: Dict[str, Sequence] = {}
        self._tick = 0
        self.preemptions = 0

    # --- queue ------------------------------------------------------------
    def add(self, seq: Sequence) -> None:
        # Overlong prompts are truncated to fit the context window, and
        # generation is capped so prompt+output never exceeds max_model_len.
        limit = self.config.max_model_len - 1
        if len(seq.prompt_ids) > limit:
            seq.prompt_ids = seq.prompt_ids[:limit]
        if seq.num_tokens + seq.params.max_tokens > self.config.max_model_len:
            seq.params.max_tokens = max(0, self.config.max_model_len - seq.num_tokens)
        if self._pages_needed(seq.num_tokens) > self.config.num_pages - 1:
            # Even an empty pool could never hold the prompt: reject now,
            # or admit() would retry forever.
            raise ValueError(
                f"prompt of {seq.num_tokens} tokens needs "
                f"{self._pages_needed(seq.num_tokens)} KV pages; pool has "
                f"{self.config.num_pages - 1}"
            )
        if seq.t_enqueue == 0.0:
            seq.t_enqueue = time.monotonic()
        self.waiting.append(seq)

    @property
    def has_waiting(self) -> bool:
        return bool(self.waiting)

    def _pages_needed(self, num_tokens: int) -> int:
        # +1 position of headroom: the decode step writes the *next* token's
        # KV before the host learns the sequence finished.
        return -(-(num_tokens + 1) // self.config.page_size)

    # --- admission --------------------------------------------------------
    def admit(self, max_new: Optional[int] = None) -> List[Sequence]:
        """Move waiting sequences (FIFO) into free slots while pages allow;
        each admitted sequence needs a prefill before it joins decode."""
        admitted: List[Sequence] = []
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        while self.waiting and free_slots:
            if max_new is not None and len(admitted) >= max_new:
                break
            seq = self.waiting[0]
            try:
                seq.pages = self.allocator.alloc(self._pages_needed(seq.num_tokens))
            except OutOfPages:
                break
            self.waiting.popleft()
            seq.slot = free_slots.pop(0)
            seq.admitted_at = self._tick
            self._tick += 1
            seq.t_admit = time.monotonic()
            self.slots[seq.slot] = seq
            self.running[seq.rid] = seq
            admitted.append(seq)
        return admitted

    # --- decode-step bookkeeping -----------------------------------------
    def ensure_pages(
        self,
        seq: Sequence,
        num_positions: int,
        *,
        allow_preempt: bool = True,
        preemptible=None,
    ) -> None:
        """Grow ``seq``'s page map to cover ``num_positions`` KV slots
        (capped at the per-sequence maximum). The engine calls this at
        dispatch time with a lookahead, so pages exist before the step
        that writes them. May preempt the youngest other sequence (unless
        ``allow_preempt`` is off — the engine forbids it while steps are
        in flight); ``preemptible`` filters victims. Raises OutOfPages."""
        cap = self.config.pages_per_seq * self.config.page_size
        num_positions = min(num_positions, cap)
        while -(-num_positions // self.config.page_size) > len(seq.pages):
            try:
                seq.pages.extend(self.allocator.alloc(1))
            except OutOfPages:
                if not allow_preempt:
                    raise
                victim = self._youngest_running(exclude=seq.rid, preemptible=preemptible)
                if victim is None:
                    raise
                self.preempt(victim)

    def _youngest_running(self, exclude: str, preemptible=None) -> Optional[Sequence]:
        candidates = [
            s
            for s in self.running.values()
            if s.rid != exclude and (preemptible is None or preemptible(s))
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda s: s.admitted_at)

    def preempt(self, seq: Sequence, *, defer_pages: bool = False) -> List[int]:
        """Evict a running sequence back to the head of the waiting queue.
        Its generated tokens are kept; re-admission re-prefills
        prompt+output (recompute preemption). With ``defer_pages`` the
        pages are detached and returned instead of freed — the engine
        releases them once no in-flight step can still write them."""
        seq.epoch += 1  # stale in-flight results must not resurface
        pages: List[int] = []
        if defer_pages:
            pages, seq.pages = seq.pages, []
        self._release(seq)
        seq.preempt_count += 1
        self.preemptions += 1
        seq.prefilled = False  # KV is gone; re-admission re-prefills
        self.waiting.appendleft(seq)
        return pages

    def finish(
        self, seq: Sequence, reason: str, *, defer_pages: bool = False
    ) -> List[int]:
        """Finish a sequence; with ``defer_pages`` its pages are detached
        and returned for a later :meth:`release_pages`."""
        seq.finish_reason = reason
        pages: List[int] = []
        if defer_pages:
            pages, seq.pages = seq.pages, []
        self._release(seq)
        return pages

    def release_pages(self, pages: List[int]) -> None:
        """Return deferred pages (from ``finish``/``preempt``)."""
        self.allocator.free(pages)

    def _release(self, seq: Sequence) -> None:
        if seq.slot >= 0:
            self.slots[seq.slot] = None
            seq.slot = -1
        self.running.pop(seq.rid, None)
        if seq.pages:
            self.allocator.free(seq.pages)
            seq.pages = []

    # --- introspection ----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        total_pages = self.config.num_pages - 1
        return {
            "running": len(self.running),
            "waiting": len(self.waiting),
            "slots": self.config.max_num_seqs,
            "batch_occupancy": len(self.running) / self.config.max_num_seqs,
            "kv_page_utilization": (total_pages - self.allocator.available)
            / max(1, total_pages),
            "preemptions": self.preemptions,
        }

    def check_invariants(self) -> None:
        """Debug/test hook: raise if a documented invariant is broken."""
        owners: Dict[int, int] = {}
        for seq in self.running.values():
            if self.slots[seq.slot] is not seq:
                raise AssertionError(f"{seq.rid} not in its slot {seq.slot}")
            if self._pages_needed(seq.num_tokens) > len(seq.pages):
                raise AssertionError(f"{seq.rid} lacks pages")
            for page in seq.pages:
                owners[page] = owners.get(page, 0) + 1
        if 0 in owners:
            raise AssertionError("scratch page handed out")
        if any(n != 1 for n in owners.values()):
            raise AssertionError("page owned twice")
        in_use = len(self.allocator._used)
        if len(owners) > in_use or in_use + self.allocator.available != self.config.num_pages - 1:
            raise AssertionError("allocator out of balance")
