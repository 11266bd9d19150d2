"""Continuous-batching scheduler: slots, paged KV allocation, preemption.

Port of ``llmq_tpu/engine/scheduler.py`` with its prefix cache (the
refcounted allocator with a parked evictable pool :83-175, chain-hash
matching at admission :462-521, ``register_prefix`` :327,
``invalidate_prefix_cache`` :364), its priority classes (interactive
waiters first, ``_next_admit_index`` :450; batch victims first under page
pressure, ``_youngest_running`` :589), snapshot restores
(``add_restored`` :406), the ``on_preempt`` hook swap preemption rides
(:621) and the host prefix tier's hooks (``on_demote`` / ``host_lookup``:
an evicted cache page parks in host RAM, and admission extends a device
match from the host tier, :284-294, :486-520), plus
``mixed_token_budget`` (:45), the piggybacked segment's share of a mixed
dispatch, and its two latency histograms (queue wait, preemption delay;
:298-305, observed at admission :526-532, percentiles in ``stats``
:694-697), which the owning engine registers for ``/metrics``. The device
half is a fixed-shape decode step over
``max_num_seqs`` slots; this module decides which sequence lives in which
slot and which physical KV pages back it.

Invariants (``check_invariants``):
  - every physical page's refcount covers the running sequences listing
    it (one owner unless prefix caching shares it; deferred releases hold
    the rest); page 0 is a reserved scratch page and is never handed out,
  - every admitted sequence has pages covering len(tokens)+1 positions,
  - slots hold at most one sequence,
  - admission is FIFO (interactive waiters first once the scheduler is
    priority-aware); preemption evicts the youngest running sequence (its
    re-prefill wastes the least work; batch before interactive) and keeps
    its generated tokens.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from llmq_tpu_torch.engine.sampling import SamplingParams
from llmq_tpu_torch.obs.metrics import Histogram, to_ms
from llmq_tpu_torch.utils.hashing import token_prefix_chain


class OutOfPages(Exception):
    """No free KV pages; caller should preempt or defer."""


def mixed_token_budget(
    chunk_size: int, decode_rows: int, remaining: int, *, min_tokens: int = 1
) -> int:
    """Prefill positions one piggybacked segment may claim in a mixed
    (decode + prefill) iteration: the chunk width less one position for
    each decodable row, at least ``min_tokens`` so the prompt always
    advances, at most the chunk width and the ``remaining`` positions
    (0 when none remain)."""
    if remaining <= 0:
        return 0
    return min(remaining, max(chunk_size - decode_rows, min_tokens), chunk_size)


class PageAllocator:
    """Refcounted free-list allocator over the physical KV page pool. Page
    0 is reserved: masked/padded positions scatter there, so it never
    backs live data.

    Three page states: *allocated* (refcount >= 1; a prefix-cached page
    shared by several sequences carries one reference per sharer),
    *cached* (refcount 0 but registered as evictable: its KV may serve a
    future prefix match; reclaimed lazily, oldest first, under pressure),
    and *free*. Without prefix caching every page has refcount 1 and this
    is a plain free list."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._cached: Dict[int, None] = {}  # LRU order of refcount-0 pages
        # Called with a page id when a cached page is evicted, so the
        # prefix cache drops the hashes pointing at it.
        self.on_evict: Optional[Callable[[int], None]] = None

    @property
    def available(self) -> int:
        return len(self._free) + len(self._cached)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int = 1) -> List[int]:
        """Allocate n fresh pages atomically (evicting cached pages, oldest
        first, as needed); raises OutOfPages if short."""
        if n > self.available:
            raise OutOfPages(f"want {n} pages, have {self.available}")
        while len(self._free) < n:
            self._evict_one()
        pages = [self._free.pop() for _ in range(n)]
        for page in pages:
            self._refs[page] = 1
        return pages

    def share(self, page: int) -> None:
        """Take another reference on an allocated or cached page."""
        rc = self._refs.get(page)
        if rc is None:
            raise ValueError(f"share of unallocated page {page}")
        if rc == 0:  # revive from the evictable pool
            del self._cached[page]
        self._refs[page] = rc + 1

    def free(self, pages: List[int], *, cacheable: bool = False) -> None:
        """Drop one reference per page. At refcount 0 a page returns to the
        free list, or parks in the evictable pool when ``cacheable``."""
        for page in pages:
            rc = self._refs.get(page)
            if rc is None or rc < 1:
                raise ValueError(f"double-free or foreign page {page}")
            if rc > 1:
                self._refs[page] = rc - 1
            elif cacheable:
                self._refs[page] = 0
                self._cached[page] = None
            else:
                del self._refs[page]
                self._free.append(page)

    def drop_cached(self, page: int) -> None:
        """Return a cached (refcount-0) page to the free list, notifying
        ``on_evict`` as pressure eviction does: a page freed while a hash
        still named it would hand its next owner's content to strangers."""
        if page in self._cached:
            self._release_cached(page)

    def _evict_one(self) -> None:
        self._release_cached(next(iter(self._cached)))  # oldest

    def _release_cached(self, page: int) -> None:
        del self._cached[page]
        del self._refs[page]
        if self.on_evict is not None:
            self.on_evict(page)
        self._free.append(page)


@dataclasses.dataclass
class Sequence:
    """One request's generation state (host side)."""

    rid: str
    prompt_ids: List[int]
    params: SamplingParams
    output_ids: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    # SLO class: "interactive" or "batch". Scheduling order only: no
    # sequence's own token stream depends on it.
    priority: str = "batch"
    # Prefix caching: leading prompt positions whose KV already sits in
    # shared leading pages (prefill starts there), and how many leading
    # pages are cache-registered (they park in the evictable pool instead
    # of the free list when released).
    prefix_len: int = 0
    cacheable_pages: int = 0
    # Bumped on every preemption: in-flight device results snapshotted
    # under an older epoch must not be appended after re-admission.
    epoch: int = 0
    slot: int = -1
    admitted_at: int = -1  # scheduler tick of (last) admission, for LIFO preempt
    preempt_count: int = 0
    prefilled: bool = False  # KV cache holds this sequence (engine sets it)
    # Disaggregated prefill role: stop after the prompt phase. The first
    # sampled token is discarded, the prompt KV is snapshotted, and the
    # sequence finishes with finish_reason="prefill_done"; the decode side
    # re-samples that token from the same key chain.
    prefill_only: bool = False
    # Wall-clock (time.time()) deadline, or None: the engine's sweep
    # finishes a sequence past it with finish_reason="deadline_exceeded".
    deadline_at: Optional[float] = None
    finish_reason: Optional[str] = None
    finish_text: Optional[str] = None  # pre-truncated text on stop-string hit
    # Incremental detokenization cache for stop strings: ``detok_text`` is
    # the decoded text of ``output_ids[:detok_len]``.
    detok_len: int = 0
    detok_text: str = ""
    # Host-held KV pages awaiting re-insertion (a snapshot.KVRestore), set
    # by swap preemption and insert_request and consumed at admission: the
    # engine writes the pages back instead of re-prefilling. None =
    # re-prefill prompt + output as usual.
    restore: Optional[Any] = None
    # Host-tier prefix promotion: [(page, chain_hash, PrefixEntry), ...]
    # assigned at admission when the host prefix store extends the device
    # match. The engine writes the entries' KV into the listed pages before
    # this sequence's first dispatch and clears the field; prefix_len
    # already counts these positions.
    host_restore: Optional[List[Any]] = None
    # Host-side lifecycle stamps (time.monotonic(); 0.0 = not yet). They
    # feed the queue-wait / TTFT / ITL histograms and the request's trace;
    # they never influence scheduling.
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_prefill_start: float = 0.0
    t_first_token: float = 0.0
    t_last_token: float = 0.0
    t_preempt: float = 0.0

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
    # Sequences sharing full leading prompt pages (position-identical, so
    # RoPE'd K matches) reuse them by refcount instead of recomputing; the
    # engine then prefills from prefix_len on (chunked prefill only).
    enable_prefix_caching: bool = False
    # Interactive waiters are admitted before batch waiters (FIFO within a
    # class). Off = pure FIFO; the engine turns it on at the first
    # interactive request.
    priority_aware: bool = False

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
        # Prefix cache: chain hash of a prompt's leading full page → the
        # page holding that KV, and the reverse map for eviction.
        self._prefix_cache: Dict[bytes, int] = {}
        self._prefix_rev: Dict[int, List[bytes]] = {}
        self.prefix_hits = 0  # pages reused through the cache
        self.prefix_misses = 0  # full prompt pages that had to prefill
        self.allocator.on_evict = self._drop_page_hashes
        # Called as on_preempt(seq, defer_pages) at the top of preempt(),
        # before the epoch bump and page release (swap preemption).
        self.on_preempt: Optional[Callable[[Sequence, bool], None]] = None
        # Host prefix tier hooks (engine-owned; both optional):
        #   on_demote(page, hashes): a cache-registered page is evicted,
        #     its device content still intact; hashes are the chain hashes
        #     that pointed at it (park the KV in host RAM);
        #   host_lookup(hashes): the longest contiguous [(hash, entry), ...]
        #     run the host tier holds for a chain tail the device missed.
        self.on_demote: Optional[Callable[[int, List[bytes]], None]] = None
        self.host_lookup: Optional[Callable[[List[bytes]], List[Any]]] = None
        self._suppress_demote = False  # invalidation must not demote
        # Per-scheduler latency histograms (the owning engine registers
        # them into the process-wide registry for /metrics export).
        self.queue_wait_hist = Histogram(
            "llmq_queue_wait_seconds", "Enqueue-to-first-admission wait per request")
        self.preempt_delay_hist = Histogram(
            "llmq_preemption_delay_seconds",
            "Preemption-to-readmission delay per recompute preemption")

    # --- prefix caching ---------------------------------------------------
    def _prefix_hashes(self, prompt_ids: List[int]) -> List[bytes]:
        """Chain digests of the prompt's leading FULL pages
        (``utils/hashing.py``, byte-identical to the JAX package's)."""
        return token_prefix_chain(prompt_ids, self.config.page_size)

    def _match_prefix_hashes(self, hashes: List[bytes]) -> List[int]:
        """Longest run of cached pages matching the hash chain."""
        matched: List[int] = []
        for h in hashes:
            page = self._prefix_cache.get(h)
            if page is None:
                break
            matched.append(page)
        return matched

    def register_prefix(self, seq: Sequence) -> None:
        """Offer a prefilled sequence's full prompt pages to the cache.
        First writer wins per hash; only the leading pages that ARE the
        cache's pages count as cacheable on release."""
        if not self.config.enable_prefix_caching:
            return
        cacheable = 0
        for i, h in enumerate(self._prefix_hashes(seq.prompt_ids)):
            if i >= len(seq.pages):
                break
            page = self._prefix_cache.get(h)
            if page is None:
                self._prefix_cache[h] = seq.pages[i]
                self._prefix_rev.setdefault(seq.pages[i], []).append(h)
                cacheable = i + 1
            elif page == seq.pages[i]:
                cacheable = i + 1  # re-admission re-matched the same page
            else:
                break  # a different page already serves this chain
        seq.cacheable_pages = cacheable

    def _drop_page_hashes(self, page: int) -> None:
        hashes = [h for h in self._prefix_rev.pop(page, []) if self._prefix_cache.get(h) == page]
        for h in hashes:
            del self._prefix_cache[h]
        # Demote to the host tier while the page's content is intact
        # (on_evict fires before the page reaches the free list), unless an
        # invalidation is running: that content is what must not survive.
        if hashes and self.on_demote is not None and not self._suppress_demote:
            self.on_demote(page, hashes)

    def invalidate_prefix_cache(self) -> None:
        """Forget every cached prefix and return the parked pages to the
        free list: after a failed step the KV content is untrusted, and a
        surviving hash would hand it to future requests. Demotion is
        suppressed throughout, or the host tier would serve it later."""
        self._suppress_demote = True
        try:
            for page in list(self.allocator._cached):
                self.allocator.drop_cached(page)
        finally:
            self._suppress_demote = False
        self._prefix_cache.clear()
        self._prefix_rev.clear()
        for seq in list(self.running.values()) + list(self.waiting):
            seq.cacheable_pages = 0  # nothing may re-park as cached

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

    def add_restored(self, seq: Sequence) -> None:
        """Enqueue a snapshot-restored sequence. Unlike :meth:`add`, the
        prompt is never truncated (the snapshot's KV and key chain cover
        exactly these positions) and the generation cap is re-derived from
        the prompt length alone, so a restored request keeps the budget
        its source engine granted."""
        if seq.num_tokens >= self.config.max_model_len:
            raise ValueError(
                f"restored request {seq.rid!r} holds {seq.num_tokens} tokens; this "
                f"engine's window is {self.config.max_model_len}"
            )
        window = self.config.max_model_len - len(seq.prompt_ids)
        if seq.params.max_tokens > window:
            seq.params.max_tokens = window
        if self._pages_needed(seq.num_tokens) > self.config.num_pages - 1:
            raise ValueError(
                f"restored request {seq.rid!r} of {seq.num_tokens} tokens needs "
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
    def _next_admit_index(self) -> int:
        """The FIFO head, unless the scheduler is priority-aware and an
        interactive sequence waits anywhere: then the oldest interactive
        waiter (a preempted one already sits at the head)."""
        if self.config.priority_aware:
            for i, seq in enumerate(self.waiting):
                if seq.priority == "interactive":
                    return i
        return 0

    def admit(self, max_new: Optional[int] = None) -> List[Sequence]:
        """Move waiting sequences (FIFO, interactive first when
        priority-aware) into free slots while pages allow; each admitted
        sequence needs a prefill (or a restore) before it joins decode."""
        admitted: List[Sequence] = []
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        while self.waiting and free_slots:
            if max_new is not None and len(admitted) >= max_new:
                break
            idx = self._next_admit_index()
            seq = self.waiting[idx]
            matched: List[int] = []
            host: List[Any] = []
            hashes: List[bytes] = []
            if self.config.enable_prefix_caching:
                hashes = self._prefix_hashes(seq.prompt_ids)
                matched = self._match_prefix_hashes(hashes)
                # Share FIRST: matched refcount-0 pages leave the evictable
                # pool, so the fresh alloc below cannot evict them.
                for page in matched:
                    self.allocator.share(page)
                # Extend the device match from the host tier (a snapshot
                # restore brings its own KV: no double restore).
                if self.host_lookup is not None and seq.restore is None:
                    host = self.host_lookup(hashes[len(matched):])
            need = self._pages_needed(seq.num_tokens) - len(matched)
            try:
                fresh = self.allocator.alloc(need) if need > 0 else []
            except OutOfPages:
                for page in matched:  # undo the shares; stay cacheable
                    self.allocator.free([page], cacheable=True)
                break
            seq.pages = matched + fresh
            if host:
                # Promoted pages come out of the fresh allocation (a prompt
                # has at least one more page than its full prefix pages).
                # Their hashes register now: the engine writes the host KV
                # before this sequence's first dispatch, so later admits
                # may share them.
                seq.host_restore = [(page, h, entry)
                                    for page, (h, entry) in zip(fresh[: len(host)], host)]
                for page, h, _ in seq.host_restore:
                    self._prefix_cache[h] = page
                    self._prefix_rev.setdefault(page, []).append(h)
            n_reused = len(matched) + len(host)
            seq.prefix_len = n_reused * self.config.page_size
            # Matched (and promoted) pages are cache-registered by
            # construction: they park back in the evictable pool on release
            # even if this sequence never registers (it finishes early).
            seq.cacheable_pages = n_reused
            self.prefix_hits += n_reused
            self.prefix_misses += len(hashes) - n_reused
            del self.waiting[idx]
            seq.slot = free_slots.pop(0)
            seq.admitted_at = self._tick
            self._tick += 1
            now = time.monotonic()
            if seq.t_preempt > 0.0:  # re-admission after a preemption
                self.preempt_delay_hist.observe(now - seq.t_preempt)
                seq.t_preempt = 0.0
            elif seq.t_enqueue > 0.0 and seq.t_admit == 0.0:
                self.queue_wait_hist.observe(now - seq.t_enqueue)
            seq.t_admit = now
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
        if self.config.priority_aware:
            # Page pressure evicts batch work before interactive work.
            batch = [s for s in candidates if s.priority != "interactive"]
            if batch:
                candidates = batch
        return max(candidates, key=lambda s: s.admitted_at)

    def preempt(
        self, seq: Sequence, *, defer_pages: bool = False
    ) -> Tuple[List[int], int]:
        """Evict a running sequence back to the head of the waiting queue.
        Its generated tokens are kept; re-admission re-prefills
        prompt+output (recompute preemption). With ``defer_pages`` the
        pages are detached and returned, with the count of leading
        cache-registered pages, instead of freed: the engine releases them
        once no in-flight step can still write them. ``on_preempt`` fires
        first, while ``seq`` still holds its pages."""
        if self.on_preempt is not None:
            self.on_preempt(seq, defer_pages)
        seq.epoch += 1  # stale in-flight results must not resurface
        pages, cacheable = self._detach_pages(seq) if defer_pages else ([], 0)
        self._release(seq)
        seq.preempt_count += 1
        seq.t_preempt = time.monotonic()
        self.preemptions += 1
        seq.prefilled = False  # KV is gone; re-admission re-prefills
        self.waiting.appendleft(seq)
        return pages, cacheable

    def finish(
        self, seq: Sequence, reason: str, *, defer_pages: bool = False
    ) -> Tuple[List[int], int]:
        """Finish a sequence; with ``defer_pages`` its pages (and their
        cacheable count) are detached and returned for a later
        :meth:`release_pages`."""
        seq.finish_reason = reason
        pages, cacheable = self._detach_pages(seq) if defer_pages else ([], 0)
        self._release(seq)
        return pages, cacheable

    @staticmethod
    def _detach_pages(seq: Sequence) -> Tuple[List[int], int]:
        pages, cacheable = seq.pages, min(seq.cacheable_pages, len(seq.pages))
        seq.pages, seq.cacheable_pages = [], 0
        return pages, cacheable

    def release_pages(self, pages: List[int], cacheable: int = 0) -> None:
        """Return deferred pages (from ``finish``/``preempt``); the leading
        ``cacheable`` ones park in the evictable prefix pool."""
        if cacheable:
            self.allocator.free(pages[:cacheable], cacheable=True)
        if pages[cacheable:]:
            self.allocator.free(pages[cacheable:])

    def _release(self, seq: Sequence) -> None:
        if seq.slot >= 0:
            self.slots[seq.slot] = None
            seq.slot = -1
        self.running.pop(seq.rid, None)
        if seq.pages:
            self.release_pages(seq.pages, min(seq.cacheable_pages, len(seq.pages)))
            seq.pages = []

    # --- introspection ----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        total_pages = self.config.num_pages - 1
        out = {
            "running": len(self.running),
            "waiting": len(self.waiting),
            "slots": self.config.max_num_seqs,
            "batch_occupancy": len(self.running) / self.config.max_num_seqs,
            "kv_page_utilization": (total_pages - self.allocator.available)
            / max(1, total_pages),
            "preemptions": self.preemptions,
        }
        if self.config.priority_aware:
            out["waiting_interactive"] = sum(s.priority == "interactive" for s in self.waiting)
            out["running_interactive"] = sum(
                s.priority == "interactive" for s in self.running.values()
            )
        out["queue_wait_p50_ms"] = to_ms(self.queue_wait_hist.percentile(0.50))
        out["queue_wait_p95_ms"] = to_ms(self.queue_wait_hist.percentile(0.95))
        out["preemption_delay_p50_ms"] = to_ms(self.preempt_delay_hist.percentile(0.50))
        if self.config.enable_prefix_caching:
            seen = self.prefix_hits + self.prefix_misses
            out["prefix_cache_hit_pages"] = self.prefix_hits
            out["prefix_cache_miss_pages"] = self.prefix_misses
            out["prefix_hit_rate"] = self.prefix_hits / seen if seen else 0.0
        return out

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
        # Pages of finished/preempted sequences awaiting a deferred release
        # still hold their references: a refcount may exceed its owners.
        for page, n in owners.items():
            if self.allocator.refcount(page) < n:
                raise AssertionError(
                    f"page {page}: refcount {self.allocator.refcount(page)} < {n} owners"
                )
        if not self.config.enable_prefix_caching and any(n != 1 for n in owners.values()):
            raise AssertionError("page owned twice")
        in_use = sum(rc > 0 for rc in self.allocator._refs.values())
        if in_use + self.allocator.available != self.config.num_pages - 1:
            raise AssertionError("allocator out of balance")
