"""Host-RAM cold tier of the content-addressed prefix cache.

The port's copy of ``llmq_tpu/engine/prefix_store.py``. The scheduler's
device prefix cache lets concurrent requests share leading prompt pages by
refcount; its capacity is whatever refcount-0 pages survive in the device
pool. This module is the next tier down: when a cached page is evicted
from the pool, its KV bytes park in host RAM keyed by the page's chain
digest (``utils/hashing.token_prefix_chain``, the bytes the scheduler keys
on), and a later request whose prompt walks the same chain gets the page
written back into the pool instead of prefilled again. The tier is a
byte-budgeted LRU (``LLMQ_PREFIX_HOST_GB``).

Pages are held in the pool's stored dtype as raw bits, as the snapshot
codec carries them (``engine/snapshot.py``): an f32 pool's pages as
``float32``, a bfloat16 pool's as ``uint16``, a float8_e5m2 pool's as
``uint8``. No dequantize round trip, so a promoted page is the evicted
page bit for bit, and numpy needs no ``ml_dtypes``.

Entries are also the unit of cross-engine page shipping: the chunk wire
form below (the snapshot codec's layout: MAGIC | version | blake2b digest
| JSON header | raw buffers, never pickle) serializes one (digest -> K/V
page) pair. Its header names the stored dtype as ``ml_dtypes`` does
(``float32``, ``bfloat16``, ``float8_e5m2``), so a chunk's bytes equal the
JAX package's for the same page, digest included, and chunks cross the
two packages in both directions.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import json
import struct
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from llmq_tpu_torch.engine.snapshot import (
    SnapshotCompatError,
    SnapshotError,
    SnapshotIntegrityError,
    SnapshotVersionError,
    _digest,
    _dtype_from_name,
    _raw_buffer,
)

CHUNK_MAGIC = b"LLMQPFXC"
CHUNK_VERSION = 1
_DIGEST_SIZE = 16
_VER_STRUCT = struct.Struct("<H")
_LEN_STRUCT = struct.Struct("<I")

#: numpy dtype of a page's raw bits -> the stored dtype it carries
_STORED_NAME = {np.dtype(np.float32): "float32", np.dtype(np.uint16): "bfloat16",
                np.dtype(np.uint8): "float8_e5m2"}


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix page: K and V as ``[L, 1, page_size, H, D]`` raw
    bits of the pool's stored dtype, keyed by the page's chain digest
    (which names the page's content and its whole left context)."""

    key: bytes
    k: np.ndarray
    v: np.ndarray
    hits: int = 0

    @property
    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes


class PrefixStore:
    """Byte-budgeted LRU of host-resident prefix pages.

    The engine thread demotes, looks up and promotes; the host-memory
    governor's evictor (``evict_bytes``) runs on whichever thread charges
    the shared budget, such as the worker's event loop when it accounts a
    handoff blob. So every method takes the store's lock. (The reference
    store has no lock and is exposed to the same race, ROADMAP.md queue 3
    item 8.)
    """

    def __init__(
        self,
        budget_bytes: int,
        *,
        page_size: int,
        model_sig: Optional[Dict[str, Any]] = None,
    ) -> None:
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes={budget_bytes} (want > 0)")
        self.budget_bytes = int(budget_bytes)
        self.page_size = int(page_size)
        self.model_sig = dict(model_sig or {})
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()
        # Counters (the owning engine exports them through stats()).
        self.inserts = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def occupancy_bytes(self) -> int:
        return self._bytes

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._entries

    def put(self, key: bytes, k: np.ndarray, v: np.ndarray) -> bool:
        """Park a demoted page, refreshing its LRU position on re-insert
        (same digest chain, same content). Returns False when the blob
        alone exceeds the whole budget (nothing is evicted for it)."""
        with self._lock:
            existing = self._entries.pop(key, None)
            if existing is not None:
                self._bytes -= existing.nbytes
            entry = PrefixEntry(
                key=key,
                k=np.ascontiguousarray(k),
                v=np.ascontiguousarray(v),
                hits=existing.hits if existing is not None else 0,
            )
            if entry.nbytes > self.budget_bytes:
                return False
            while self._bytes + entry.nbytes > self.budget_bytes:
                self._evict_one()
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self.inserts += 1
            return True

    def _evict_one(self) -> None:
        _, entry = self._entries.popitem(last=False)  # oldest
        self._bytes -= entry.nbytes
        self.evictions += 1

    def evict_bytes(self, nbytes: int) -> int:
        """Drop the oldest entries until ``nbytes`` are freed or the store
        is empty; returns the bytes freed (the host-memory governor's
        evictor, ``utils/host_mem.py``)."""
        with self._lock:
            freed = 0
            while freed < nbytes and self._entries:
                before = self._bytes
                self._evict_one()
                freed += before - self._bytes
            return freed

    def get(self, key: bytes) -> Optional[PrefixEntry]:
        """Look up one page by digest, refreshing its LRU position."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            entry.hits += 1
            self.hits += 1
            return entry

    def match_chain(self, hashes: Sequence[bytes]) -> List[Tuple[bytes, PrefixEntry]]:
        """Longest contiguous run of stored pages along a hash chain,
        starting at ``hashes[0]``. Contiguity is mandatory: promoting page
        i without page i-1 resident would leave a KV hole that attention
        reads as garbage."""
        with self._lock:
            run: List[Tuple[bytes, PrefixEntry]] = []
            for h in hashes:
                entry = self.get(h)
                if entry is None:
                    break
                run.append((h, entry))
            return run

    def invalidate(self) -> None:
        """Drop every entry: required whenever the device content the
        entries were gathered from can no longer be trusted (an abort)."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def hot_chains(self, n: int = 8) -> List[str]:
        """Hex digests of the most-hit entries."""
        with self._lock:
            ranked = sorted(self._entries.values(), key=lambda e: e.hits, reverse=True)
            return [e.key.hex() for e in ranked[:n]]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "prefix_host_entries": len(self._entries),
                "prefix_host_bytes": self._bytes,
                "prefix_host_budget_bytes": self.budget_bytes,
                "prefix_host_inserts": self.inserts,
                "prefix_host_hits": self.hits,
                "prefix_host_misses": self.misses,
                "prefix_host_evictions": self.evictions,
            }


# --- chunk wire form --------------------------------------------------------


def chunk_to_bytes(
    key: bytes,
    k: np.ndarray,
    v: np.ndarray,
    *,
    model_sig: Dict[str, Any],
    page_size: int,
) -> bytes:
    """Serialize one prefix page (raw bits, see the module docstring) for
    cross-engine shipping: versioned, digest-covered, a JSON header and
    the raw buffers, never pickle."""
    try:
        name = _STORED_NAME[k.dtype]
    except KeyError:
        raise SnapshotError(f"no stored KV dtype travels as {k.dtype}") from None
    meta = {
        "key": key.hex(),
        "model_sig": dict(model_sig),
        "page_size": int(page_size),
        "dtype": name,
        "shape": list(k.shape),
    }
    header = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    body = [_raw_buffer(k), _raw_buffer(v)]
    ver = _VER_STRUCT.pack(CHUNK_VERSION)
    hlen = _LEN_STRUCT.pack(len(header))
    digest = _digest(ver, hlen, header, *body)
    return b"".join([CHUNK_MAGIC, ver, digest, hlen, header, *body])


def chunk_from_bytes(data: bytes) -> Tuple[bytes, np.ndarray, np.ndarray, Dict[str, Any], int]:
    """Parse a shipped prefix page: (key, k, v, model_sig, page_size), the
    pages as raw bits of the header's stored dtype. Raises
    SnapshotIntegrityError / SnapshotVersionError / SnapshotError on a
    truncated, tampered or foreign blob."""
    prefix = len(CHUNK_MAGIC) + _VER_STRUCT.size + _DIGEST_SIZE + _LEN_STRUCT.size
    if len(data) < prefix:
        raise SnapshotIntegrityError(f"prefix chunk truncated: {len(data)} bytes")
    if data[: len(CHUNK_MAGIC)] != CHUNK_MAGIC:
        raise SnapshotError("not a prefix chunk (bad magic)")
    off = len(CHUNK_MAGIC)
    (version,) = _VER_STRUCT.unpack_from(data, off)
    ver_bytes = data[off : off + _VER_STRUCT.size]
    off += _VER_STRUCT.size
    digest = data[off : off + _DIGEST_SIZE]
    off += _DIGEST_SIZE
    if version > CHUNK_VERSION:
        raise SnapshotVersionError(
            f"prefix chunk version {version} is newer than supported {CHUNK_VERSION}"
        )
    if digest != _digest(ver_bytes, memoryview(data)[off:]):
        raise SnapshotIntegrityError("prefix chunk digest mismatch")
    (hlen,) = _LEN_STRUCT.unpack_from(data, off)
    off += _LEN_STRUCT.size
    if off + hlen > len(data):
        raise SnapshotIntegrityError("prefix chunk header overruns blob")
    try:
        meta = json.loads(data[off : off + hlen].decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise SnapshotIntegrityError(f"prefix chunk header unparseable: {exc}") from None
    off += hlen
    try:
        key = bytes.fromhex(meta["key"])
        dtype = _dtype_from_name(meta["dtype"])
        shape = tuple(int(d) for d in meta["shape"])
        page_size = int(meta["page_size"])
        model_sig = dict(meta["model_sig"])
    except (KeyError, TypeError, ValueError) as exc:
        raise SnapshotError(f"prefix chunk header malformed: {exc}") from None
    count = int(np.prod(shape)) if shape else 0
    nbytes = count * dtype.itemsize
    if off + 2 * nbytes > len(data):
        raise SnapshotIntegrityError("prefix chunk arrays overrun blob")
    k = np.frombuffer(data, dtype=dtype, count=count, offset=off)
    off += nbytes
    v = np.frombuffer(data, dtype=dtype, count=count, offset=off)
    return key, k.reshape(shape).copy(), v.reshape(shape).copy(), model_sig, page_size


def chunk_to_b64(blob: bytes) -> str:
    return base64.b64encode(blob).decode("ascii")


def chunk_from_b64(data: str) -> bytes:
    try:
        return base64.b64decode(data.encode("ascii"), validate=True)
    except (binascii.Error, ValueError) as exc:
        raise SnapshotError(f"prefix chunk base64 undecodable: {exc}") from None


def check_chunk_compat(
    model_sig: Dict[str, Any],
    page_size: int,
    *,
    want_sig: Dict[str, Any],
    want_page_size: int,
) -> None:
    """Raise SnapshotCompatError unless a shipped chunk matches this
    engine's shape contract. The page size must match exactly: the chain
    digests depend on it, so a mismatched chunk could never match a local
    chain (this catches a misconfigured fleet loudly)."""
    if dict(model_sig) != dict(want_sig):
        raise SnapshotCompatError(
            f"prefix chunk model signature {model_sig} does not match engine {want_sig}"
        )
    if int(page_size) != int(want_page_size):
        raise SnapshotCompatError(
            f"prefix chunk page size {page_size} does not match engine {want_page_size}"
        )
