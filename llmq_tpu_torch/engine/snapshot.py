"""Host-serializable per-request engine state: the snapshot plane.

The port's copy of ``llmq_tpu/engine/snapshot.py``. A
:class:`RequestSnapshot` captures everything the engine needs to continue
a request exactly where it stopped: the prompt and generated tokens, the
sampling parameters and base key of the sampling-key chain, the
preemption epoch, the detokenizer cache, and, for prefilled requests, the
raw KV pages in their stored dtype. Snapshots are what
``EngineCore.extract_request`` returns and ``EngineCore.insert_request``
consumes, on the same engine (swap-to-host preemption) or another one
(worker handoff), and they cross the two packages in both directions.

KV pages travel as raw bits: a bfloat16 pool's pages are a ``uint16``
array, a float8_e5m2 pool's a ``uint8`` array, an f32 pool's a
``float32`` array, and :attr:`RequestSnapshot.kv_dtype` (or
:attr:`KVRestore.dtype`) names the stored dtype. numpy has no bfloat16 or
float8 type of its own (the JAX package resolves them through
``ml_dtypes``, which the GPU machine does not have); the bits are the
same, so the array directory of the wire form names the stored dtype and
the bytes this codec writes equal the JAX codec's for the same snapshot.

The wire form is versioned and integrity-hashed with a fixed binary
layout (a JSON header plus raw array buffers), never pickle: snapshots
cross process and machine boundaries via the broker.

Layout::

    MAGIC "LLMQSNAP" | u16 LE version | 16-byte blake2b digest |
    u32 LE header length | JSON header {meta, array directory} |
    concatenated raw array buffers

The digest covers everything after itself, so truncation, bit rot and
version tampering surface as :class:`SnapshotIntegrityError` before any
field is trusted.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import hashlib
import json
import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from llmq_tpu_torch.engine.sampling import SamplingParams

MAGIC = b"LLMQSNAP"
#: Magic of the length-prefixed binary wire frame, distinct from the
#: snapshot MAGIC.
WIRE_MAGIC = b"LLMQWIRE"
SNAPSHOT_VERSION = 1
DIGEST_SIZE = 16
_VER_STRUCT = struct.Struct("<H")
_LEN_STRUCT = struct.Struct("<I")

#: stored dtype name -> the numpy dtype its raw bits travel in, and the
#: torch dtype of a pool holding them
_RAW = {
    "float32": (np.dtype(np.float32), torch.float32),
    "bfloat16": (np.dtype(np.uint16), torch.bfloat16),
    "float8_e5m2": (np.dtype(np.uint8), torch.float8_e5m2),
}
_TORCH_NAMES = {t: name for name, (_, t) in _RAW.items()}
#: torch dtype whose view of a pool numpy can hold (same item size)
_TORCH_RAW = {torch.float32: torch.float32, torch.bfloat16: torch.int16,
              torch.float8_e5m2: torch.uint8}


class SnapshotError(ValueError):
    """Base: the blob is not a usable request snapshot."""


class SnapshotIntegrityError(SnapshotError):
    """The blob is truncated or its digest does not match its contents."""


class SnapshotVersionError(SnapshotError):
    """The blob's codec version is newer than this build understands."""


class SnapshotCompatError(SnapshotError):
    """The snapshot is valid but cannot be inserted into THIS engine
    (model signature, KV dtype, or sampling-key chain mismatch)."""


def _dtype_from_name(name: str) -> np.dtype:
    """The numpy dtype a serialized array of dtype ``name`` is read in:
    the raw-bit dtype of a KV dtype, else ``np.dtype(name)``."""
    if name in _RAW:
        return _RAW[name][0]
    try:
        return np.dtype(name)
    except TypeError:
        raise SnapshotError(f"snapshot references unknown dtype {name!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The stored-dtype name of a KV pool dtype, as the JAX package's
    ``str(jnp.dtype(...))`` writes it: ``float32``, ``bfloat16`` or
    ``float8_e5m2``."""
    try:
        return _TORCH_NAMES[dtype]
    except KeyError:
        raise SnapshotError(f"no snapshot dtype for {dtype}") from None


def _raw_buffer(arr: np.ndarray) -> memoryview:
    """The bytes of ``arr`` in C order, without a copy where it is
    contiguous already."""
    return memoryview(np.ascontiguousarray(arr)).cast("B")


def _digest(*parts) -> bytes:
    """The codec's blake2b over ``parts`` in order, as over their
    concatenation, without making it."""
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    for part in parts:
        h.update(part)
    return h.digest()


def pages_to_host(pool: torch.Tensor, idx: torch.Tensor) -> np.ndarray:
    """Gather pages ``idx`` of a ``[L, P, page, H, D]`` pool to the host as
    ``[L, n, page, H, D]`` raw bits (one ``index_select`` and one copy)."""
    raw = pool.view(_TORCH_RAW[pool.dtype]).index_select(1, idx.to(pool.device))
    out = raw.cpu().numpy()
    return out.view(np.uint16) if out.dtype == np.int16 else out


def pages_from_host(pool: torch.Tensor, idx: torch.Tensor, pages: np.ndarray) -> None:
    """Write host raw-bit pages ``[L, n, page, H, D]`` into pages ``idx``
    of ``pool``, in place (``index_copy_`` through a raw view: the pool
    keeps its storage, so graphs captured over it stay valid)."""
    raw_dtype = _TORCH_RAW[pool.dtype]
    host = np.ascontiguousarray(pages)
    if host.dtype == np.uint16:
        host = host.view(np.int16)
    src = torch.from_numpy(host).view(raw_dtype).to(pool.device)
    pool.view(raw_dtype).index_copy_(1, idx.to(pool.device), src)


@dataclasses.dataclass
class KVRestore:
    """Host-side KV pages awaiting scatter back into a device pool.

    ``k``/``v`` are ``[num_layers, n_pages, page_size, num_kv_heads,
    head_dim]`` raw bits of the stored dtype ``dtype``; positions
    ``0..valid-1`` are meaningful, the page tail past ``valid`` is
    don't-care (decode overwrites it before attention reads it)."""

    k: np.ndarray
    v: np.ndarray
    valid: int
    dtype: str = "float32"


@dataclasses.dataclass
class RequestSnapshot:
    """Complete host-side state of one in-flight request. ``kv_k`` /
    ``kv_v`` hold raw bits of the stored dtype ``kv_dtype`` (also in
    ``model_sig["kv_dtype"]``)."""

    rid: str
    model_sig: Dict[str, Any]
    page_size: int
    prompt_ids: List[int]
    output_ids: List[int]
    params: SamplingParams
    key_data: np.ndarray  # uint32 base key of the sampling-key chain
    epoch: int
    preempt_count: int
    detok_len: int
    detok_text: str
    kv_valid: int = 0
    kv_k: Optional[np.ndarray] = None  # [L, n, page, H, D], raw bits
    kv_v: Optional[np.ndarray] = None
    version: int = SNAPSHOT_VERSION
    kv_dtype: str = "float32"

    def to_bytes(self) -> bytes:
        meta = {
            "rid": self.rid,
            "model_sig": self.model_sig,
            "page_size": int(self.page_size),
            "params": dataclasses.asdict(self.params),
            "epoch": int(self.epoch),
            "preempt_count": int(self.preempt_count),
            "detok_len": int(self.detok_len),
            "detok_text": self.detok_text,
            "kv_valid": int(self.kv_valid),
        }
        arrays: List[Tuple[str, np.ndarray, Optional[str]]] = [
            ("prompt_ids", np.asarray(self.prompt_ids, np.int32), None),
            ("output_ids", np.asarray(self.output_ids, np.int32), None),
            ("key_data", np.asarray(self.key_data, np.uint32), None),
        ]
        if self.kv_k is not None and self.kv_v is not None:
            arrays.append(("kv_k", self.kv_k, self.kv_dtype))
            arrays.append(("kv_v", self.kv_v, self.kv_dtype))
        directory = []
        chunks = []
        for key, arr, name in arrays:
            buf = _raw_buffer(arr)
            directory.append(
                {
                    "key": key,
                    "dtype": name or arr.dtype.name,
                    "shape": list(arr.shape),
                    "nbytes": buf.nbytes,
                }
            )
            chunks.append(buf)
        header = json.dumps({"meta": meta, "arrays": directory}, separators=(",", ":")).encode(
            "utf-8"
        )
        ver = _VER_STRUCT.pack(SNAPSHOT_VERSION)
        hlen = _LEN_STRUCT.pack(len(header))
        digest = _digest(ver, hlen, header, *chunks)
        return b"".join([MAGIC, ver, digest, hlen, header, *chunks])

    @classmethod
    def from_bytes(cls, data: bytes) -> "RequestSnapshot":
        prefix = len(MAGIC) + _VER_STRUCT.size + DIGEST_SIZE + _LEN_STRUCT.size
        if len(data) < prefix:
            raise SnapshotIntegrityError(f"snapshot truncated: {len(data)} bytes")
        if data[: len(MAGIC)] != MAGIC:
            raise SnapshotError("not a request snapshot (bad magic)")
        off = len(MAGIC)
        (version,) = _VER_STRUCT.unpack_from(data, off)
        ver_bytes = data[off : off + _VER_STRUCT.size]
        off += _VER_STRUCT.size
        digest = data[off : off + DIGEST_SIZE]
        off += DIGEST_SIZE
        if version > SNAPSHOT_VERSION:
            raise SnapshotVersionError(
                f"snapshot version {version} is newer than supported {SNAPSHOT_VERSION}"
            )
        if digest != _digest(ver_bytes, memoryview(data)[off:]):
            raise SnapshotIntegrityError("snapshot digest mismatch")
        (hlen,) = _LEN_STRUCT.unpack_from(data, off)
        off += _LEN_STRUCT.size
        if off + hlen > len(data):
            raise SnapshotIntegrityError("snapshot header overruns blob")
        try:
            header = json.loads(data[off : off + hlen].decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise SnapshotIntegrityError(f"snapshot header unparseable: {exc}") from None
        off += hlen
        arrays: Dict[str, np.ndarray] = {}
        names: Dict[str, str] = {}
        for entry in header.get("arrays", ()):
            dtype = _dtype_from_name(entry["dtype"])
            nbytes = int(entry["nbytes"])
            if off + nbytes > len(data):
                raise SnapshotIntegrityError(f"snapshot array {entry['key']!r} overruns blob")
            arr = np.frombuffer(data, dtype=dtype, count=nbytes // dtype.itemsize, offset=off)
            arrays[entry["key"]] = arr.reshape(entry["shape"]).copy()
            names[entry["key"]] = entry["dtype"]
            off += nbytes
        meta = header["meta"]
        pd = dict(meta["params"])
        pd["stop"] = tuple(pd.get("stop") or ())
        pd["stop_token_ids"] = tuple(pd.get("stop_token_ids") or ())
        known = {f.name for f in dataclasses.fields(SamplingParams)}
        params = SamplingParams(**{k: v for k, v in pd.items() if k in known})
        model_sig = dict(meta["model_sig"])
        return cls(
            rid=meta["rid"],
            model_sig=model_sig,
            page_size=int(meta["page_size"]),
            prompt_ids=[int(t) for t in arrays["prompt_ids"]],
            output_ids=[int(t) for t in arrays["output_ids"]],
            params=params,
            key_data=arrays["key_data"],
            epoch=int(meta["epoch"]),
            preempt_count=int(meta["preempt_count"]),
            detok_len=int(meta["detok_len"]),
            detok_text=meta["detok_text"],
            kv_valid=int(meta["kv_valid"]),
            kv_k=arrays.get("kv_k"),
            kv_v=arrays.get("kv_v"),
            version=version,
            kv_dtype=names.get("kv_k", str(model_sig.get("kv_dtype", "float32"))),
        )


def snapshot_to_b64(snap: RequestSnapshot) -> str:
    return base64.b64encode(snap.to_bytes()).decode("ascii")


def snapshot_from_b64(data: str) -> RequestSnapshot:
    try:
        raw = base64.b64decode(data.encode("ascii"), validate=True)
    except (binascii.Error, ValueError) as exc:
        raise SnapshotError(f"snapshot base64 undecodable: {exc}") from None
    return RequestSnapshot.from_bytes(raw)


# --- transport wire frames ------------------------------------------------
#
# A snapshot crosses the broker hop as b64 (a string that embeds in JSON
# bodies; what the worker publishes) or as a binary frame (WIRE_MAGIC |
# u32 LE length | raw snapshot bytes), which the JAX package's encoder
# writes under ``LLMQ_WIRE_FORMAT=binary``. The decoder sniffs either.
# The binary encoder comes with the first transport that publishes bytes,
# the pipeline-stage tensor frames with M13 (ROADMAP.md).


def snapshot_from_wire(data: Union[str, bytes, bytearray, memoryview]) -> RequestSnapshot:
    """Decode either wire encoding (sniffed, never configured)."""
    if isinstance(data, str):
        return snapshot_from_b64(data)
    raw = bytes(data)
    if raw[: len(WIRE_MAGIC)] == WIRE_MAGIC:
        off = len(WIRE_MAGIC)
        if len(raw) < off + _LEN_STRUCT.size:
            raise SnapshotIntegrityError(f"wire frame truncated: {len(raw)} bytes")
        (n,) = _LEN_STRUCT.unpack_from(raw, off)
        off += _LEN_STRUCT.size
        if off + n > len(raw):
            raise SnapshotIntegrityError(
                f"wire frame body truncated: {n} declared, {len(raw) - off} present"
            )
        return RequestSnapshot.from_bytes(raw[off : off + n])
    return RequestSnapshot.from_bytes(raw)


def repack_pages(kv: np.ndarray, valid: int, dst_page_size: int, dst_pages: int) -> np.ndarray:
    """Re-tile ``[L, n_src, src_page, H, D]`` KV pages for a pool with a
    different page size. Only positions ``0..valid-1`` carry data; the
    destination tail is zero-filled don't-care."""
    layers, _, _, heads, dim = kv.shape
    if valid > dst_pages * dst_page_size:
        raise SnapshotCompatError(
            f"{valid} KV positions do not fit {dst_pages} pages of {dst_page_size}"
        )
    flat = np.ascontiguousarray(kv).reshape(layers, -1, heads, dim)[:, :valid]
    out = np.zeros((layers, dst_pages * dst_page_size, heads, dim), dtype=kv.dtype)
    out[:, :valid] = flat
    return out.reshape(layers, dst_pages, dst_page_size, heads, dim)


def pages_for(valid: int, page_size: int) -> int:
    """Pages required to hold ``valid`` KV positions."""
    return -(-valid // page_size) if valid > 0 else 0
