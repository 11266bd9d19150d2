"""Content hashing: the prefix cache's page identity, the text chains that
prefix-affinity routing keys on, result digests, and the dedup worker's
n-gram buckets.

Port of ``llmq_tpu/utils/hashing.py`` (``CHAIN_DIGEST_SIZE`` :23,
``stable_bucket`` :26, ``chain_hash`` :33, ``token_prefix_chain`` :51,
``text_prefix_chain`` :71, ``rendezvous_pick`` :97, ``token_fold`` :111).
The page digests are the wire identity of a KV prefix page across a
fleet (the host tier and cross-worker shipping key on them), so they
must stay byte-identical to the JAX package's: blake2b is keyless and
process-stable, unlike Python's salted ``hash()``.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

CHAIN_DIGEST_SIZE = 16


def stable_bucket(text: str, dim: int) -> int:
    """Map ``text`` to a bucket in ``[0, dim)``, stable across processes
    and PYTHONHASHSEED values (the dedup worker's n-gram embedding)."""
    digest = hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "little") % dim


def chain_hash(
    prev: bytes, token_ids: Sequence[int], *, digest_size: int = CHAIN_DIGEST_SIZE
) -> bytes:
    """One link of a token-page hash chain: digest(prev_digest || tokens),
    each token as 8 little-endian signed bytes. Chaining makes a page's
    digest name its content AND its whole left context, so position-
    dependent KV (RoPE'd keys) only matches a prefix computed at the same
    positions over the same tokens."""
    dig = hashlib.blake2b(prev, digest_size=digest_size)
    dig.update(b"".join(int(t).to_bytes(8, "little", signed=True) for t in token_ids))
    return dig.digest()


def token_prefix_chain(token_ids: Sequence[int], page_size: int) -> List[bytes]:
    """Chain digests of a prompt's leading FULL pages, capped at
    ``(len - 1) // page_size`` pages so the final prompt position is always
    recomputed: its logits seed generation, and decode's +1 headroom
    position stays private to the request."""
    n_full = (len(token_ids) - 1) // page_size
    hashes: List[bytes] = []
    h = b""
    for i in range(n_full):
        h = chain_hash(h, token_ids[i * page_size : (i + 1) * page_size])
        hashes.append(h)
    return hashes


def text_prefix_chain(text: str, *, chunk_chars: int = 256, max_chunks: int = 4) -> List[str]:
    """Chain digests (hex) of a prompt's leading text chunks.

    The submit path has no tokenizer, so prefix-affinity routing keys on
    character chunks instead of token pages; workers advertise the same
    digests from the raw job text, so both sides agree without
    tokenizing. Only FULL chunks hash (a partial tail would make "abc" a
    prefix match of nothing), at most ``max_chunks``: routing needs the
    shared head, not the whole prompt."""
    n_full = min(len(text) // chunk_chars, max_chunks)
    chains: List[str] = []
    h = b""
    for i in range(n_full):
        dig = hashlib.blake2b(h, digest_size=CHAIN_DIGEST_SIZE)
        dig.update(text[i * chunk_chars : (i + 1) * chunk_chars].encode("utf-8"))
        h = dig.digest()
        chains.append(h.hex())
    return chains


def rendezvous_pick(digest: str, workers: List[str]) -> str:
    """Deterministic owner among several workers advertising the same
    digest (highest-random-weight hashing): every submitter picks the same
    worker without coordination, and losing one advertiser only remaps the
    chains it owned. Affinity routing and the choice of a peer to fetch
    from or to ship a handoff to all pick through it."""
    return max(workers, key=lambda w: hashlib.blake2b(
        (digest + "|" + w).encode("utf-8"), digest_size=8).digest())


def token_fold(token_ids: Sequence[int]) -> str:
    """blake2b-16 hex over a token-id sequence (4-byte little-endian
    each): the digest a worker stamps on a result under
    ``LLMQ_RESULT_DIGEST``, equal to the JAX package's for the same ids."""
    dig = hashlib.blake2b(digest_size=CHAIN_DIGEST_SIZE)
    for tid in token_ids:
        dig.update(int(tid).to_bytes(4, "little", signed=True))
    return dig.hexdigest()
