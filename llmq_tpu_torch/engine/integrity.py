"""Numerics-integrity primitives: weight digests, KV spot checks, canaries
(port of ``llmq_tpu/engine/integrity.py``).

- :func:`digest_params` folds every parameter leaf's stored bytes into a
  position-salted ``(xor, sum)`` pair of uint32 on the device: two reads of
  an intact buffer always agree, so a baseline-vs-now mismatch names the
  corrupted leaf. Leaf names are JAX's ``keystr`` paths of the same tree
  (``['layers']['q_proj']['q']``), and the values equal the JAX fold's,
  leaf for leaf, on a bridged tree (``models/convert.py`` keeps its bits).
- :func:`diff_digests` names the leaves whose digest changed.
- :func:`page_digests`: blake2b-16 over each gathered KV page (host bytes).
- :func:`token_fold`: blake2b-16 over token ids (``utils/hashing.py``).

The fold in torch: torch has no xor reduction, and a whole tree widened
at once does not fit beside it, so each leaf is folded in chunks of
``FOLD_CHUNK`` bytes widened to int64: each byte xor its salt ``(index *
2654435761) mod 2**32``, the chunk's index offset by its start; xor
lanes reduce by halving, sum lanes mod 2**32, so chunks compose.
Plain torch, on the parameters' device.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from llmq_tpu_torch.utils.hashing import token_fold

#: Digest width of the host-side blake2b folds (snapshot.py's wire digest).
DIGEST_SIZE = 16

#: Knuth's multiplicative-hash constant: salts each byte with its flat index
#: so transpositions, which plain xor / sum folds cannot see, change it.
SALT = 2654435761
_MASK = 0xFFFFFFFF

#: Bytes of a leaf folded at a time (int64 lanes: 8x this while folding).
FOLD_CHUNK = 1 << 24


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(keystr path, tensor)`` of every leaf of a nested dict, in JAX's
    flattening order (sorted keys)."""
    for key in sorted(tree):
        path = f"{prefix}[{key!r}]"
        node = tree[key]
        if isinstance(node, dict):
            yield from named_leaves(node, path)
        else:
            yield path, node


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of a 1-D integer tensor's elements, as a 1-element tensor."""
    while x.numel() > 1:
        h = x.numel() // 2
        y = x[:h] ^ x[h: 2 * h]
        if x.numel() % 2:
            y[:1] ^= x[2 * h:]
        x = y
    return x


def fold_leaf(t: torch.Tensor) -> torch.Tensor:
    """One leaf's stored bytes folded into int64 ``[xor, sum]`` (each < 2**32)."""
    t = t.detach()
    flat = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous().reshape(-1)
    if flat.dtype != torch.uint8:
        flat = flat.view(torch.uint8)
    acc_x = torch.zeros(1, dtype=torch.int64, device=t.device)
    acc_s = torch.zeros(1, dtype=torch.int64, device=t.device)
    for lo in range(0, flat.numel(), FOLD_CHUNK):
        b = flat[lo: lo + FOLD_CHUNK].to(torch.int64)
        salt = torch.arange(b.numel(), dtype=torch.int64, device=t.device)
        salt.mul_(SALT).add_((lo * SALT) & _MASK).bitwise_and_(_MASK)
        b.bitwise_xor_(salt)
        acc_s = (acc_s + b.sum()) & _MASK
        acc_x ^= _xor_reduce(b)
    return torch.cat([acc_x, acc_s])


def digest_params(params) -> Dict[str, Tuple[int, int]]:
    """``{keystr path: (xor, sum)}`` of every leaf of a parameter tree (a
    nested dict of tensors), folded on the leaves' device; one host
    transfer for the whole tree."""
    leaves = list(named_leaves(params))
    if not leaves:
        return {}
    folds = torch.stack([fold_leaf(t) for _, t in leaves]).cpu().tolist()
    return {name: (int(x), int(s)) for (name, _), (x, s) in zip(leaves, folds)}


def diff_digests(baseline: Dict[str, Tuple[int, int]],
                 current: Dict[str, Tuple[int, int]]) -> List[str]:
    """Leaf paths whose digest changed (or appeared / vanished) since
    ``baseline``; empty means a clean audit."""
    changed = [path for path, val in current.items() if baseline.get(path) != val]
    changed.extend(path for path in baseline if path not in current)
    return sorted(set(changed))


def page_digests(pages: np.ndarray) -> List[str]:
    """blake2b-16 hex digest of each leading-axis page of a host array."""
    arr = np.ascontiguousarray(pages)
    return [hashlib.blake2b(arr[i].tobytes(), digest_size=DIGEST_SIZE).hexdigest()
            for i in range(arr.shape[0])]


__all__ = ["DIGEST_SIZE", "digest_params", "diff_digests", "page_digests", "token_fold"]
