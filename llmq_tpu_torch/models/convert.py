"""Parameter bridge: a numpy parameter tree → the port's torch tree.

The tree is the JAX reference's ``init_params`` layout (``embed``,
``final_norm``, optional ``lm_head``, and ``layers`` whose leaves are
stacked ``[L, ...]``) with every leaf converted to a numpy array (for a
JAX tree: ``jax.tree.map(np.asarray, params)``). Conversion is bit-exact:
a bfloat16 or float8_e5m2 leaf (numpy's ``ml_dtypes`` extension types,
which torch cannot read directly) travels as its raw bit patterns; the
int8 and uint8 leaves of a quantized tree (``models/quant.py``) are
plain numpy integers. A quantized leaf is a nested dict like any other.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

# ml_dtypes name -> (numpy integer of its width, torch dtype)
_BIT_TYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(
    arr: np.ndarray, device: Union[str, torch.device] = "cpu"
) -> torch.Tensor:
    """One array → a tensor with the same bits (bfloat16 and float8_e5m2
    included)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name in _BIT_TYPES:
        bits, dtype = _BIT_TYPES[arr.dtype.name]
        t = torch.from_numpy(arr.view(bits).copy()).view(dtype)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_numpy(
    tree: Mapping[str, Any],
    *,
    device: Union[str, torch.device] = "cpu",
    dtype: Optional[torch.dtype] = None,
) -> dict:
    """Convert a (nested) dict of numpy arrays to torch tensors on
    ``device``; ``dtype`` optionally casts every floating leaf after the
    bit-exact transfer."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = params_from_numpy(leaf, device=device, dtype=dtype)
            continue
        t = tensor_from_numpy(np.asarray(leaf), device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t
    return out
