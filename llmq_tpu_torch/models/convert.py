"""Parameter bridge: a numpy parameter tree → the port's torch tree.

The tree is the JAX reference's ``init_params`` layout (``embed``,
``final_norm``, optional ``lm_head``, and ``layers`` whose leaves are
stacked ``[L, ...]``) with every leaf converted to a numpy array (for a
JAX tree: ``jax.tree.map(np.asarray, params)``). Conversion is bit-exact:
a bfloat16 leaf (numpy's ``ml_dtypes`` extension type, which torch cannot
read directly) travels as its raw 16-bit patterns.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch


def tensor_from_numpy(
    arr: np.ndarray, device: Union[str, torch.device] = "cpu"
) -> torch.Tensor:
    """One array → a tensor with the same bits (bfloat16 included)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
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
