"""Device resolution for every entry point of the port.

The port runs on the card unless the caller asks for the CPU: an entry
point's ``device=`` defaults to ``"cuda"``, and a missing CUDA runtime is
an error, never a silent fall back to the host. Tests pass ``"cpu"``
explicitly, which routes every kernel call to its plain PyTorch version
(``ops/dispatch.py`` chooses by the device of the tensors it gets).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device={str(device)!r} (want 'cuda[:i]' or 'cpu')")
    return dev
