"""llmq_tpu_torch — the PyTorch/CUDA port of ``llmq_tpu``.

The JAX package ``llmq_tpu`` stays the reference; this package grows
beside it, module for module under the same names, and imports nothing
from it. Its kernels are hand-written CUDA C++ for Hopper (``ops/csrc``),
built with ``nvcc`` at first use; on CPU tensors ``ops/dispatch.py`` runs
each kernel's plain PyTorch version instead. Importing the package
imports no torch, so the client commands (``submit``, ``receive``,
``status``, ...) start without it, as the reference's client starts
without JAX.
"""

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]


def __getattr__(name: str):
    if name == "resolve_device":
        from llmq_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'llmq_tpu_torch' has no attribute {name!r}")
