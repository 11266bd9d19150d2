"""llmq_tpu_torch — the PyTorch/CUDA port of ``llmq_tpu``.

The JAX package ``llmq_tpu`` stays the reference; this package grows
beside it, module for module under the same names, and imports nothing
from it. Its kernels are hand-written CUDA C++ for Hopper (``ops/csrc``),
built with ``nvcc`` at first use; on CPU tensors ``ops/dispatch.py`` runs
each kernel's plain PyTorch version instead.
"""

from llmq_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
