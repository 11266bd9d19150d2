"""Build and load the port's CUDA kernels.

Each source in ``ops/csrc`` is compiled by its own ``nvcc`` process into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), all processes started together, into ``build/kernels``
at the repository root (git-ignored). A library's file name carries a
digest of its source, the headers in ``ops/csrc`` and the flags, so an
edited source or header rebuilds and an unchanged one is reused.
Libraries are loaded with ``ctypes``; the wrappers in
``ops/cuda_attention.py`` and ``ops/cuda_matmul.py`` declare their
signatures.

Nothing here runs at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "paged_decode_tc": "paged_decode_tc.cu",
    "flash_prefill": "flash_prefill.cu",
    "flash_prefill_tc": "flash_prefill_tc.cu",
    "paged_prefill": "paged_prefill.cu",
    "paged_prefill_tc": "paged_prefill_tc.cu",
    "paged_decode_v2": "paged_decode_v2.cu",
    "int8_matmul": "int8_matmul.cu",
    "int8_matmul_tc": "int8_matmul_tc.cu",
    "int4_matmul": "int4_matmul.cu",
    "int4_matmul_tc": "int4_matmul_tc.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
]

#: name → the compiler's output for the last build in this process
#: (ptxas lines included), for logs.
build_logs: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` per source, in parallel. Returns name → library path;
    raises with the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        build_logs[name] = output
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[name]} (exit {proc.returncode})\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building every kernel source on
    the first call (so one launch builds them all at once)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(str(p))
            lib = _libs[name]
        return lib


_fns: Dict[Tuple[str, str], Any] = {}  # (library, symbol) -> entry point
_errs: Dict[str, Any] = {}  # library -> its llmq_cuda_error_string
_sms: Dict[Optional[int], int] = {}


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of library ``name``, with its ctypes
    signature; it returns a ``cudaError_t`` code (0 = success)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        lib = load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = lib.llmq_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[(name, symbol)] = fn
        _errs[name] = err
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch in library ``name`` returned a CUDA error."""
    if code != 0:
        msg = _errs[name](code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


#: the launch counters of a wrapper, in :func:`launch_counts`' order
COUNTERS = ("launches", "tensor_core_launches", "exact_launches")
_counted: Dict[Any, None] = {}  # every wrapper count_launch has seen


def count_launch(wrapper, route: str) -> None:
    """One launch of a two-route kernel ``wrapper`` on ``route``
    (``"tensor_core"`` or ``"exact"``): its ``launches`` and that route's
    counter go up by one."""
    _counted[wrapper] = None
    wrapper.launches += 1
    if route == "tensor_core":
        wrapper.tensor_core_launches += 1
    else:
        wrapper.exact_launches += 1


def launch_counts() -> Dict[Any, Tuple[int, ...]]:
    """Each counted wrapper's :data:`COUNTERS` now."""
    return {w: tuple(getattr(w, c) for c in COUNTERS) for w in _counted}


def kernel_launches() -> Dict[str, Dict[str, int]]:
    """Each kernel this process launched, by its wrapper's name: its
    ``launches`` and their split by route (``tensor_core``, ``exact``)."""
    return {w.__name__: dict(zip(("launches", "tensor_core", "exact"), counts))
            for w, counts in launch_counts().items() if counts[0]}


def set_launch_counts(counts: Dict[Any, Tuple[int, ...]], add: bool = False) -> None:
    """Set (or, with ``add``, add to) the wrappers' :data:`COUNTERS`. A
    captured CUDA graph counts its kernels at capture and adds them on
    each replay, where no wrapper runs (``engine/graphs.py``)."""
    for wrapper, values in counts.items():
        _counted[wrapper] = None
        for name, n in zip(COUNTERS, values):
            setattr(wrapper, name, (getattr(wrapper, name) if add else 0) + n)


def split_count(units: int, target: int, max_splits: int) -> int:
    """Runs of whole ``units`` (key tiles, k-tiles) to cut a loop into:
    as many as ``target`` and ``max_splits`` allow, never more (an SM's
    blocks share it, so one SM holding an extra block sets the time), all
    of one length but the last, none empty."""
    if units <= 0:
        return 1
    per = -(-units // max(1, min(target, max_splits, units)))
    return -(-units // per)


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (cached)."""
    import torch

    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n
