"""Build and load the port's CUDA kernels.

Each source in ``ops/csrc`` is compiled by its own ``nvcc`` process into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), all processes started together, into ``build/kernels``
at the repository root (git-ignored). A library's file name carries a
digest of its source and flags, so an edited source rebuilds and an
unchanged one is reused. Libraries are loaded with ``ctypes``; the
wrappers in ``ops/cuda_attention.py`` declare their signatures.

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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "flash_prefill": "flash_prefill.cu",
    "paged_prefill": "paged_prefill.cu",
    "paged_decode_v2": "paged_decode_v2.cu",
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
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
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
