"""Decode-type dispatches of the engine as captured CUDA graphs.

The JAX engine dispatches each decode step, fused decode block, verify
block and mixed block as one jitted executable
(``llmq_tpu/engine/engine.py:1840-1851``, ``:2382-2385``); the port's
counterpart of that executable is one ``torch.cuda.CUDAGraph``, replayed
with one host call. :class:`DispatchGraphs` keeps one graph per key (the
engine keys them by dispatch kind, sampling mode, stop suppression and
iterations, so the small interactive block is a graph of its own)
over the engine's static buffers: the decode state, the KV pools and the
mixed step's inputs, all written in place, so a replay reads what the
host last put there. Nothing here runs on the CPU, where the engine
dispatches eagerly.

Before its capture a graph's work runs once eagerly on inactive copies of
the state (``warm``): that builds and loads the kernels, makes cuBLAS's
and the wrappers' cached buffers (K1's split counters), and writes only
the scratch page. Those launches are real and are counted. The capture
itself launches nothing, so the kernel launch counters
(``ops/_build.count_launch``) are put back after it, and the launches
counted while capturing are added again on every replay. A capture or a
replay that fails raises; there is no eager fallback.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from llmq_tpu_torch.ops import _build


@dataclasses.dataclass
class _Captured:
    graph: Any  # torch.cuda.CUDAGraph
    outputs: Any  # the tensors the captured work returned (static)
    launches: Dict[Any, Tuple[int, ...]]  # counters a replay adds
    steps: int  # decode iterations a replay runs


class DispatchGraphs:
    """One captured graph per key, on ``device``'s graph memory pool."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._graphs: Dict[Hashable, _Captured] = {}
        self._pool: Optional[Any] = None
        self.captures = 0
        self.replays = 0
        # Decode iterations run eagerly before captures, by key[0] (the kind).
        self.warmup_steps: Dict[Hashable, int] = {}
        # Host seconds spent in warm-ups and captures (launches are
        # asynchronous: the host's cost, not the device's).
        self.capture_s = 0.0

    def __len__(self) -> int:
        return len(self._graphs)

    def iterations(self) -> List[int]:
        """The decode iterations of the captured graphs, each count once."""
        return sorted({entry.steps for entry in self._graphs.values()})

    def reset(self) -> None:
        """Drop every graph: a static buffer changed shape or identity, so
        the next dispatch of each key captures anew."""
        self._graphs.clear()
        self._pool = None

    def run(self, key: Hashable, fn: Callable[[], Any], warm: Callable[[], Any],
            steps: int) -> Any:
        """Replay ``key``'s graph, capturing ``fn`` first if there is none
        (after one eager ``warm`` run of ``steps`` decode iterations on
        inactive copies of its inputs, counted under ``key[0]``). Returns
        the graph's outputs."""
        entry = self._graphs.get(key)
        if entry is None:
            t0 = time.perf_counter()
            warm()
            self.warmup_steps[key[0]] = self.warmup_steps.get(key[0], 0) + steps
            entry = self._graphs[key] = self._capture(fn, steps)
            self.capture_s += time.perf_counter() - t0
        entry.graph.replay()
        _build.set_launch_counts(entry.launches, add=True)
        self.replays += 1
        return entry.outputs

    def _capture(self, fn: Callable[[], Any], steps: int) -> _Captured:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        zero = (0,) * len(_build.COUNTERS)
        before = _build.launch_counts()
        # No cyclic collection while capturing: one that frees another,
        # unreachable graph (an engine dropped earlier) resets it inside
        # this capture, which CUDA refuses and which invalidates the
        # capture. torch.cuda.graph collects before the capture begins.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                graph, pool=self._pool, capture_error_mode="thread_local"
            ):
                outputs = fn()
            after = _build.launch_counts()
        finally:  # the capture launched nothing: put the counters back
            if collecting:
                gc.enable()
            _build.set_launch_counts({w: before.get(w, zero) for w in _build.launch_counts()})
        launches = {w: tuple(a - b for a, b in zip(n, before.get(w, zero)))
                    for w, n in after.items()}
        self.captures += 1
        return _Captured(graph, outputs, launches, steps)
