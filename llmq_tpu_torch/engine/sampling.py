"""Token sampling: batched, per-slot parameters, on the device.

Port of ``llmq_tpu/engine/sampling.py`` (:29-197). ``sample_tokens`` keeps
the three variants — ``greedy`` (argmax), ``stochastic`` (Gumbel-max, no
sort) and ``filtered`` (one descending vocab sort, per-slot top-k / top-p
rank masks, Gumbel argmax, un-sorted back) — and takes the Gumbel noise
as an argument, so a test can feed the JAX sampler and this one the same
noise.

Noise source. JAX derives per-slot noise from threefry keys,
``fold_in(base_key, step)``. The port keeps the invariant that matters
(noise is a pure function of the slot's base key, its step counter and
the vocab index, computed on the device, so run-ahead steps need no host
RNG state), but with a counter-based integer hash (splitmix64 finalizer)
in torch int64 arithmetic. Seeded streams are reproducible within the
port and differ from the JAX package's (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling configuration (reference default temp 0.7)."""

    temperature: float = 0.7
    top_p: float = 1.0
    top_k: int = 0  # 0 disables top-k
    max_tokens: int = 8192
    min_tokens: int = 0  # suppress EOS/stop until this many tokens emitted
    stop: Tuple[str, ...] = ()
    stop_token_ids: Tuple[int, ...] = ()
    seed: Optional[int] = None
    ignore_eos: bool = False

    @classmethod
    def from_job_extras(
        cls, extras: dict, *, default_max_tokens: int
    ) -> "SamplingParams":
        """Per-job overrides from Job extra fields (``extra="allow"``)."""

        def _tuple(value) -> Tuple[str, ...]:
            if value is None:
                return ()
            if isinstance(value, str):
                return (value,)
            return tuple(value)

        return cls(
            temperature=float(extras.get("temperature", 0.7)),
            top_p=float(extras.get("top_p", 1.0)),
            top_k=int(extras.get("top_k", 0)),
            max_tokens=int(extras.get("max_tokens", default_max_tokens)),
            min_tokens=int(extras.get("min_tokens", 0)),
            stop=_tuple(extras.get("stop")),
            stop_token_ids=tuple(int(t) for t in _tuple(extras.get("stop_token_ids"))),
            seed=(int(extras["seed"]) if extras.get("seed") is not None else None),
            ignore_eos=bool(extras.get("ignore_eos", False)),
        )


def required_mode(params: SamplingParams) -> str:
    """Cheapest sampler variant able to serve this request exactly."""
    if params.temperature <= 0.0:
        return "greedy"
    if params.top_k <= 0 and params.top_p >= 1.0:
        return "stochastic"
    return "filtered"


_MODE_ORDER = ("greedy", "stochastic", "filtered")


def join_modes(modes) -> str:
    """The cheapest variant exact for every request in the batch."""
    best = 0
    for m in modes:
        best = max(best, _MODE_ORDER.index(m))
    return _MODE_ORDER[best]


def sample_tokens(
    logits: torch.Tensor,  # [S, V] float32
    gumbel: Optional[torch.Tensor],  # [S, V] float32 noise (None for greedy)
    temperature: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S] int32, 0 = off
    top_p: torch.Tensor,  # [S] float32, 1.0 = off
    *,
    mode: str = "filtered",
) -> torch.Tensor:
    """Sample one token per slot (int64 [S]); temperature <= 0 is greedy.
    Greedy lanes inside a stochastic/filtered batch are handled by the
    final ``where``."""
    S, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    if mode == "greedy":
        return greedy

    safe_temp = temperature.clamp(min=1e-6)[:, None]
    scaled = logits / safe_temp

    if mode == "stochastic":
        sampled = torch.argmax(scaled + gumbel, dim=-1)
        return torch.where(temperature <= 0.0, greedy, sampled)

    # Descending sort once (stable, as jnp.argsort); filters are rank masks.
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.take_along_dim(scaled, sort_idx, dim=-1)
    ranks = torch.arange(V, device=logits.device)[None, :]

    k = torch.where(top_k > 0, top_k, V)[:, None]
    keep = ranks < k
    # top-p: keep entries whose PRECEDING cumulative mass is < p (rank 0
    # always survives).
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep = keep & (cum_before < top_p[:, None])

    masked = torch.where(keep, sorted_logits, NEG_INF)
    # Noise is drawn in token space and permuted through the same sort, so
    # an unfiltered slot samples exactly as in `stochastic` mode.
    gumbel_sorted = torch.take_along_dim(gumbel, sort_idx, dim=-1)
    choice_rank = torch.argmax(masked + gumbel_sorted, dim=-1)
    sampled = torch.take_along_dim(sort_idx, choice_rank[:, None], dim=-1)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled)


# --- device-side noise -----------------------------------------------------


def _s64(c: int) -> int:
    """A 64-bit constant as the signed value torch int64 arithmetic takes."""
    return c - (1 << 64) if c >= (1 << 63) else c


_GOLDEN = _s64(0x9E3779B97F4A7C15)
_MIX1 = _s64(0xBF58476D1CE4E5B9)
_MIX2 = _s64(0x94D049BB133111EB)


def _lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's >> is arithmetic)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (wrapping int64 arithmetic)."""
    x = x ^ _lsr(x, 30)
    x = x * _MIX1
    x = x ^ _lsr(x, 27)
    x = x * _MIX2
    return x ^ _lsr(x, 31)


def step_gumbel(keys: torch.Tensor, steps: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise [S, vocab] (f32), a pure function of each slot's base
    key (int64), its step counter and the vocab index — the port's
    counterpart of ``fold_in(base_key, step)`` + ``jax.random.gumbel``."""
    row = _mix64(keys.long() * _GOLDEN + steps.long())
    idx = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    bits = _lsr(_mix64(row[:, None] + idx[None, :] * _GOLDEN), 41)  # 23 bits
    u = (bits.float() + 0.5) * (1.0 / (1 << 23))  # exact, in (0, 1)
    return -torch.log(-torch.log(u))


def make_base_key(seed: Optional[int], request_tag: int) -> int:
    """A request's base key, computed once at admission: the seed when the
    request is seeded (reproducible), else derived from a stable tag of
    the request id, so a preempted request continues its own stream."""
    return (seed if seed is not None else 0x5EED ^ request_tag) & ((1 << 63) - 1)


def request_tag(rid: str) -> int:
    """Stable integer stream tag for an unseeded request id."""
    return zlib.crc32(rid.encode("utf-8", "surrogatepass"))
