"""Token sampling: batched, per-slot parameters, on the device.

Port of ``llmq_tpu/engine/sampling.py`` (:29-290). ``sample_tokens`` keeps
the three variants — ``greedy`` (argmax), ``stochastic`` (Gumbel-max, no
sort) and ``filtered`` (one descending vocab sort, per-slot top-k / top-p
rank masks, Gumbel argmax, un-sorted back) — and takes the Gumbel noise
as an argument, so a test can feed the JAX sampler and this one the same
noise. ``spec_verify_tokens`` is the speculative verify sampler (greedy
acceptance, or rejection sampling against the point-mass draft), which
draws its own noise from the key chain as JAX's does.

Noise source. As in JAX, per-slot noise is ``jax.random.gumbel`` under
the threefry key ``fold_in(base_key, step)``: the port carries
threefry2x32 (``jax._src.prng``, the partitionable bit layout that
``jax_threefry_partitionable=True`` selects) over in torch int64
arithmetic masked to 32 bits. A slot's base key is the two-word key data
JAX makes for its seed (``make_base_key``), so seeded requests draw the
same tokens on both backends. Noise is a pure function of (base key,
step counter, vocab index) computed on the device, so run-ahead steps
need no host RNG state.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np
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


# --- device-side noise: threefry2x32, as jax.random ----------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of ``jax._src.prng``,
    on int64 tensors holding uint32 values; the arguments broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_step_keys(keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(base_key, step)`` per slot: keys [S, 2] (uint32
    values in int64) and steps [S] → the step keys [S, 2]."""
    keys = keys.long()
    k0, k1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(keys[:, 0]),
                          steps.long() & _M32)
    return torch.stack((k0, k1), dim=1)


def uniform_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per row of ``keys`` [S, 2]:
    the partitionable layout hashes the counter pair (0, i) and XORs the
    two output words. Returns int64 [S, n]."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(idx), idx)
    return y0 ^ y1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """23 random mantissa bits of each uint32 (int64) word as a float in
    [0, 1), JAX's arithmetic."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``
    per row of ``keys`` [S, 2], bit for bit: 23 random mantissa bits make
    a float in [0, 1), lifted to [tiny, 1) with JAX's own arithmetic."""
    floats = _unit_floats(uniform_bits(keys, n))
    # JAX computes floats * (maxval - minval) + minval; in f32 the span
    # 1 - tiny rounds to 1.0, so the product is exact and drops out.
    return torch.clamp_min(floats + _F32_TINY, _F32_TINY)


def split_keys(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)`` per row of ``keys`` [S, 2]: the
    partitionable layout hashes the counter pair (0, i) into key i.
    Returns [S, n, 2]."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    k0, k1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(idx), idx)
    return torch.stack((k0, k1), dim=2)


def uniform_unit(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, ())`` (f32 in [0, 1)) per row of ``keys``
    [S, 2], bit for bit."""
    return _unit_floats(uniform_bits(keys, 1)[:, 0])


def gumbel(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise [S, vocab] (f32): ``jax.random.gumbel(key, (vocab,),
    float32)`` per row of ``keys`` [S, 2], in its default ("low") mode,
    ``-log(-log(u))`` of the uniform draw above. The logs run in f64 and
    round once to f32: the draw is then within an f32 ulp of JAX's and
    the same on every call (torch's f32 log on the CPU was seen to differ
    from call to call in its last bits)."""
    u = uniform(keys, vocab).double()
    return (-torch.log(-torch.log(u))).float()


def step_gumbel(keys: torch.Tensor, steps: torch.Tensor, vocab: int) -> torch.Tensor:
    """:func:`gumbel` under the step keys ``fold_in(key, step)``: a
    decode step's noise [S, vocab]."""
    return gumbel(fold_step_keys(keys, steps), vocab)


def spec_verify_tokens(
    logits: torch.Tensor,  # [S, Q, V] float32 — Q = spec_tokens + 1 positions
    drafts: torch.Tensor,  # [S, Q-1] int — proposed tokens (-1 = no draft)
    keys: torch.Tensor,  # [S, 2] base key data (uint32 values in int64)
    steps: torch.Tensor,  # [S] int32 — generation step at position 0
    temperature: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S] int32, 0 = off
    top_p: torch.Tensor,  # [S] float32, 1.0 = off
    *,
    mode: str = "filtered",
) -> torch.Tensor:
    """The token the model emits at each of Q candidate positions ([S, Q],
    int64), assuming every earlier draft was accepted; the engine's
    accepted run is the prefix where ``emit[:, i] == drafts[:, i]``.
    ``greedy``: the argmax per position, so an accepted run is the
    non-speculative engine's tokens. Sampled: accept draft d with
    probability p(d) under the row's filtered distribution, else sample
    the residual (p with d removed); per position the key
    ``fold_in(base, step + i)`` is split into an accept uniform and a
    resample Gumbel, as in JAX (``llmq_tpu/engine/sampling.py:200``)."""
    S, Q, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    if mode == "greedy":
        return greedy

    R = S * Q
    flat = logits.reshape(R, V)
    pos = torch.arange(Q, dtype=steps.dtype, device=logits.device)
    steps_q = (steps[:, None] + pos[None, :]).reshape(R)
    safe_temp = temperature.repeat_interleave(Q).clamp(min=1e-6)[:, None]
    scaled = flat / safe_temp

    if mode == "filtered":
        # sample_tokens' filters, scattered back to token space: rejection
        # sampling needs the filtered distribution itself.
        topk_q = top_k.repeat_interleave(Q)
        topp_q = top_p.repeat_interleave(Q)
        sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
        sorted_logits = torch.take_along_dim(scaled, sort_idx, dim=-1)
        ranks = torch.arange(V, device=logits.device)[None, :]
        keep = ranks < torch.where(topk_q > 0, topk_q, V)[:, None]
        probs_sorted = torch.softmax(sorted_logits, dim=-1)
        cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
        keep = keep & (cum_before < topp_q[:, None])
        keep_tok = torch.zeros_like(keep).scatter_(1, sort_idx, keep)
        masked = torch.where(keep_tok, scaled, NEG_INF)
    else:
        masked = scaled

    # Drafts with a -1 sentinel at the bonus position: p(d) = 0 there, so
    # the reject branch is a plain sample from p.
    d = torch.cat([drafts.long(), torch.full((S, 1), -1, dtype=torch.long,
                                             device=logits.device)], dim=1).reshape(R)
    pairs = split_keys(fold_step_keys(keys.repeat_interleave(Q, dim=0), steps_q), 2)
    u = uniform_unit(pairs[:, 0])
    noise = gumbel(pairs[:, 1], V)

    probs = torch.softmax(masked, dim=-1)
    p_d = torch.take_along_dim(probs, d.clamp(0, V - 1)[:, None], dim=-1)[:, 0]
    p_d = torch.where(d >= 0, p_d, 0.0)
    accept = u < p_d
    # The residual of a point-mass draft: d's logit dropped (no draft:
    # nothing dropped).
    drop = torch.zeros((R, V + 1), dtype=torch.bool, device=logits.device)
    drop.scatter_(1, torch.where(d >= 0, d, V)[:, None], True)
    residual = torch.where(drop[:, :V], NEG_INF, masked)
    resample = torch.argmax(residual + noise, dim=-1)
    emit = torch.where(accept, d, resample).reshape(S, Q)
    return torch.where((temperature <= 0.0)[:, None], greedy, emit)


def make_base_key(seed: Optional[int], request_tag: int) -> np.ndarray:
    """A request's base key data (uint32[2]), computed once at admission:
    what ``jax.random.key_data(jax.random.key(seed))`` gives with JAX's
    default 32-bit integers — the seed wraps to 32 bits, so the high word
    is 0 and the low word is ``seed mod 2**32``. Seeded requests are
    reproducible; unseeded ones derive from a stable tag of the request
    id, so a preempted request continues its own stream."""
    eff = seed if seed is not None else 0x5EED ^ request_tag
    if not -(1 << 63) <= eff < (1 << 63):
        raise OverflowError(f"seed {eff} does not fit in 64 bits")
    return np.array([0, eff & _M32], dtype=np.uint32)


def request_tag(rid: str) -> int:
    """Stable integer stream tag for an unseeded request id."""
    return zlib.crc32(rid.encode("utf-8", "surrogatepass"))
