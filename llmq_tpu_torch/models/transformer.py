"""Decoder-only transformer over a paged KV cache, in PyTorch.

Port of ``llmq_tpu/models/transformer.py`` (building blocks :100-176,
the mixture-of-experts MLP ``_moe_mlp`` :231, ``Transformer`` :340-824
with ``_paged_chunk_trunk`` :569, ``prefill_chunk`` :628, ``mixed`` :663
and ``verify`` :710, ``init_params`` :840 with its int8/int4
quantization, ``make_kv_pages`` :946).
Same parameter tree (per-layer weights stacked on a leading ``[L, ...]``
axis, ``[in, out]`` matmul layout, expert stacks ``[L, E, in, out]``),
same family switches (Qwen2 QKV bias, Qwen3 qk-norm, Gemma-2 softcaps /
post-norms / alternating sliding window / ``1 + w`` RMSNorm / scaled
embeddings, llama3 RoPE scaling, qwen2_moe / qwen3_moe sparse experts),
same arithmetic order.

PyTorch idiom in place of JAX's:

- :class:`Transformer` is an ``nn.Module`` that owns the weights as
  frozen parameters; the layer loop is a Python loop over views of the
  stacked tensors (``w[li]`` never copies). A quantized leaf
  (``models/quant.py``) is stored as one flat parameter per part
  (``q_proj__q``, ``q_proj__scale``, ...) and handed to the layer body as
  the JAX package's dict again.
- Every product goes through ``quant.matmul`` as in JAX; whether a 2-D
  quantized weight takes its kernel (K6 / K7) is resolved once, when the
  module is built (``LLMQ_INT8_MATMUL`` / ``LLMQ_INT4_MATMUL``).
- The KV pools ``[L, P, page, n_kv, d]`` are updated IN PLACE by
  ``prefill``/``decode`` (the JAX functions return new pools).
- RoPE angles and the KV write index are computed once per forward and
  shared by all layers (JAX recomputes them per scanned layer; the values
  are identical).
- The decode kernel (``LLMQ_DECODE_KERNEL``) is resolved once, when the
  module is built: the counterpart of the JAX trace-time resolution.
- The MoE MLP has two forms of the expert products (:func:`_moe_mlp`):
  grouped, as JAX's ``ragged_dot``, for the prefill paths (which read the
  group sizes on the host), and sync-free for the decode-type dispatches
  (``decode``, ``verify``, ``mixed``), which the engine captures as CUDA
  graphs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from llmq_tpu_torch.models import quant as qm
from llmq_tpu_torch.models.config import ModelConfig
from llmq_tpu_torch.ops import attention as attn_ops
from llmq_tpu_torch.ops import dispatch as attn_dispatch

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, *, one_plus: bool = False
) -> torch.Tensor:
    """RMSNorm in f32 accumulation. Gemma uses ``x * (1 + w)``."""
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    out = x32 * (1.0 + w) if one_plus else x32 * w
    return out.to(dtype)


def compute_rope_inv_freq(
    config: ModelConfig, device: Optional[torch.device] = None
) -> torch.Tensor:
    """Inverse RoPE frequencies [head_dim/2] (f32), with llama3-style or
    linear scaling."""
    d = config.head_dim_
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv_freq = 1.0 / torch.pow(torch.tensor(config.rope_theta, dtype=torch.float32), exponent)
    scaling = config.rope_scaling or {}
    rope_type = scaling.get("rope_type", scaling.get("type"))
    if rope_type == "llama3":
        factor = scaling.get("factor", 8.0)
        low_factor = scaling.get("low_freq_factor", 1.0)
        high_factor = scaling.get("high_freq_factor", 4.0)
        original_ctx = scaling.get("original_max_position_embeddings", 8192)
        low_freq_wavelen = original_ctx / low_factor
        high_freq_wavelen = original_ctx / high_factor
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (original_ctx / wavelen - low_factor) / (high_factor - low_factor)
        smoothed = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_freq_wavelen,
            scaled,
            torch.where(wavelen < high_freq_wavelen, inv_freq, smoothed),
        )
    elif rope_type == "linear":
        inv_freq = inv_freq / scaling.get("factor", 1.0)
    return inv_freq


def rope_cos_sin(
    positions: torch.Tensor, inv_freq: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of the RoPE angles, [..., T, 1, d/2] f32."""
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # [..., T, n, d]
    positions: torch.Tensor,  # [..., T]
    inv_freq: torch.Tensor,  # [d/2]
) -> torch.Tensor:
    """Rotate-half RoPE; positions may be -1 (padding) — harmless garbage."""
    return _rotate(x, *rope_cos_sin(positions, inv_freq))


def _activate(gate: torch.Tensor, up: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu_tanh":
        return F.gelu(gate, approximate="tanh") * up
    return F.silu(gate) * up


def _mlp(h: torch.Tensor, lp: Params, activation: str, kernels) -> torch.Tensor:
    gate = qm.matmul(h, lp["gate_proj"], kernels)
    up = qm.matmul(h, lp["up_proj"], kernels)
    return qm.matmul(_activate(gate, up, activation), lp["down_proj"], kernels)


def moe_route(x: torch.Tensor, router: torch.Tensor, config: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing weights and experts ``[N, k]`` of each row of ``x`` [N, H]:
    router logits in f32, a softmax over all experts, the top k, renormed
    when ``norm_topk_prob``. The top k are the first k of a stable
    descending sort, so a tie goes to the lower expert id, as
    ``jax.lax.top_k`` resolves it (``torch.topk`` promises no order)."""
    probs = torch.softmax((x @ router).float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = config.num_experts_per_tok
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    if config.norm_topk_prob:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_w, top_e


def _ragged_dot(xs: torch.Tensor, w: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    """``jax.lax.ragged_dot``: rows ``xs`` [M, K] grouped by expert in
    order (``sizes`` rows each) times their expert's ``w[e]`` [K, N]."""
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    lo = 0
    for e, n in enumerate(sizes):
        if n:
            torch.mm(xs[lo:lo + n], w[e], out=out[lo:lo + n])
            lo += n
    return out


def _moe_grouped(x: torch.Tensor, top_e: torch.Tensor, lp: Params, activation: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert products in JAX's grouped form: the N*k (row, expert)
    assignments stably sorted by expert, each expert's group one product.
    The group sizes are read on the host, so this form cannot sit in a
    captured graph. Returns each row's k expert outputs ``[N, k, H]`` in
    ascending expert order, and the index of each into the flat
    ``top_e`` (to pick the weights)."""
    N, k = top_e.shape
    E = lp["router"].shape[-1]
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    xs = x[order // k]
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    gate = _ragged_dot(xs, qm.dequantize(lp["expert_gate_proj"], x.dtype), sizes)
    up = _ragged_dot(xs, qm.dequantize(lp["expert_up_proj"], x.dtype), sizes)
    down = _ragged_dot(_activate(gate, up, activation),
                       qm.dequantize(lp["expert_down_proj"], x.dtype), sizes)
    # Each row's sorted positions; a row's picks are distinct experts, so
    # ascending position is ascending expert id.
    pos = torch.argsort(order).reshape(N, k).sort(dim=-1).values
    return down[pos], order[pos]


def _moe_sync_free(x: torch.Tensor, top_e: torch.Tensor, lp: Params, activation: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert products with no host read, for the captured graphs:
    every expert over every row (``[E, N, *]`` batched products, E/k times
    the grouped form's work), then each row's k outputs picked in
    ascending expert order. Returns what :func:`_moe_grouped` returns."""
    N, k = top_e.shape
    E = lp["router"].shape[-1]
    xe = x.expand(E, *x.shape)
    gate = torch.bmm(xe, qm.dequantize(lp["expert_gate_proj"], x.dtype))
    up = torch.bmm(xe, qm.dequantize(lp["expert_up_proj"], x.dtype))
    down = torch.bmm(_activate(gate, up, activation),
                     qm.dequantize(lp["expert_down_proj"], x.dtype))
    experts, pick = top_e.sort(dim=-1)
    rows = torch.arange(N, device=x.device)[:, None]
    return down[experts, rows], rows * k + pick


def moe_transient_bytes(config: ModelConfig, dtype: torch.dtype, rows: int,
                        quantized: bool) -> int:
    """Device bytes one layer's MoE MLP allocates beyond the weights, for
    a dispatch of ``rows`` rows in the sync-free form: the dequantized
    expert stacks (quantized weights only; all three counted live) and
    the ``[E, rows, *]`` operands and products. 0 for a dense config."""
    if not config.num_experts:
        return 0
    E, H, Im = config.num_experts, config.hidden_size, config.moe_intermediate_size
    item = torch.empty((), dtype=dtype).element_size()
    stacks = 3 * E * H * Im * item if quantized else 0
    return stacks + E * rows * (2 * H + 3 * Im) * item


def _moe_mlp(h: torch.Tensor, lp: Params, config: ModelConfig, kernels,
             sync_free: bool) -> torch.Tensor:
    """Sparse mixture-of-experts MLP (qwen2_moe / qwen3_moe; JAX
    ``_moe_mlp`` :231): route, the expert products (``sync_free`` picks
    the form), each row's k outputs weighted and summed in ascending
    expert order (the order in which JAX's ``segment_sum`` meets them,
    and no atomics, so a captured and an eager run agree), plus qwen2_moe's
    shared expert through :func:`_mlp` blended by a sigmoid gate.
    Quantized expert stacks are dequantized for the layer, as in JAX."""
    *lead, H = h.shape
    x = h.reshape(-1, H)
    top_w, top_e = moe_route(x, lp["router"], config)
    products = _moe_sync_free if sync_free else _moe_grouped
    down, flat = products(x, top_e, lp, config.activation)
    contrib = down * top_w.reshape(-1)[flat].to(down.dtype)[..., None]
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    out = out.to(h.dtype)
    if config.shared_expert_intermediate_size:
        shared = _mlp(x, {"gate_proj": lp["shared_gate_proj"], "up_proj": lp["shared_up_proj"],
                          "down_proj": lp["shared_down_proj"]}, config.activation, kernels)
        out = out + torch.sigmoid(x @ lp["shared_expert_gate"]) * shared
    return out.reshape(*lead, H)


_PART = "__"  # flat parameter name of a quantized leaf's part: name__q


def _flatten(tree: Params) -> Dict[str, torch.Tensor]:
    """A tree level's leaves by flat name (quantized parts as name__part)."""
    flat: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if qm.is_quantized(leaf):
            flat.update({f"{name}{_PART}{part}": t for part, t in leaf.items()})
        else:
            flat[name] = leaf
    return flat


def _unflatten(flat, index: Optional[int] = None) -> Params:
    """Inverse of :func:`_flatten`, optionally viewing leading index
    ``index`` of every tensor."""
    out: Params = {}
    for key, t in flat.items():
        if index is not None:
            t = t[index]
        name, sep, part = key.partition(_PART)
        if sep:
            out.setdefault(name, {})[part] = t
        else:
            out[name] = t
    return out


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """``prefill`` and ``decode`` over a layer-stacked paged KV cache.

    ``params`` is the parameter tree of :func:`init_params` (or of
    ``models.convert.params_from_numpy``); the module keeps its tensors as
    frozen parameters, so ``.to(device)`` moves them."""

    def __init__(self, config: ModelConfig, params: Params) -> None:
        super().__init__()
        self.config = config

        def frozen(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t, requires_grad=False)

        top = {k: params[k] for k in ("embed", "final_norm", "lm_head") if k in params}
        self.top = nn.ParameterDict({n: frozen(t) for n, t in _flatten(top).items()})
        self.layers = nn.ParameterDict(
            {n: frozen(t) for n, t in _flatten(params["layers"]).items()}
        )
        self.one_plus = config.model_type.startswith("gemma")
        disabled = config.max_position_embeddings + 1
        self.windows: List[int] = [
            config.sliding_window if config.layer_uses_sliding_window(i) else disabled
            for i in range(config.num_layers)
        ]
        self._inv_freq_cache: Dict[torch.device, torch.Tensor] = {}
        self.decode_kernel = attn_dispatch.resolve_decode_kernel()
        self.quant_kernels = attn_dispatch.resolve_quant_matmul()

    def _inv_freq(self, device: torch.device) -> torch.Tensor:
        inv = self._inv_freq_cache.get(device)
        if inv is None:
            inv = self._inv_freq_cache[device] = compute_rope_inv_freq(self.config, device)
        return inv

    def layer_params(self, li: int) -> Params:
        """Layer ``li``'s weights: views into the stacked tensors."""
        return _unflatten(self.layers, li)

    def top_params(self) -> Params:
        """``embed``, ``final_norm`` and an untied ``lm_head``."""
        return _unflatten(self.top)

    # --- shared layer body -------------------------------------------------
    def _qkv(
        self, lp: Params, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.config
        d = cfg.head_dim_
        *lead, _ = h.shape
        q = qm.matmul(h, lp["q_proj"], self.quant_kernels)
        k = qm.matmul(h, lp["k_proj"], self.quant_kernels)
        v = qm.matmul(h, lp["v_proj"], self.quant_kernels)
        if cfg.attention_bias:
            q = q + lp["q_bias"]
            k = k + lp["k_bias"]
            v = v + lp["v_bias"]
        q = q.reshape(*lead, cfg.num_heads, d)
        k = k.reshape(*lead, cfg.num_kv_heads, d)
        v = v.reshape(*lead, cfg.num_kv_heads, d)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
        return _rotate(q, cos, sin), _rotate(k, cos, sin), v

    def _finish_layer(
        self, lp: Params, h: torch.Tensor, attn_out: torch.Tensor, sync_free: bool
    ) -> torch.Tensor:
        """o_proj, the residual and the MLP; ``sync_free`` (the captured
        dispatches) picks the MoE products' form."""
        cfg = self.config
        *lead, _, _ = attn_out.shape
        attn_proj = qm.matmul(attn_out.reshape(*lead, cfg.num_heads * cfg.head_dim_),
                              lp["o_proj"], self.quant_kernels)
        if cfg.post_norms:
            attn_proj = rms_norm(
                attn_proj, lp["post_attn_norm"], cfg.rms_norm_eps, one_plus=self.one_plus
            )
        h = h + attn_proj
        mlp_in = rms_norm(h, lp["ln2"], cfg.rms_norm_eps, one_plus=self.one_plus)
        if cfg.num_experts:
            mlp_out = _moe_mlp(mlp_in, lp, cfg, self.quant_kernels, sync_free)
        else:
            mlp_out = _mlp(mlp_in, lp, cfg.activation, self.quant_kernels)
        if cfg.post_norms:
            mlp_out = rms_norm(
                mlp_out, lp["post_mlp_norm"], cfg.rms_norm_eps, one_plus=self.one_plus
            )
        return h + mlp_out

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        h = qm.embed_lookup(self.top_params()["embed"], tokens)
        if self.config.scale_embeddings:
            # sqrt(hidden) rounded to the weight dtype first, as in JAX.
            h = h * torch.tensor(math.sqrt(self.config.hidden_size), dtype=h.dtype)
        return h

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        top = self.top_params()
        h = rms_norm(h, top["final_norm"], cfg.rms_norm_eps, one_plus=self.one_plus)
        if "lm_head" in top:
            logits = qm.matmul(h, top["lm_head"], self.quant_kernels).float()
        else:
            logits = qm.tied_head_matmul(h, top["embed"]).float()
        if cfg.logit_softcap is not None:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits

    # --- prefill -----------------------------------------------------------
    @torch.no_grad()
    def prefill(
        self,
        tokens: torch.Tensor,  # [B, T] right-padded prompt bucket
        lengths: torch.Tensor,  # [B] int32 true prompt lengths
        k_pages: torch.Tensor,  # [L, P, page, n_kv, d] — written in place
        v_pages: torch.Tensor,
        block_tables: torch.Tensor,  # [B, pages_per_seq] int32
    ) -> torch.Tensor:
        """Full-prompt forward: writes the prompt's K/V into the pages and
        returns the last valid position's logits [B, V] (f32)."""
        cfg = self.config
        B, T = tokens.shape
        dev = tokens.device
        pos_grid = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, T)
        positions = torch.where(pos_grid < lengths[:, None], pos_grid, -1)
        cos, sin = rope_cos_sin(positions, self._inv_freq(dev))
        h = self._embed(tokens)
        page_aligned = T % k_pages.shape[2] == 0
        index = None if page_aligned else attn_ops.kv_write_index(
            block_tables, positions, k_pages.shape[2]
        )
        for li in range(cfg.num_layers):
            lp = self.layer_params(li)
            x = rms_norm(h, lp["ln1"], cfg.rms_norm_eps, one_plus=self.one_plus)
            q, k, v = self._qkv(lp, x, cos, sin)
            if page_aligned:
                attn_ops.write_prompt_kv_pages(k_pages, v_pages, k, v, block_tables, li)
            else:
                attn_ops.write_kv_pages(
                    k_pages, v_pages, k, v, block_tables, positions, li, index=index
                )
            attn_out = attn_dispatch.prefill_attention(
                q, k, v, scale=cfg.attn_scale, lengths=lengths,
                sliding_window=self.windows[li], softcap=cfg.attn_softcap,
            )
            h = self._finish_layer(lp, h, attn_out, sync_free=False)
        last_idx = (lengths.long() - 1).clamp(min=0)
        last_h = h[torch.arange(B, device=dev), last_idx]
        return self._logits(last_h)

    # --- chunked prefill ---------------------------------------------------
    def _paged_chunk_trunk(
        self,
        tokens: torch.Tensor,  # [B, C] query tokens (padding rows arbitrary)
        positions: torch.Tensor,  # [B, C] absolute positions (−1 = padding)
        k_pages: torch.Tensor,  # [L, P, page, n_kv, d] — written in place
        v_pages: torch.Tensor,
        block_tables: torch.Tensor,  # [B, pages_per_seq] int32
        sync_free: bool,
    ) -> torch.Tensor:
        """Write-then-attend over every layer: store each row's valid
        positions' K/V in the paged cache, attend every query against
        everything cached so far (causal, K3 on the card), run the MLP.
        Returns the hidden grid [B, C, H]. Each row's positions must be a
        leading contiguous run (``ops/dispatch.chunked_prefill_attention``).
        ``sync_free``: the callers captured as graphs (``mixed``,
        ``verify``)."""
        cfg = self.config
        cos, sin = rope_cos_sin(positions, self._inv_freq(tokens.device))
        h = self._embed(tokens)
        index = attn_ops.kv_write_index(block_tables, positions, k_pages.shape[2])
        for li in range(cfg.num_layers):
            lp = self.layer_params(li)
            x = rms_norm(h, lp["ln1"], cfg.rms_norm_eps, one_plus=self.one_plus)
            q, k, v = self._qkv(lp, x, cos, sin)
            attn_ops.write_kv_pages(
                k_pages, v_pages, k, v, block_tables, positions, li, index=index
            )
            attn_out = attn_dispatch.chunked_prefill_attention(
                q, k_pages, v_pages, block_tables, positions, scale=cfg.attn_scale,
                layer=li, sliding_window=self.windows[li], softcap=cfg.attn_softcap,
            )
            h = self._finish_layer(lp, h, attn_out, sync_free)
        return h

    @torch.no_grad()
    def prefill_chunk(
        self,
        tokens: torch.Tensor,  # [B, C] one chunk of prompt tokens
        positions: torch.Tensor,  # [B, C] absolute positions (−1 = padding)
        k_pages: torch.Tensor,  # [L, P, page, n_kv, d] — written in place
        v_pages: torch.Tensor,
        block_tables: torch.Tensor,  # [B, pages_per_seq] int32
        last_in_chunk: torch.Tensor,  # [B] index of each row's last valid position
    ) -> torch.Tensor:
        """One fixed-size chunk of prompt positions through all layers:
        writes the chunk's K/V and attends each query against everything
        cached so far (earlier chunks and prefix-cache pages included).
        Returns the logits [B, V] (f32) at each row's ``last_in_chunk``
        position, meaningful on a row's final chunk."""
        h = self._paged_chunk_trunk(tokens, positions, k_pages, v_pages, block_tables, False)
        B = tokens.shape[0]
        last_h = h[torch.arange(B, device=h.device), last_in_chunk.long()]
        return self._logits(last_h)

    # --- fused mixed prefill+decode ----------------------------------------
    @torch.no_grad()
    def mixed(
        self,
        tokens: torch.Tensor,  # [S, C] combined query grid (ops.attention.mixed_query_grid)
        positions: torch.Tensor,  # [S, C] absolute positions (−1 = padding)
        k_pages: torch.Tensor,  # [L, P, page, n_kv, d] — written in place
        v_pages: torch.Tensor,
        block_tables: torch.Tensor,  # [S, pages_per_seq] int32
        gather_idx: torch.Tensor,  # [S] the grid column whose logits each row returns
    ) -> torch.Tensor:
        """One mixed step: each decode row scores its one position (column
        0) while one pending prompt's segment rides in its own row, all
        through the chunk trunk (K3 on the card). Returns logits [S, V]
        (f32) at each row's ``gather_idx`` column."""
        h = self._paged_chunk_trunk(tokens, positions, k_pages, v_pages, block_tables, True)
        S = tokens.shape[0]
        return self._logits(h[torch.arange(S, device=h.device), gather_idx.long()])

    # --- speculative verify ------------------------------------------------
    @torch.no_grad()
    def verify(
        self,
        tokens: torch.Tensor,  # [S, Q] current token + draft candidates
        positions: torch.Tensor,  # [S, Q] absolute positions (−1 = inactive)
        k_pages: torch.Tensor,  # [L, P, page, n_kv, d] — written in place
        v_pages: torch.Tensor,
        block_tables: torch.Tensor,  # [S, pages_per_seq] int32
    ) -> torch.Tensor:
        """Multi-query decode for speculative verification: writes the Q
        candidates' K/V and attends each against the cache causally, as
        ``prefill_chunk`` does with the slots as the batch, and returns the
        logits of every position [S, Q, V] (f32). Rejected candidates' K/V
        stay and are overwritten by the next step at the same positions."""
        h = self._paged_chunk_trunk(tokens, positions, k_pages, v_pages, block_tables, True)
        return self._logits(h)

    # --- decode ------------------------------------------------------------
    @torch.no_grad()
    def decode(
        self,
        tokens: torch.Tensor,  # [S] current token per slot
        context_lens: torch.Tensor,  # [S] int32 tokens already cached (excl. new)
        k_pages: torch.Tensor,  # [L, P, page, n_kv, d] — written in place
        v_pages: torch.Tensor,
        block_tables: torch.Tensor,  # [S, pages_per_seq] int32
        active: torch.Tensor,  # [S] bool — slot holds a live sequence
    ) -> torch.Tensor:
        """One decode step for every slot; returns logits [S, V] (f32).
        Inactive slots attend nothing (context length 0); they write their
        K/V to the scratch page, or nothing under the fused-write kernel
        (K4 skips ctx == 0 rows)."""
        cfg = self.config
        positions = torch.where(active, context_lens, -1).to(torch.int32)  # [S]
        cos, sin = rope_cos_sin(positions[:, None], self._inv_freq(tokens.device))
        h = self._embed(tokens)  # [S, H]
        ctx_incl = torch.where(active, context_lens + 1, 0).to(torch.int32)
        kernel, fused_write = attn_dispatch.decode_kernel_plan(self.decode_kernel, h.device)
        index = None if fused_write else attn_ops.kv_write_index(
            block_tables, positions[:, None], k_pages.shape[2]
        )
        for li in range(cfg.num_layers):
            lp = self.layer_params(li)
            x = rms_norm(h, lp["ln1"], cfg.rms_norm_eps, one_plus=self.one_plus)
            q, k, v = self._qkv(lp, x[:, None, :], cos, sin)  # [S, 1, heads, d]
            kw = dict(scale=cfg.attn_scale, layer=li, sliding_window=self.windows[li],
                      softcap=cfg.attn_softcap)
            if fused_write:
                attn_out, _, _ = attn_dispatch.decode_attention_fused_write(
                    q[:, 0], k_pages, v_pages, k[:, 0], v[:, 0], block_tables, ctx_incl, **kw
                )
            else:
                attn_ops.write_kv_pages(
                    k_pages, v_pages, k, v, block_tables, positions[:, None], li, index=index
                )
                attn_out = attn_dispatch.decode_attention(
                    q[:, 0], k_pages, v_pages, block_tables, ctx_incl, kernel=kernel, **kw
                )
            h = self._finish_layer(lp, h, attn_out, sync_free=True)
        return self._logits(h)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_params(
    config: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    *,
    device: Optional[torch.device] = None,
    quantize: Any = False,
) -> Params:
    """Random init (testing / benchmarks without a checkpoint): the JAX
    tree's leaves and scales (normal / sqrt(fan_in), unit norms, zero
    biases), drawn from ``generator`` on its device. The numbers differ
    from ``jax.random``'s; tests carry one tree across with
    ``models.convert.params_from_numpy`` instead.

    ``quantize`` ("int8" or True, "int4") returns the quantized tree
    directly, as the JAX ``init_params(quantize=...)`` does: each weight
    is drawn in f32, rounded to ``dtype`` and quantized with ``dtype``
    scales, a stacked layer weight one leading-axis slice at a time, so
    the full-precision transient is one layer's slice. On int4 the layer
    weights take the group rung; the embedding and an untied LM head stay
    int8. An MoE config gets JAX's expert tree (``router``,
    ``expert_{gate,up,down}_proj`` ``[L, E, in, out]``, qwen2_moe's
    ``shared_*``); a 4-D expert stack is drawn one layer slice at a time
    in every mode."""
    cfg = config
    device = torch.device(device) if device is not None else generator.device
    quant_mode = "int4" if str(quantize).lower() == "int4" else ("int8" if quantize else None)
    d = cfg.head_dim_
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def draw(shape, fan_in):
        arr = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return arr.div_(math.sqrt(fan_in)).to(dtype)

    def w(shape, fan_in, *, axis: int = -2, top: bool = False, q: bool = True):
        if not (quant_mode and q):
            if len(shape) < 4:
                return draw(shape, fan_in)
            out = torch.empty(shape, dtype=dtype, device=device)
            for li in range(shape[0]):
                out[li] = draw(shape[1:], fan_in)
            return out

        def quant(arr):
            if quant_mode == "int4" and not top:
                return qm.quantize_array_int4(arr, scale_dtype=dtype)
            return qm.quantize_array(arr, axis=axis, scale_dtype=dtype)

        if len(shape) == 2:
            return quant(draw(shape, fan_in))
        out: Params = {}
        for li in range(shape[0]):
            part = quant(draw(shape[1:], fan_in))
            for key, t in part.items():
                if key not in out:
                    out[key] = torch.empty((shape[0], *t.shape), dtype=t.dtype, device=device)
                out[key][li] = t
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers: Params = {
        "ln1": ones(L, H),
        "ln2": ones(L, H),
        "q_proj": w((L, H, cfg.num_heads * d), H),
        "k_proj": w((L, H, cfg.num_kv_heads * d), H),
        "v_proj": w((L, H, cfg.num_kv_heads * d), H),
        "o_proj": w((L, cfg.num_heads * d, H), cfg.num_heads * d),
    }
    if cfg.num_experts:
        E, Im = cfg.num_experts, cfg.moe_intermediate_size
        layers["router"] = w((L, H, E), H, q=False)
        layers["expert_gate_proj"] = w((L, E, H, Im), H)
        layers["expert_up_proj"] = w((L, E, H, Im), H)
        layers["expert_down_proj"] = w((L, E, Im, H), Im)
        if cfg.shared_expert_intermediate_size:
            Is = cfg.shared_expert_intermediate_size
            layers["shared_gate_proj"] = w((L, H, Is), H)
            layers["shared_up_proj"] = w((L, H, Is), H)
            layers["shared_down_proj"] = w((L, Is, H), Is)
            layers["shared_expert_gate"] = w((L, H, 1), H, q=False)
    else:
        layers["gate_proj"] = w((L, H, I), H)
        layers["up_proj"] = w((L, H, I), H)
        layers["down_proj"] = w((L, I, H), I)
    if cfg.attention_bias:
        layers["q_bias"] = zeros(L, cfg.num_heads * d)
        layers["k_bias"] = zeros(L, cfg.num_kv_heads * d)
        layers["v_bias"] = zeros(L, cfg.num_kv_heads * d)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, d)
        layers["k_norm"] = ones(L, d)
    if cfg.post_norms:
        layers["post_attn_norm"] = ones(L, H)
        layers["post_mlp_norm"] = ones(L, H)
    params: Params = {
        "embed": w((cfg.vocab_size, H), H, axis=-1, top=True),
        "layers": layers,
        "final_norm": ones(H),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((H, cfg.vocab_size), H, top=True)
    return params


def make_kv_pages(
    config: ModelConfig,
    num_pages: int,
    page_size: int,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device: Optional[torch.device] = None,
    num_layers: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the paged KV cache: [L, P, page, n_kv, d] ×2, zeroed. A
    1-byte pool (float8_e5m2) is allocated as zeroed bytes and viewed as
    its dtype (zero bits are +0.0)."""
    shape = (
        config.num_layers if num_layers is None else num_layers,
        num_pages,
        page_size,
        config.num_kv_heads,
        config.head_dim_,
    )
    store = torch.uint8 if attn_ops.is_byte_pool(dtype) else dtype
    return (
        torch.zeros(shape, dtype=store, device=device).view(dtype),
        torch.zeros(shape, dtype=store, device=device).view(dtype),
    )
