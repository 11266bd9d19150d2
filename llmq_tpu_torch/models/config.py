"""Model architecture config.

One config dataclass covers the decoder families the reference deployments
used (SURVEY.md §6, BASELINE.json): Llama-3.x, Qwen2/2.5 (Tower-Plus models
are Qwen2.5 finetunes), Gemma-2, Mistral. ``from_hf_config`` maps a
HuggingFace ``config.json`` onto it.

Family differences expressed as data, not subclasses:

- Qwen2: attention QKV bias (``attention_bias=True``).
- Gemma-2: GeLU MLP, embedding scaling by sqrt(hidden), logit softcapping,
  attn softcapping, post-norms around attn/mlp, alternating sliding-window
  layers, head_dim != hidden/n_heads.
- Llama/Mistral: the baseline (SiLU MLP, RoPE, GQA, RMSNorm).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


def _as_id_list(ids: Any) -> list:
    """Normalize an HF token-id field: int, list, or absent → list[int]."""
    if ids is None:
        return []
    if isinstance(ids, int):
        return [ids]
    return list(ids)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    head_dim: Optional[int] = None  # default hidden_size // num_heads
    max_position_embeddings: int = 131072
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-style QKV bias
    activation: str = "silu"  # "silu" | "gelu_tanh"
    scale_embeddings: bool = False  # Gemma: embed * sqrt(hidden)
    logit_softcap: Optional[float] = None  # Gemma-2 final softcap
    attn_softcap: Optional[float] = None  # Gemma-2 attention softcap
    post_norms: bool = False  # Gemma-2 post-attn/post-mlp norms
    qk_norm: bool = False  # Qwen3/Gemma-3 per-head q/k RMSNorm
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 1  # every Nth layer is global (Gemma-2: 2)
    query_pre_attn_scalar: Optional[float] = None  # Gemma-2 attn scale
    # Mixture-of-experts (qwen2_moe/qwen3_moe): None → dense MLP.
    num_experts: Optional[int] = None
    num_experts_per_tok: int = 0
    moe_intermediate_size: Optional[int] = None
    shared_expert_intermediate_size: Optional[int] = None  # qwen2_moe only
    norm_topk_prob: bool = False  # renormalize the top-k routing weights
    eos_token_ids: Tuple[int, ...] = ()
    bos_token_id: Optional[int] = None
    model_type: str = "llama"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def attn_scale(self) -> float:
        if self.query_pre_attn_scalar is not None:
            return self.query_pre_attn_scalar**-0.5
        return self.head_dim_**-0.5

    def layer_uses_sliding_window(self, layer: int) -> bool:
        """Gemma-2 interleaves sliding/global attention layers."""
        if self.sliding_window is None:
            return False
        if self.sliding_window_pattern <= 1:
            return True
        return (layer % self.sliding_window_pattern) != (
            self.sliding_window_pattern - 1
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any]) -> "ModelConfig":
        """Map a HuggingFace config.json dict (llama/qwen2/gemma2/mistral)."""
        mt = hf.get("model_type", "llama")
        eos = _as_id_list(hf.get("eos_token_id"))
        common = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            intermediate_size=hf["intermediate_size"],
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 131072),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=hf.get("rope_scaling"),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            eos_token_ids=tuple(eos),
            bos_token_id=hf.get("bos_token_id"),
            model_type=mt,
        )
        if mt in ("llama", "mistral"):
            return cls(
                **common,
                attention_bias=hf.get("attention_bias", False),
                sliding_window=hf.get("sliding_window"),
            )
        if mt == "qwen2":
            # Qwen2 ships QKV bias; sliding window usually disabled in config.
            return cls(
                **common,
                attention_bias=True,
                sliding_window=(
                    hf.get("sliding_window") if hf.get("use_sliding_window") else None
                ),
            )
        if mt in ("qwen2_moe", "qwen3_moe"):
            # Sparse-MoE decoders. Only the uniform all-sparse layout is
            # supported (every public qwen-MoE checkpoint uses it); a
            # config interleaving dense layers must fail loudly rather
            # than produce silently-wrong numerics.
            if hf.get("mlp_only_layers") or hf.get("decoder_sparse_step", 1) != 1:
                raise ValueError(
                    f"{mt} with interleaved dense layers "
                    "(mlp_only_layers/decoder_sparse_step) is not supported"
                )
            return cls(
                **common,
                attention_bias=(mt == "qwen2_moe"),
                qk_norm=(mt == "qwen3_moe"),
                sliding_window=(
                    hf.get("sliding_window") if hf.get("use_sliding_window") else None
                ),
                num_experts=hf["num_experts"],
                num_experts_per_tok=hf["num_experts_per_tok"],
                moe_intermediate_size=hf["moe_intermediate_size"],
                shared_expert_intermediate_size=(
                    hf.get("shared_expert_intermediate_size")
                    if mt == "qwen2_moe"
                    else None
                ),
                norm_topk_prob=hf.get("norm_topk_prob", False),
            )
        if mt == "qwen3":
            return cls(**common, attention_bias=False, qk_norm=True)
        if mt == "gemma2":
            return cls(
                **common,
                activation="gelu_tanh",
                scale_embeddings=True,
                logit_softcap=hf.get("final_logit_softcapping", 30.0),
                attn_softcap=hf.get("attn_logit_softcapping", 50.0),
                post_norms=True,
                sliding_window=hf.get("sliding_window", 4096),
                sliding_window_pattern=2,
                query_pre_attn_scalar=hf.get("query_pre_attn_scalar"),
            )
        raise ValueError(f"Unsupported model_type: {mt!r}")

    @classmethod
    def from_pretrained(cls, model_path: str | Path) -> "ModelConfig":
        """Load from a local HF checkpoint directory's config.json.

        ``generation_config.json``'s EOS set is unioned in: Llama-3-style
        checkpoints list the extra stop ids (e.g. ``<|eot_id|>``) *only*
        there, and a model that never stops on its chat-turn terminator
        generates garbage tails (reference parity: vLLM reads the
        generation config, ``llmq/workers/vllm_worker.py:148-165``).
        """
        base = Path(model_path)
        hf = json.loads((base / "config.json").read_text())
        gen_path = base / "generation_config.json"
        if gen_path.exists():
            try:
                gen = json.loads(gen_path.read_text())
            # ValueError covers JSONDecodeError and UnicodeDecodeError
            # (corrupt bytes must not abort model loading either).
            except (OSError, ValueError):
                gen = None
            # Tolerate any malformed shape, not just broken syntax.
            gen_eos = gen.get("eos_token_id") if isinstance(gen, dict) else None
            if gen_eos is not None:
                hf["eos_token_id"] = list(
                    dict.fromkeys(  # ordered union
                        _as_id_list(hf.get("eos_token_id"))
                        + _as_id_list(gen_eos)
                    )
                )
        return cls.from_hf_config(hf)

    # --- handy test configs ------------------------------------------------
    @classmethod
    def tiny(cls, **overrides) -> "ModelConfig":
        base = dict(
            vocab_size=256,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            intermediate_size=128,
            rope_theta=10000.0,
            eos_token_ids=(0,),
        )
        base.update(overrides)
        return cls(**base)

    def num_params(self) -> int:
        """Approximate parameter count (for memory budgeting)."""
        h, v, l = self.hidden_size, self.vocab_size, self.num_layers
        d = self.head_dim_
        attn = h * d * self.num_heads + 2 * h * d * self.num_kv_heads + d * self.num_heads * h
        if self.num_experts:
            mlp = 3 * h * (self.moe_intermediate_size or 0) * self.num_experts
            mlp += h * self.num_experts  # router
            if self.shared_expert_intermediate_size:
                mlp += 3 * h * self.shared_expert_intermediate_size + h
        else:
            mlp = 3 * h * self.intermediate_size
        embed = v * h * (1 if self.tie_word_embeddings else 2)
        return l * (attn + mlp + 2 * h) + embed + h

    def active_params_per_token(self) -> int:
        """Params touched per token (MoE: only routed + shared experts) —
        the MFU-relevant count for throughput estimates."""
        if not self.num_experts:
            return self.num_params()
        h, l = self.hidden_size, self.num_layers
        dense_like = dataclasses.replace(self, num_experts=None)
        per_layer_moe = 3 * h * (self.moe_intermediate_size or 0)
        active = self.num_experts_per_tok * per_layer_moe
        if self.shared_expert_intermediate_size:
            active += 3 * h * self.shared_expert_intermediate_size + h
        active += h * self.num_experts  # router
        return dense_like.num_params() - l * 3 * h * self.intermediate_size + l * active
