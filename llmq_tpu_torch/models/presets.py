"""Named architecture presets (public model-card dimensions).

Used by ``preset://<name>`` model specs: the worker/benchmark instantiates
the architecture with random weights — no checkpoint download, no egress —
which is how bench.py measures real-size throughput on hardware, and how
tests exercise realistic shapes. The reference's production models map to:
Tower-Plus-2B/9B → gemma2-2b/9b finetunes, Tower-Plus-72B → qwen2.5-72b
(SURVEY.md §6 production scale proof).
"""

from __future__ import annotations

from llmq_tpu_torch.models.config import ModelConfig

_Q = dict(model_type="qwen2", attention_bias=True, rope_theta=1_000_000.0)
_G = dict(
    model_type="gemma2",
    activation="gelu_tanh",
    scale_embeddings=True,
    logit_softcap=30.0,
    attn_softcap=50.0,
    post_norms=True,
    sliding_window=4096,
    sliding_window_pattern=2,
    tie_word_embeddings=True,
)

PRESETS = {
    "tiny": ModelConfig.tiny(),
    "qwen2.5-0.5b": ModelConfig(
        vocab_size=151936, hidden_size=896, num_layers=24, num_heads=14,
        num_kv_heads=2, intermediate_size=4864, tie_word_embeddings=True,
        max_position_embeddings=32768, **_Q,
    ),
    "qwen2.5-1.5b": ModelConfig(
        vocab_size=151936, hidden_size=1536, num_layers=28, num_heads=12,
        num_kv_heads=2, intermediate_size=8960, tie_word_embeddings=True,
        max_position_embeddings=32768, **_Q,
    ),
    "qwen2.5-3b": ModelConfig(
        vocab_size=151936, hidden_size=2048, num_layers=36, num_heads=16,
        num_kv_heads=2, intermediate_size=11008, tie_word_embeddings=True,
        max_position_embeddings=32768, **_Q,
    ),
    "qwen2.5-7b": ModelConfig(
        vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
        num_kv_heads=4, intermediate_size=18944,
        max_position_embeddings=32768, **_Q,
    ),
    "qwen2.5-72b": ModelConfig(
        vocab_size=152064, hidden_size=8192, num_layers=80, num_heads=64,
        num_kv_heads=8, intermediate_size=29568,
        max_position_embeddings=32768, **_Q,
    ),
    "llama3.1-8b": ModelConfig(
        vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, intermediate_size=14336, rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
        },
        model_type="llama",
    ),
    "gemma2-2b": ModelConfig(
        vocab_size=256000, hidden_size=2304, num_layers=26, num_heads=8,
        num_kv_heads=4, head_dim=256, intermediate_size=9216,
        query_pre_attn_scalar=256, max_position_embeddings=8192, **_G,
    ),
    "gemma2-9b": ModelConfig(
        vocab_size=256000, hidden_size=3584, num_layers=42, num_heads=16,
        num_kv_heads=8, head_dim=256, intermediate_size=14336,
        query_pre_attn_scalar=256, max_position_embeddings=8192, **_G,
    ),
    # The reference's headline 9B operating point (Tower-Plus-9B ×8 workers,
    # utils/run_llmq_benchmark.slurm:5-8) — architecture of its base model.
    "tower-plus-9b": ModelConfig(
        vocab_size=256000, hidden_size=3584, num_layers=42, num_heads=16,
        num_kv_heads=8, head_dim=256, intermediate_size=14336,
        query_pre_attn_scalar=256, max_position_embeddings=8192, **_G,
    ),
    # Sparse MoE (Qwen1.5-MoE-A2.7B card): 60 experts, 4 routed + 1
    # shared per token — exercises the grouped-matmul expert path at a
    # realistic expert count.
    "qwen1.5-moe-a2.7b": ModelConfig(
        vocab_size=151936, hidden_size=2048, num_layers=24, num_heads=16,
        num_kv_heads=16, intermediate_size=5632, model_type="qwen2_moe",
        attention_bias=True, rope_theta=1_000_000.0,
        max_position_embeddings=8192, num_experts=60, num_experts_per_tok=4,
        moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
        norm_topk_prob=False, tie_word_embeddings=False,
    ),
}


def get_preset(name: str) -> ModelConfig:
    try:
        return PRESETS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
