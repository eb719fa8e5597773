"""grok-1-314b — 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.

8 experts cannot tile the 16-way ``model`` axis, so this config overrides
expert sharding: experts replicated, each expert's d_ff TP-sharded 16-way
(``expert_mlp → model``) — expert weights still 2-D sharded with the FSDP
``data`` axis, so the 314B parameters fit (≈2.4 GB/chip bf16).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    experts_per_token=2,
    rope_theta=1e4,
    sharding_overrides=(("experts", None), ("expert_mlp", "model")),
)

SMOKE_CONFIG = ModelConfig(
    name="grok-1-314b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=1024,
    head_dim=16,
    n_experts=4,
    experts_per_token=2,
    rope_theta=1e4,
    attn_chunk=16,
    sharding_overrides=(("experts", None), ("expert_mlp", "model")),
)
