"""arctic-480b — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Arctic's signature dense-MoE hybrid: a dense FFN runs in parallel with the
routed experts on every layer (``moe_dense_residual=True``).
128 experts / 16-way model axis ⇒ clean EP=16 (8 experts per shard).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    head_pad_to=16,
    n_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="arctic-480b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    head_dim=16,
    head_pad_to=2,
    n_experts=4,
    experts_per_token=2,
    moe_dense_residual=True,
    rope_theta=1e6,
    attn_chunk=16,
)
