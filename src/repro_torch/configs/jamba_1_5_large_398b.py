"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Structure: 9 superblocks of 8 layers — slot 0 attention, slots 1–7 Mamba2;
MoE replaces the dense FFN on every other layer (moe_period=2).
Runs long_500k (hybrid ⇒ sub-quadratic: only 9 attention layers hold KV).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    n_experts=16,
    experts_per_token=2,
    moe_period=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    attn_period=8,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    n_layers=4,          # 2 superblocks of [attn, mamba]
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    n_experts=4,
    experts_per_token=2,
    moe_period=2,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    conv_width=4,
    attn_period=2,
    rope_theta=1e6,
    attn_chunk=16,
)
