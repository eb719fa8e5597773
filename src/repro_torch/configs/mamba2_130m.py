"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060; unverified].

24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2·768 = 1536, head_dim 64 ⇒ 24 SSD heads.
Runs long_500k: decode state is O(1) in context length.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
)
