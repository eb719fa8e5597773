"""pixtral-12b — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
The ViT patch frontend is a STUB per assignment: ``input_specs()`` supplies
precomputed patch embeddings for prefill/train; decode consumes tokens.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    input_mode="embeddings",
    rope_theta=1e9,
)

SMOKE_CONFIG = ModelConfig(
    name="pixtral-12b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=1024,
    head_dim=16,
    input_mode="embeddings",
    rope_theta=1e9,
    attn_chunk=16,
)
