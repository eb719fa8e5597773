"""granite-3-2b — GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
The odd vocab (49,155) is padded to 49,168 in the embedding tables for
clean 16-way TP; the loss masks padded logits (see layers.cross_entropy).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    head_dim=64,
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-3-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=515,     # odd on purpose (padding path)
    head_dim=16,
    rope_theta=1e4,
    tie_embeddings=True,
    attn_chunk=16,
)
