"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (GQA kv=32 ⇒ MHA) d_ff=8192 vocab=2048.
The EnCodec audio frontend is a STUB per assignment: ``input_specs()``
supplies precomputed frame embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    input_mode="embeddings",
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    input_mode="embeddings",
    rope_theta=1e4,
    attn_chunk=16,
)
