"""starcoder2-7b — GQA, RoPE [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

36 heads do not divide the 16-way ``model`` axis; the baseline keeps
``heads → model`` (GSPMD pads 36→48 slots, ~25% attention-einsum waste,
visible in the roofline's MODEL_FLOPS/HLO_FLOPS ratio) — a documented
hillclimb target.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    head_pad_to=16,
    rope_theta=1e5,
)

SMOKE_CONFIG = ModelConfig(
    name="starcoder2-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=3,          # deliberately non-power-of-two like the parent
    n_kv_heads=1,
    d_ff=192,
    vocab_size=512,
    head_dim=16,
    head_pad_to=2,
    rope_theta=1e5,
    attn_chunk=16,
)
