"""The dense GQA decoder (granite-3-2b, yi-9b, starcoder2-7b,
mistral-large-123b) and the Mamba2 SSM (mamba2-130m) in PyTorch."""

from repro_torch.models.model import (
    KV_ONLY_FAMILIES,
    cache_dtype,
    cache_specs,
    chunked_prefill,
    decode_step,
    encode,
    forward,
    model_specs,
    prefill,
    verify_step,
)
from repro_torch.models.params import (
    Spec,
    from_numpy,
    init_params,
    param_count,
)

__all__ = [
    "KV_ONLY_FAMILIES", "cache_dtype", "cache_specs", "chunked_prefill",
    "decode_step", "encode", "forward", "model_specs", "prefill", "Spec",
    "from_numpy", "init_params", "param_count", "verify_step",
]
