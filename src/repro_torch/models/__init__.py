"""The dense GQA decoder (granite-3-2b family) in PyTorch."""

from repro_torch.models.model import (
    cache_specs,
    chunked_prefill,
    decode_step,
    encode,
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
    "cache_specs", "chunked_prefill", "decode_step", "encode",
    "model_specs", "prefill", "Spec", "from_numpy", "init_params",
    "param_count", "verify_step",
]
