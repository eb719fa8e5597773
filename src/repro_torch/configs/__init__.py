from repro_torch.configs.base import (
    ARCH_IDS,
    PORTED_ARCH_IDS,
    SHAPES,
    InputShape,
    ModelConfig,
    cells,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS", "PORTED_ARCH_IDS", "SHAPES", "InputShape", "ModelConfig",
    "cells", "get_config", "get_smoke_config",
]
