"""Architecture config schema + registry + the assigned input shapes."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

ARCH_IDS = [
    "musicgen-large",
    "mistral-large-123b",
    "starcoder2-7b",
    "granite-3-2b",
    "yi-9b",
    "jamba-1.5-large-398b",
    "arctic-480b",
    "grok-1-314b",
    "mamba2-130m",
    "pixtral-12b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}

#: Architectures whose config module the PyTorch port carries: every one
#: of ``ARCH_IDS`` (jamba-1.5-large-398b, the hybrid family, was the last)
PORTED_ARCH_IDS = ["granite-3-2b", "mamba2-130m", "yi-9b", "starcoder2-7b",
                   "mistral-large-123b", "grok-1-314b", "arctic-480b",
                   "musicgen-large", "pixtral-12b", "jamba-1.5-large-398b"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int           # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0      # 0 → d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN parallel to MoE
    moe_period: int = 1                # every k-th layer is MoE (jamba: 2)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / jamba mamba layers) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256        # SSD chunk length (train/prefill)
    # KV-cache storage dtype: "auto" (= activation dtype) or
    # "float8_e4m3fn" — halves decode's cache stream + footprint; SSM/conv
    # states are never quantized (recurrences amplify error).
    kv_cache_dtype: str = "auto"
    # --- hybrid ---
    attn_period: int = 0   # jamba: 1 attention layer per 8 (one superblock)
    # --- modality ---
    input_mode: str = "tokens"   # tokens | embeddings (audio/vlm stubs)
    # TP head padding: round n_heads up to a multiple of this for clean
    # 16-way head sharding (starcoder2: 36→48, arctic: 56→64).  Padded
    # heads are dead weights whose outputs are masked before the out
    # projection — the waste is visible in the roofline's useful-FLOPs
    # ratio (hardware-adaptation decision, DESIGN.md §5).
    head_pad_to: int = 0
    # --- numerics / impl ---
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_chunk: int = 512       # blockwise attention chunk target
    remat: str = "block"        # none | block — layer-level rematerialization
    use_pallas: bool = False    # route hot ops through Pallas kernels
    unroll: bool = False        # python-loop instead of lax.scan (dry-run
                                # cost probes: XLA cost_analysis counts a
                                # while body once, unrolled HLO counts all)
    moe_groups: int = 0         # 0 → auto (tokens // 512)
    # per-arch sharding rule overrides (see repro.sharding.logical)
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()

    # ---- derived --------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up for clean 16-way TP (granite: 49155 → 49168)."""
        return _round_up(self.vocab_size, 16)

    @property
    def padded_heads(self) -> int:
        if self.head_pad_to and self.n_heads % self.head_pad_to:
            return _round_up(self.n_heads, self.head_pad_to)
        return self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs only (assignment rule for long_500k)."""
        return self.family in ("ssm", "hybrid")

    def rules(self) -> Dict[str, Optional[str]]:
        return dict(self.sharding_overrides)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _config_module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    if arch not in PORTED_ARCH_IDS:
        raise KeyError(f"arch {arch!r} is not yet ported to repro_torch; "
                       f"ported: {PORTED_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _config_module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    return _config_module(arch).SMOKE_CONFIG


def cells(arch: str) -> List[InputShape]:
    """The (shape) cells assigned to ``arch`` (long_500k gating)."""
    cfg = get_config(arch)
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        out.append(SHAPES["long_500k"])
    return out
