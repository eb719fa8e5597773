"""Three-term roofline for one NVIDIA H100 SXM, after
``repro.utils.roofline`` (which models a TPU v5e):

    compute    = sum over rates of operations / (gpus x peak at that rate)
    memory     = bytes                        / (gpus x HBM rate)
    collective = collective bytes             / (gpus x NVLink rate)

The counts are per device (:mod:`repro_torch.utils.op_analysis` counts
one pass on one card), so each term divides by one card's peak.  A
product runs at the rate of its dtype: fp32 products at the fp32 rate,
since the port leaves ``torch.backends.cuda.matmul.allow_tf32`` off; the
hand-written kernels at the rate of the units their bodies use
(:class:`KernelCost`; the fp32 flash and scan backwards on the tensor
cores in 3xTF32, the bf16 scan with its split fp32 operands).

Constants: NVIDIA H100 Tensor Core GPU data sheet, the SXM5 column
(dense, without sparsity): HBM3 3.35 TB/s; BF16 / FP16 tensor cores 989
TFLOP/s; TF32 tensor cores 495 TFLOP/s; FP32 67 TFLOP/s; FP64 34
TFLOP/s; NVLink 900 GB/s a GPU.  The link rate multiplies zero on one
card.

MODEL_FLOPS (the useful-work yardstick), as the JAX package counts it:
    train:    6 . N_active . tokens          (fwd 2 + bwd 4)
    prefill:  2 . N_active . tokens  + 2 . attn (causal: B . S^2 . H . hd . 2 / 2 . 2)
    decode:   2 . N_active . tokens  + 4 . B . Skv . H . hd . L_attn

Per-kernel costs (``*_cost``): one launch's operations, the bytes it must
move (each input read once, each output written once) and the rate it
is bounded at, from its shapes and dtypes; where the work depends on the
data (a decode row's length, a chunked prefill's prefix), from the
lengths given.  ``chip_smoke.py`` states every kernel's bound through
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Union

#: bytes/s of one card's HBM3
HBM_BW = 3.35e12
#: FLOP/s of one card by the rate's name (a dtype's, or "tf32" for fp32
#: operands on the tensor cores)
PEAK_FLOPS: Dict[str, float] = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
    "float64": 34e12,
}
PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]
#: bytes/s of one card's NVLink
NVLINK_BW = 900e9
#: device memory of an H100 80GB HBM3 (without a card to ask)
H100_MEMORY_BYTES = 80 * 2 ** 30

Flops = Union[float, Mapping[str, float]]


def rate_name(dtype) -> str:
    """The :data:`PEAK_FLOPS` key of ``dtype`` (a ``torch.dtype`` or a
    name: ``torch.float32`` -> ``"float32"``)."""
    name = str(dtype).removeprefix("torch.")
    if name not in PEAK_FLOPS:
        raise KeyError(f"no peak rate for {dtype!r}: {sorted(PEAK_FLOPS)}")
    return name


def compute_seconds(flops: Flops) -> float:
    """Seconds for ``flops`` (a number at the bf16 rate, or operations by
    rate name) on one card."""
    if isinstance(flops, Mapping):
        return sum(f / PEAK_FLOPS[rate_name(r)] for r, f in flops.items())
    return flops / PEAK_FLOPS_BF16


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
        }


def roofline(
    flops_per_chip: Flops,
    bytes_per_chip: float,
    coll_bytes_per_chip: float,
    *,
    hbm_bw: float = HBM_BW,
    link_bw: float = NVLINK_BW,
) -> RooflineTerms:
    """The three terms of one card's work: ``flops_per_chip`` a number
    (at the bf16 rate) or operations by rate name, each taken at its
    peak (:data:`PEAK_FLOPS`)."""
    total = (sum(flops_per_chip.values())
             if isinstance(flops_per_chip, Mapping) else flops_per_chip)
    return RooflineTerms(
        compute_s=compute_seconds(flops_per_chip),
        memory_s=bytes_per_chip / hbm_bw,
        collective_s=coll_bytes_per_chip / link_bw,
        flops_per_chip=float(total),
        bytes_per_chip=float(bytes_per_chip),
        coll_bytes_per_chip=float(coll_bytes_per_chip),
    )


# ---------------------------------------------------------------------------
# H100-derived pricing: the paper's g on self-hosted serving
# ---------------------------------------------------------------------------


def h100_pricing(cfg, *, gpus: int = 1, batch: int = 8,
                 usd_per_gpu_hour: float, mfu_prefill: float = 0.5,
                 quantized: bool = True):
    """A :class:`repro_torch.core.accounting.Pricing` from the serving
    roofline of ``cfg`` on ``gpus`` H100s, the closed form of the JAX
    package's ``tpu_pricing`` on this card's constants:

    * input (prefill) token: compute-bound, ``2 N_active / (gpus . peak .
      MFU)`` seconds of card time;
    * output (decode) token: memory-bound, the weights stream from HBM
      once a step, shared by the decode ``batch``.

    ``g = peak . MFU . bytes_per_param / (2 . HBM . batch)`` does not
    depend on ``usd_per_gpu_hour``, which has no default: a TPU's price
    a chip-hour does not carry over."""
    from repro_torch.core.accounting import Pricing

    n = active_params(cfg)
    usd_per_gpu_s = usd_per_gpu_hour / 3600.0
    read_s = 2.0 * n / (gpus * PEAK_FLOPS_BF16 * mfu_prefill)
    bytes_per_param = 1 if quantized else 2
    decode_s = (n * bytes_per_param / gpus) / HBM_BW / batch
    return Pricing(
        read_per_token=read_s * gpus * usd_per_gpu_s,
        write_per_token=decode_s * gpus * usd_per_gpu_s,
        name=f"h100-{cfg.name}",
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS: useful-work estimates per (arch x shape)
# ---------------------------------------------------------------------------


def active_params(cfg) -> int:
    """Parameters touched per token (MoE: top-k experts only)."""
    from repro_torch.models import model_specs
    from repro_torch.models.params import param_count, tree_items

    specs = model_specs(cfg)
    total = param_count(specs)
    if cfg.n_experts and cfg.experts_per_token:
        # expert weights are the tensors carrying an "experts" axis
        expert_params = sum(
            math.prod(s.shape) for _, s in tree_items(specs)
            if "experts" in s.axes and len(s.shape) >= 3
        )
        inactive = expert_params * (1 - cfg.experts_per_token / cfg.n_experts)
        return int(total - inactive)
    return total


def model_flops(cfg, shape, n_active: Optional[int] = None) -> float:
    """Useful FLOPs for one step of the given shape (global)."""
    n = n_active if n_active is not None else active_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    n_attn_layers = 0
    if cfg.has_attention:
        n_attn_layers = (
            cfg.n_layers // cfg.attn_period if cfg.family == "hybrid" else cfg.n_layers
        )
    if shape.kind == "train":
        tokens = B * S
        attn = 6 * B * S * S // 2 * cfg.n_heads * hd * 2 * n_attn_layers
        return 6.0 * n * tokens + attn
    if shape.kind == "prefill":
        tokens = B * S
        attn = 2 * B * S * S // 2 * cfg.n_heads * hd * 2 * n_attn_layers
        return 2.0 * n * tokens + attn
    if shape.kind == "decode":
        tokens = B  # one new token per row
        attn = 4.0 * B * S * cfg.n_heads * hd * n_attn_layers
        return 2.0 * n * tokens + attn
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# The hand-written kernels: one launch's operations, bytes and rate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One launch: ``flops`` operations in the units of ``rate`` (a
    :data:`PEAK_FLOPS` key) and ``bytes`` it must move.  ``work`` is the
    plain operations where the units count more (3xTF32's three products
    a product; a split operand's two), else ``flops``."""
    flops: float
    bytes: float
    rate: str
    work: Optional[float] = None

    @property
    def ops(self) -> float:
        """The plain operations (the useful-work yardstick's units)."""
        return self.flops if self.work is None else self.work

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS[self.rate]

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def bound_ms(self) -> float:
        """The least time on one card: the larger of the two terms."""
        return max(self.memory_s, self.compute_s) * 1e3

    @property
    def bound_by(self) -> str:
        return "bytes" if self.memory_s >= self.compute_s else "operations"

    def __add__(self, other: "KernelCost") -> "KernelCost":
        """Two launches at one rate (``sum`` of costs starts from 0)."""
        if other == 0:
            return self
        if other.rate != self.rate:
            raise ValueError(f"costs at {self.rate} and {other.rate}")
        return KernelCost(self.flops + other.flops, self.bytes + other.bytes,
                          self.rate, self.ops + other.ops)

    __radd__ = __add__


def _size(dtype) -> int:
    """Bytes an element of ``dtype`` (a torch dtype or its name)."""
    name = str(dtype).removeprefix("torch.")
    if name.startswith("float8") or name in ("int8", "uint8", "bool"):
        return 1
    if name in ("bfloat16", "float16", "int16"):
        return 2
    if name in ("float32", "int32"):
        return 4
    if name in ("float64", "int64"):
        return 8
    raise KeyError(f"no element size for {dtype!r}")


def _causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def flash_cost(B: int, S: int, H: int, KV: int, hd: int, dtype,
               lse: bool = False) -> KernelCost:
    """Causal GQA flash attention: q and the output ``(B, S, H, hd)``,
    K/V ``(B, S, KV, hd)`` (and with ``lse`` each row's fp32 log-sum-exp,
    the training forward's); 4 hd operations a causal (query, key) pair
    and head."""
    es = _size(dtype)
    nbytes = (2 * B * S * H + 2 * B * S * KV) * hd * es
    if lse:
        nbytes += 4 * B * H * S
    return KernelCost(4 * hd * _causal_pairs(S) * B * H, nbytes,
                      rate_name(dtype))


def chunked_prefill_cost(B: int, S: int, P: int, H: int, KV: int, hd: int,
                         dtype, prefix_len: Optional[Sequence[int]] = None
                         ) -> KernelCost:
    """The suffix ``(B, S, H, hd)`` over its own causal pairs and each
    row's valid prefix (``prefix_len``, each clipped to ``P``; the full
    prefix where not given): q, the suffix K/V, the lengths, the valid
    prefix rows and the output."""
    es = _size(dtype)
    lens = [P] * B if prefix_len is None else list(prefix_len)
    valid = sum(min(max(n, 0), P) for n in lens)
    pairs = _causal_pairs(S) * B + S * valid
    nbytes = ((2 * B * S * H + 2 * B * S * KV) * hd * es + 4 * B
              + 2 * valid * KV * hd * es)
    return KernelCost(4 * hd * H * pairs, nbytes, rate_name(dtype))


def paged_decode_cost(B: int, H: int, KV: int, hd: int, page: int,
                      n_slots: int, dtype, kv_dtype=None,
                      cache_len: Optional[Sequence[int]] = None
                      ) -> KernelCost:
    """One query a row over the positions ``cache_len`` (each row's,
    clipped to the table's ``n_slots x page``; the full table where not
    given) read through its page table: q and the output, the K/V rows
    read (in ``kv_dtype``, q's by default), the table entries of the
    pages read and the lengths."""
    cap = n_slots * page
    lens = [cap] * B if cache_len is None else [min(n, cap)
                                                for n in cache_len]
    kv_es = _size(kv_dtype or dtype)
    used_slots = sum(-(-n // page) for n in lens)
    nbytes = (2 * B * H * hd * _size(dtype) + 2 * sum(lens) * KV * hd * kv_es
              + 4 * (used_slots + B))
    return KernelCost(4 * hd * H * sum(lens), nbytes, rate_name(dtype))


def spec_verify_cost(B: int, K: int, H: int, KV: int, hd: int, page: int,
                     n_slots: int, dtype, kv_dtype=None,
                     cache_len: Optional[Sequence[int]] = None
                     ) -> KernelCost:
    """A window of K queries a row, query ``j`` over positions ``<
    cache_len + j + 1`` (``cache_len`` the lengths before the window;
    where not given, the window ends at the table's last position): q
    and the output, the K/V rows read, the table entries and lengths."""
    cap = n_slots * page
    lens = ([cap - K] * B if cache_len is None else list(cache_len))
    read = sum(min(n + K, cap) for n in lens)
    keys = sum(min(n + j + 1, cap) for n in lens for j in range(K))
    used_slots = sum(-(-min(n + K, cap) // page) for n in lens)
    kv_es = _size(kv_dtype or dtype)
    nbytes = (2 * B * K * H * hd * _size(dtype) + 2 * read * KV * hd * kv_es
              + 4 * (used_slots + B))
    return KernelCost(4 * hd * H * keys, nbytes, rate_name(dtype))


def decode_attention_cost(B: int, H: int, KV: int, hd: int, Skv: int,
                          dtype, kv_dtype=None,
                          cache_len: Optional[Sequence[int]] = None
                          ) -> KernelCost:
    """One query a row over the first ``cache_len`` positions (each
    clipped to ``Skv``; all of them where not given) of a dense cache
    ``(B, Skv, KV, hd)``: q and the output, the K/V rows read, the
    lengths."""
    lens = [Skv] * B if cache_len is None else [min(n, Skv)
                                                for n in cache_len]
    kv_es = _size(kv_dtype or dtype)
    nbytes = (2 * B * H * hd * _size(dtype) + 2 * sum(lens) * KV * hd * kv_es
              + 4 * B)
    return KernelCost(4 * hd * H * sum(lens), nbytes, rate_name(dtype))


def topk_cost(M: int, N: int, D: int, k: int) -> KernelCost:
    """fp32 top-k similarity: e1 ``(M, D)`` and e2 ``(N, D)`` read, every
    (row, column) dot taken, ``(M, k')`` indices and values written."""
    kk = min(k, N)
    return KernelCost(2 * M * N * D, 4 * (M + N) * D + 8 * M * kk,
                      "float32")


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int,
              split: int = 1) -> int:
    """The scan's multiply-adds, x 2.  B and C form one group shared by
    every head, so the causal pairs' C.B (c(c+1)/2 x N) is needed once per
    (row, chunk); per (row, head, chunk) come the pairs' W.x (c(c+1)/2 x
    P), and, per chunk boundary, the state's update after the chunk
    before and its read C.h in the chunk after (c x N x P each; a single
    chunk needs neither: the scan returns y, not the final state).  The
    masked upper triangle is not counted: the least work, not the
    kernel's.  ``split`` counts the products of the operands the bf16
    kernel splits into two bf16 parts (W, w x, h) that many times."""
    c, n = chunk, S // chunk
    pairs = c * (c + 1) // 2
    per_row = n * pairs * N + H * split * (n * pairs * P
                                           + 2 * (n - 1) * c * N * P)
    return 2 * B * per_row


def _ssd_bytes(B: int, S: int, H: int, P: int, N: int, dtype) -> int:
    """x, dt, A, b and c of one scan call."""
    es = _size(dtype)
    return B * S * H * P * es + 4 * B * S * H + 4 * H + 2 * B * S * N * es


def ssd_scan_cost(B: int, S: int, H: int, P: int, N: int, chunk: int,
                  dtype, rate: Optional[str] = None) -> KernelCost:
    """The SSD scan (``ssd_flops``; inputs read once, y written once).
    By default in the units its body uses: fp32 on the CUDA cores, bf16
    on the tensor cores with the split fp32 operands' products counted
    twice; ``rate="float32"`` counts the plain operations at the fp32
    rate whatever the dtype (the scan's bound as PERF.md first stated
    it)."""
    nbytes = _ssd_bytes(B, S, H, P, N, dtype) + B * S * H * P * _size(dtype)
    bf16 = rate_name(dtype) == "bfloat16" and rate is None
    flops = ssd_flops(B, S, H, P, N, chunk, split=2 if bf16 else 1)
    return KernelCost(flops, nbytes, rate or rate_name(dtype),
                      ssd_flops(B, S, H, P, N, chunk))


def rmsnorm_cost(rows: int, D: int, dtype, w_dtype=None) -> KernelCost:
    """RMSNorm over ``rows`` rows of width ``D``: x read, the output
    written, the weight read once; 4 fp32 operations an element."""
    es = _size(dtype)
    return KernelCost(4 * rows * D, 2 * rows * D * es
                      + D * _size(w_dtype or dtype), "float32")


def decode_gemm_cost(M: int, K: int, Ns: Sequence[int], dtype,
                     scales: Optional[Sequence[int]] = None) -> KernelCost:
    """One launch of the decode GEMM: ``x (M, K)`` times each ``(K, N)``
    weight of ``Ns`` (a group of up to three).  Each product reads its
    weight (int8 payloads and their ``scales`` fp32 scales where given,
    else in x's dtype) and x, and writes y ``(M, N)``."""
    es = _size(dtype)
    nbytes = 0
    for i, N in enumerate(Ns):
        w = (K * N + 4 * scales[i]) if scales is not None else K * N * es
        nbytes += w + M * (K + N) * es
    return KernelCost(2 * M * K * sum(Ns), nbytes, rate_name(dtype))


def flash_bwd_flops(B: int, S: int, H: int, hd: int) -> int:
    """The five products of the gradient (S = QK^T recomputed, dV, dP,
    dQ, dK): 2.5x the forward's causal operations."""
    return 5 * 2 * hd * _causal_pairs(S) * B * H


def flash_bwd_cost(B: int, S: int, H: int, KV: int, hd: int, dtype,
                   rate: Optional[str] = None) -> KernelCost:
    """The flash backward: q, k, v, the output, its gradient and the
    forward's fp32 log-sum-exp read, dq, dk, dv written.  By default in
    the units its body uses: bf16 on the tensor cores, fp32 in 3xTF32
    (each product three TF32 products); ``rate="float32"`` counts the
    plain operations at the fp32 rate."""
    es = _size(dtype)
    nbytes = (3 * B * S * H + 2 * B * S * KV) * hd * es + 4 * B * H * S + (
        B * S * H + 2 * B * S * KV) * hd * es
    flops = flash_bwd_flops(B, S, H, hd)
    if rate is None and rate_name(dtype) == "float32":
        return KernelCost(3 * flops, nbytes, "tf32", flops)
    return KernelCost(flops, nbytes, rate or rate_name(dtype))


def ssd_bwd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """The scan's gradient's multiply-adds, x 2: per (row, chunk) the
    causal pairs' G = C.B^T, dC = dG.B and dB = dG^T.C (c(c+1)/2 x N
    each, once: B and C are shared by the heads); per (row, head, chunk)
    the pairs' dy.x^T and W^T.dy (c(c+1)/2 x P each); per chunk boundary
    and head the state recomputed, the state gradient's part C^T dy,
    dh^T B, dh x and h dy (c x N x P each).  The masked upper triangle
    is not counted: the least work, not the kernel's."""
    c, n = chunk, S // chunk
    pairs = c * (c + 1) // 2
    per_row = 3 * n * pairs * N + H * (2 * n * pairs * P
                                       + 5 * (n - 1) * c * N * P)
    return 2 * B * per_row


def ssd_bwd_cost(B: int, S: int, H: int, P: int, N: int, chunk: int,
                 dtype, rate: Optional[str] = None) -> KernelCost:
    """The scan's backward: x, dt, A, b, c and dy read, their gradients
    written.  By default in the units its body uses: fp32 in 3xTF32, bf16
    on the tensor cores with the split fp32 operands' products counted
    twice; ``rate`` set counts the plain operations at that rate."""
    nbytes = 2 * _ssd_bytes(B, S, H, P, N, dtype) + B * S * H * P * _size(
        dtype)
    flops = ssd_bwd_flops(B, S, H, P, N, chunk)
    if rate is not None:
        return KernelCost(flops, nbytes, rate)
    if rate_name(dtype) == "float32":
        return KernelCost(3 * flops, nbytes, "tf32", flops)
    return KernelCost(2 * flops, nbytes, "bfloat16", flops)
