"""Wrappers of the port's four hand-written CUDA kernels.

Three attention kernels carry the serving path (block and adaptive
joins): ``flash_attention``, ``chunked_prefill_attention`` and
``paged_decode_attention``.  The prefilter path (embedding, top-k
candidates, scored verification) runs the first two for its prefill
passes and ``topk_similarity`` for its candidates.

Each wrapper takes the layouts of the JAX package's kernels (q
``(B, S, H, hd)``, K/V unrepeated with ``KV`` heads, pools ``(n_pages,
page, KV, hd)``, embeddings ``(M, D)``) and dispatches on the device of
its tensors:

* CPU tensors go to the plain PyTorch version in
  :mod:`repro_torch.models.layers` — the only case it is used;
* CUDA tensors launch the kernel on ``torch.cuda.current_stream()``, or
  the call raises.  There is no fallback: a shape, dtype or layout the
  kernel does not take is an error, and so is a failed launch.

Every wrapper counts its launches in ``launches`` (a plain int), and in
``shapes`` by the launch's integer arguments, so a run can show that its
main path went through the kernels and at which shapes;
:func:`reset_launch_counts` zeroes them all.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Callable, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.models import layers as L

HEAD_DIMS = (16, 32, 64, 128)
#: the largest k' = min(k, N) the top-k kernel takes (kMaxK in
#: csrc/topk_sim.cu): 4 query rows a block keep two 2048-long lists in
#: 128 KB of shared memory
TOPK_MAX_K = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class CudaKernel:
    """One kernel's C entry point in its shared library, its plain
    version, and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, n_ptrs: int,
                 n_ints: int, plain: Callable, replaces: str):
        self.name = name
        self.source = source          # csrc/<source>.cu
        self.symbol = symbol
        self.plain = plain
        self.replaces = replaces      # the Pallas kernel it ports
        self.launches = 0
        #: launches by their integer arguments (the shapes), beside the count
        self.shapes: collections.Counter = collections.Counter()
        self._argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                          + [ctypes.c_void_p])
        self._fn = None

    def _launch(self, ptrs: Sequence[torch.Tensor], ints: Sequence[int]):
        if self._fn is None:
            fn = getattr(build.load(self.source), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream(ptrs[0].device).cuda_stream
        rc = self._fn(*[t.data_ptr() for t in ptrs], *[int(i) for i in ints],
                      stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1
        self.shapes[tuple(int(i) for i in ints)] += 1


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raise on a mix or on a
    device that is neither CPU nor CUDA."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}: "
                     "the kernels take tensors all on one CUDA device or "
                     "all on the CPU")


def _check(name: str, tensors: Sequence[torch.Tensor], hd: int) -> int:
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    return _DTYPES[dtype]


def _int32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int32).contiguous()


class _FlashAttention(CudaKernel):
    def __call__(self, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        """Causal GQA attention: q ``(B,S,H,hd)``, k/v ``(B,S,KV,hd)``."""
        if _on_cpu(q, k, v):
            return self.plain(q, k, v)
        B, S, H, hd = q.shape
        KV = k.shape[2]
        if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV:
            raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                             f"{tuple(k.shape)}/{tuple(v.shape)} do not fit")
        dt = _check(self.name, (q, k, v), hd)
        out = torch.empty_like(q)
        if out.numel():
            self._launch((q, k, v, out), (B, S, H, KV, hd, dt))
        return out


class _ChunkedPrefillAttention(CudaKernel):
    def __call__(self, q: torch.Tensor, k_suffix: torch.Tensor,
                 v_suffix: torch.Tensor, k_prefix: torch.Tensor,
                 v_prefix: torch.Tensor,
                 prefix_len: torch.Tensor) -> torch.Tensor:
        """Suffix q ``(B,S,H,hd)`` over prefix ``(B,P,KV,hd)`` masked by
        ``prefix_len (B,)``, then causal within the suffix."""
        if _on_cpu(q, k_suffix, v_suffix, k_prefix, v_prefix, prefix_len):
            return self.plain(q, k_suffix, v_suffix, k_prefix, v_prefix,
                              prefix_len)
        B, S, H, hd = q.shape
        KV, P = k_suffix.shape[2], k_prefix.shape[1]
        if P == 0:
            raise ValueError("P == 0: use flash_attention for the no-prefix "
                             "case")
        if (k_suffix.shape != (B, S, KV, hd) or v_suffix.shape != k_suffix.shape
                or k_prefix.shape != (B, P, KV, hd)
                or v_prefix.shape != k_prefix.shape
                or prefix_len.shape != (B,) or H % KV):
            raise ValueError("chunked_prefill_attention: shapes do not fit")
        dt = _check(self.name, (q, k_suffix, v_suffix, k_prefix, v_prefix), hd)
        plen = _int32(prefix_len, q.device)
        out = torch.empty_like(q)
        if out.numel():
            self._launch((q, k_suffix, v_suffix, k_prefix, v_prefix, plen, out),
                         (B, S, P, H, KV, hd, dt))
        return out


class _PagedDecodeAttention(CudaKernel):
    def __call__(self, q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, page_table: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
        """One query ``(B,1,H,hd)`` over pool ``(n_pages,page,KV,hd)``
        through ``page_table (B,n_slots)`` and ``cache_len (B,)``."""
        if _on_cpu(q, k_pool, v_pool, page_table, cache_len):
            return self.plain(q, k_pool, v_pool, page_table, cache_len)
        B, one, H, hd = q.shape
        n_pages, page, KV, _ = k_pool.shape
        n_slots = page_table.shape[1]
        if (one != 1 or k_pool.shape[3] != hd or v_pool.shape != k_pool.shape
                or page_table.shape != (B, n_slots) or cache_len.shape != (B,)
                or H % KV or H // KV > 32):
            raise ValueError("paged_decode_attention: shapes do not fit "
                             "(or more than 32 query heads per KV head)")
        dt = _check(self.name, (q, k_pool, v_pool), hd)
        table = _int32(page_table, q.device)
        lens = _int32(cache_len, q.device)
        out = torch.empty_like(q)
        if out.numel() and n_slots:
            self._launch((q, k_pool, v_pool, table, lens, out),
                         (B, H, KV, page, n_pages, n_slots, hd, dt))
        return out


class _TopkSimilarity(CudaKernel):
    def __call__(self, e1: torch.Tensor, e2: torch.Tensor, *,
                 k: int) -> tuple:
        """The ``k' = min(k, N)`` most similar rows of ``e2 (N, D)`` for
        every row of ``e1 (M, D)``: ``(idx (M, k') int32, sim (M, k')
        fp32)``, sorted by value descending, ties to the lower index."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if _on_cpu(e1, e2):
            return self.plain(e1, e2, k)
        if e1.dim() != 2 or e2.dim() != 2 or e1.shape[1] != e2.shape[1]:
            raise ValueError(f"topk_similarity: e1 {tuple(e1.shape)} and e2 "
                             f"{tuple(e2.shape)} are not (M, D) and (N, D)")
        for t in (e1, e2):
            if t.dtype != torch.float32:
                raise TypeError(f"topk_similarity: dtype {t.dtype} not "
                                "supported (float32)")
            if not t.is_contiguous():
                raise ValueError("topk_similarity: inputs must be contiguous")
        (M, D), N = e1.shape, e2.shape[0]
        kk = min(k, N)
        if kk > TOPK_MAX_K:
            raise ValueError(f"topk_similarity: k' = min(k, N) = {kk} is "
                             f"above the kernel's cap of {TOPK_MAX_K}")
        idx = torch.empty((M, kk), dtype=torch.int32, device=e1.device)
        sim = torch.empty((M, kk), dtype=torch.float32, device=e1.device)
        if M and kk:
            if D == 0:
                raise ValueError("topk_similarity: D == 0")
            self._launch((e1, e2, idx, sim), (M, N, D, kk))
        return idx, sim


flash_attention = _FlashAttention(
    "flash_attention", "flash_attention", "repro_flash_attention",
    n_ptrs=4, n_ints=6, plain=L.flash_attention,
    replaces="src/repro/kernels/flash_attention.py:81")
chunked_prefill_attention = _ChunkedPrefillAttention(
    "chunked_prefill_attention", "chunked_prefill",
    "repro_chunked_prefill_attention", n_ptrs=7, n_ints=7,
    plain=L.chunked_prefill_attention,
    replaces="src/repro/kernels/chunked_prefill.py:110")
paged_decode_attention = _PagedDecodeAttention(
    "paged_decode_attention", "paged_decode_attention",
    "repro_paged_decode_attention", n_ptrs=6, n_ints=8,
    plain=L.paged_decode_attention,
    replaces="src/repro/kernels/paged_decode_attention.py:75")
topk_similarity = _TopkSimilarity(
    "topk_similarity", "topk_sim", "repro_topk_similarity", n_ptrs=4,
    n_ints=4, plain=L.topk_similarity,
    replaces="src/repro/kernels/topk_sim.py:75")

#: every kernel of the port: the three attention kernels in the order the
#: model reaches them, then the prefilter's top-k
KERNELS = (flash_attention, chunked_prefill_attention, paged_decode_attention,
           topk_similarity)


def top1_similarity(e1: torch.Tensor, e2: torch.Tensor) -> tuple:
    """``(idx (M,) int32, sim (M,) fp32)``: column 0 of a k = 1
    :func:`topk_similarity`, as ``repro.kernels.topk_sim`` defines it."""
    idx, sim = topk_similarity(e1, e2, k=1)
    return idx[:, 0], sim[:, 0]


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.shapes.clear()


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
