"""Wrappers of the port's eleven hand-written CUDA kernels.

Three attention kernels carry the serving path (block and adaptive
joins): ``flash_attention``, ``chunked_prefill_attention`` and
``paged_decode_attention``.  The prefilter path (embedding, top-k
candidates, scored verification) runs the first two for its prefill
passes and ``topk_similarity`` for its candidates.  Speculative decoding
on the paged engine verifies its draft windows with
``spec_verify_attention``; the dense-KV engine decodes with
``decode_attention`` and verifies by looping it over the window.  The
ssm family (mamba2) runs ``ssd_scan`` in every prefill, scoring and
encode pass, once a layer.  The dense family's decode and verify
passes take every norm through ``rmsnorm`` (one block a row) and every
product -- the attention projections, the MLP and the unembed --
through ``decode_gemm`` (by :func:`decode_linear`, and by
:func:`decode_linear_group` for the products of one input in one call:
q/k/v, gate/up): results per row that do not depend on how many rows
came with it, so a verify pass gives each window row the bits of the
decode step it stands for.  Int8 weights (``models/quant.py``) take the
GEMM's int8 variant, the dense product's bits on the dequantized
weight.  (The JAX
package's model calls its RMSNorm kernel nowhere; the port needs the
row-blocked norm for this.)

Training (``repro_torch.train``) differentiates through two kernels.
Where grad is enabled and an input requires it, ``flash_attention`` goes
through :class:`_FlashFunction`, whose forward also writes each row's
log-sum-exp and whose backward launches ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``), and ``ssd_scan`` through
:class:`_SsdScanFunction`, whose backward launches ``ssd_scan_bwd``
(``csrc/ssd_scan_bwd.cu``).  Every other kernel has no backward on the
card: reached with an input that requires grad while grad is enabled, its
wrapper raises (:func:`refuse_grad`) instead of returning a result cut
off from the autograd graph.  On the CPU the plain versions differentiate
natively.

Each wrapper takes the layouts of the JAX package's kernels (q
``(B, S, H, hd)``, K/V unrepeated with ``KV`` heads, pools ``(n_pages,
page, KV, hd)``, embeddings ``(M, D)``, the scan's ``(B, S, H, P)``) and
dispatches on the device of its tensors:

* CPU tensors go to the plain PyTorch version in
  :mod:`repro_torch.models.layers` — the only case it is used;
* CUDA tensors launch the kernel on ``torch.cuda.current_stream()``, or
  the call raises.  There is no fallback: a shape, dtype or layout the
  kernel does not take is an error, and so is a failed launch;
* meta tensors (the planner, :mod:`repro_torch.launch.dryrun`) take the
  CUDA branch's checks and allocations, the scratch included, on the
  meta device, and count one launch where the CUDA branch would launch,
  without a card or a build: the scratch sizes the library would give
  come from Python mirrors of its plans (:data:`SPLIT_CHUNK`, the
  scan's ``meta_scratch_bytes``, the GEMM's ``meta_splits``, top-k's
  :func:`_topk_plan_meta`), and no meta tensor ever reaches a plain
  version (plain attention would materialise the ``S x S`` scores the
  kernels never write).  Under an :mod:`repro_torch.utils.op_analysis`
  each wrapper call is reported to it (:func:`observing`), and each
  meta launch with its cost from :mod:`repro_torch.utils.roofline`.

Tensors are fp32 or bf16; the three decode-side kernels also take K/V in
e4m3 (an fp8 KV cache, ``cfg.kv_cache_dtype="float8_e4m3fn"``) under an
fp32 or bf16 query, widened exactly to fp32 as a tile is read.

Every wrapper counts its launches in ``launches`` (a plain int), and in
``shapes`` by the launch's integer arguments (the decode GEMM by
product: a grouped launch counts each of its products there), so a run
can show that its main path went through the kernels and at which
shapes; :func:`reset_launch_counts` zeroes them all.  The counts stay
exact when several threads launch at once (the replicas of a serving
cluster): they move under one lock (``COUNT_LOCK``), and a thread may
also keep its own tally (:func:`counting_into`).

Persistent scratch (the scan's buffers, the decode GEMM's fp32 partials
and counters) is kept per thread and device: calls of one thread run in
order (on its stream, or joined to it), so a thread's buffers are never
written by two calls at once, and a graph captured by a thread keeps
writing that thread's buffers at its replays.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DeviceError
from repro_torch.models import layers as L
from repro_torch.models.quant import QuantizedTensor, deq
from repro_torch.utils import roofline as R

HEAD_DIMS = (16, 32, 64, 128)
#: the most window query rows K * (H / KV) one launch of the verify kernel
#: takes (32 warps of 4 rows each in csrc/spec_verify_attention.cu); the
#: wrapper walks a longer window in sub-windows of SPEC_MAX_ROWS // G
#: positions
SPEC_MAX_ROWS = 128
#: the largest k' = min(k, N) the top-k kernel takes (kMaxK in
#: csrc/topk_sim.cu): 4 query rows a block keep two 2048-long lists in
#: 128 KB of shared memory
TOPK_MAX_K = 2048
#: the most products one call of the decode GEMM takes (kMaxGroup in
#: csrc/decode_gemm.cu): q/k/v of an attention block
DECODE_MAX_GROUP = 3
#: the largest head width P and state width N the scan kernel stages
#: (csrc/ssd_scan.cu), and its longest chunk
SSD_MAX_P, SSD_MAX_N, SSD_MAX_CHUNK = 64, 128, 2048
#: the most rows of x one launch of the decode GEMM takes (kMaxRows in
#: csrc/decode_gemm.cu); the wrapper walks more rows in blocks of it.  One
#: launch covers slots x (spec_k + 1) on the match-dense join (52) and at
#: the engine's defaults (8 slots, spec_k 8: 72)
DECODE_MAX_ROWS = 128
#: the decode GEMM's counters: one per column tile of a split product,
#: at most 256 (kTargetBlocks / 2 in csrc/decode_gemm.cu)
_GEMM_COUNTERS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the decode-side kernels also take K/V in e4m3 (an fp8 KV cache) under an
#: fp32 or bf16 query: dtype code 2 + q's code (dispatch_split in
#: csrc/attention_common.cuh)
_E4M3 = torch.float8_e4m3fn
#: (x's, w's) dtype codes of the RMSNorm kernel, by their dtypes
_NORM_CODES = {(a, b): (_DTYPES[a], _DTYPES[b]) for a in _DTYPES
               for b in _DTYPES}
#: the widest row the RMSNorm kernel takes, by x's dtype code: 1024
#: threads of 4 vectors of 16 bytes (kMaxThreads, kMaxPer in
#: csrc/rmsnorm.cu)
NORM_MAX_D = {0: 1024 * 4 * 4, 1: 1024 * 4 * 8}
#: the raw handle of the current stream (absent from CPU-only builds, which
#: never launch)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
#: guards every kernel's ``launches`` and ``shapes``
COUNT_LOCK = threading.Lock()
#: per thread: ``tally`` (a Counter by kernel name, or None), ``scratch``
#: and ``observer`` (an op analysis, or None)
_local = threading.local()
#: positions per context chunk of the split-context decode kernels (kChunk
#: in csrc/attention_common.cuh), for meta calls; ``chip_smoke.py`` holds
#: it to the library's
SPLIT_CHUNK = 256
#: SMs of an H100 SXM, for the top-k plan of a meta call
H100_SMS = 132


def _observed(method):
    """A wrapper's entry point, reported to the calling thread's op
    analysis where one is set (:func:`observing`); otherwise called as it
    is."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        obs = getattr(_local, "observer", None)
        if obs is None:
            return method(self, *args, **kwargs)
        return obs.kernel_call(self, method, args, kwargs)
    return call


@contextlib.contextmanager
def observing(observer):
    """Report the calling thread's wrapper calls, and the costs of its
    meta launches, to ``observer`` while the block runs (its
    ``kernel_call(kernel, method, args, kwargs)`` runs each call, its
    ``kernel_launch(kernel, cost)`` takes each meta launch's
    :class:`~repro_torch.utils.roofline.KernelCost`)."""
    prev = getattr(_local, "observer", None)
    _local.observer = observer
    try:
        yield observer
    finally:
        _local.observer = prev


def drop_meta_scratch() -> None:
    """Forget the calling thread's meta scratch, so the next meta call
    allocates its own, as a first call on a card does."""
    for bufs in getattr(_local, "scratch", {}).values():
        for dev in [d for d in bufs if str(d) == "meta"]:
            del bufs[dev]


class CudaKernel:
    """One kernel's C entry point in its shared library, its plain
    version, and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, n_ptrs: int,
                 n_ints: int, plain: Callable, replaces: str,
                 n_floats: int = 0, n_longs: int = 0):
        self.name = name
        self.source = source          # csrc/<source>.cu
        self.symbol = symbol
        self.plain = plain
        self.replaces = replaces      # the Pallas kernel it ports
        self.launches = 0
        #: launches by their integer arguments (the shapes), beside the count
        self.shapes: collections.Counter = collections.Counter()
        self._argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                          + [ctypes.c_longlong] * n_longs
                          + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        self._fn = None

    def _lib(self) -> ctypes.CDLL:
        return build.load(self.source)

    @property
    def _scratch(self) -> Dict:
        """The calling thread's persistent scratch of this kernel, by
        device (empty for the kernels that keep none)."""
        store = getattr(_local, "scratch", None)
        if store is None:
            store = _local.scratch = {}
        return store.setdefault(self.name, {})

    def _bind(self):
        fn = getattr(self._lib(), self.symbol)
        fn.argtypes = self._argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def _launch(self, ptrs: Sequence[Optional[torch.Tensor]],
                ints: Sequence[int], floats: Sequence[float] = (),
                key: Optional[Sequence[int]] = None,
                keys: Sequence[Sequence[int]] = ()):
        """Launch on the current stream and count it, under ``key`` in
        :attr:`shapes` (the integer arguments unless given), or once under
        each of ``keys`` where one launch does several things.  A decode
        pass makes ~300 launches, so this stays lean: the raw handle of
        the current stream, ``get_device`` (no ``torch.device`` built).
        On meta tensors nothing is launched: the launch is counted and
        its cost reported (:meth:`_meta_launch`).  Raises where an input
        requires grad (:func:`refuse_grad`)."""
        refuse_grad(self.name, ptrs)
        if ptrs[0].is_meta:
            return self._meta_launch(ptrs, ints, [tuple(k) for k in keys]
                                     if keys else [tuple(ints if key is None
                                                         else key)])
        fn = self._fn or self._bind()
        rc = fn(*[t if t is None else t.data_ptr() for t in ptrs], *ints,
                *floats, _raw_stream(ptrs[0].get_device()))
        if rc != 0:
            raise DeviceError(f"{self.name} kernel launch failed: CUDA "
                              f"error {rc}")
        self.count(1, [tuple(k) for k in keys] if keys
                   else [tuple(ints if key is None else key)])

    def _meta_launch(self, ptrs, ints, shapes) -> None:
        """One launch on meta tensors: counted as a card's launch is, and
        its cost (:meth:`cost`) reported to the calling thread's op
        analysis, where one is set."""
        self.count(1, shapes)
        obs = getattr(_local, "observer", None)
        if obs is not None:
            obs.kernel_launch(self, self.cost(ptrs, ints))

    def cost(self, ptrs, ints) -> "R.KernelCost":
        """The :mod:`~repro_torch.utils.roofline` cost of one launch from
        its arguments (where it depends on the data, such as a decode
        row's length, the most the shapes hold)."""
        raise NotImplementedError(self.name)

    def count(self, n: int, shapes) -> None:
        """Add ``n`` launches, under ``shapes`` (keys, or a Counter of
        keys), to the counts and to the calling thread's tally."""
        with COUNT_LOCK:
            self.launches += n
            self.shapes.update(shapes)
        tally = getattr(_local, "tally", None)
        if tally is not None:
            tally[self.name] += n


class _SplitDecode(CudaKernel):
    """A decode-side attention kernel on the split-context body of
    csrc/attention_common.cuh: every row's context is cut into chunks of
    ``chunk()`` positions from position 0, one block folds each chunk, and
    a combine folds the chunks' fp32 partials in order, in the same C call
    (one launch counted)."""

    def chunk(self) -> int:
        """Positions per chunk (kChunk in csrc/attention_common.cuh)."""
        if getattr(self, "_chunk", None) is None:
            fn = self._lib().repro_attn_chunk
            fn.argtypes, fn.restype = [], ctypes.c_int
            self._chunk = int(fn())
        return self._chunk

    def partials(self, B: int, KV: int, cap: int, rows: int, hd: int,
                 device) -> torch.Tensor:
        """Scratch for the (m, l, o) partials of ``rows`` query rows per
        (row, KV head) over a context of up to ``cap`` positions (on
        meta, chunks of :data:`SPLIT_CHUNK`)."""
        chunk = SPLIT_CHUNK if device.type == "meta" else self.chunk()
        n_chunks = -(-cap // chunk)
        return torch.empty(B * KV * n_chunks * rows * (hd + 2),
                           dtype=torch.float32, device=device)


def _round256(n: int) -> int:
    return -(-n // 256) * 256


def _ssd_shape_ok(B: int, S: int, H: int, P: int, N: int, chunk: int
                  ) -> bool:
    """``shape_ok`` of csrc/ssd_scan.cu and csrc/ssd_scan_bwd.cu."""
    return (B > 0 and S > 0 and H > 0 and 0 < P <= SSD_MAX_P
            and 0 < N <= SSD_MAX_N and 0 < chunk <= SSD_MAX_CHUNK
            and S % chunk == 0)


def refuse_grad(name: str, tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """Raise where grad is enabled and one of ``tensors`` requires it: a
    kernel launched there would return a result cut off from the
    autograd graph, and training would silently give the inputs no
    gradient.  Only ``flash_attention`` and ``ssd_scan`` have a backward
    on the card (their wrappers go through an autograd Function before
    they launch)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: an input requires grad, and this kernel has no "
            "backward on the card (ROADMAP.md queue A item 14); run the "
            "pass under torch.no_grad(), or on the CPU, where the plain "
            "version differentiates")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; False when all lie on one
    CUDA device, or all on the meta device (the CUDA branch, launching
    nothing); raise on a mix or on another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    if kinds == {"meta"}:
        return False
    raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}: "
                     "the kernels take tensors all on one CUDA device or "
                     "all on the CPU (or all on the meta device)")


def _check(name: str, tensors: Sequence[torch.Tensor],
           hd: Optional[int] = None) -> int:
    """The kernel's dtype code for ``tensors`` (one dtype, fp32 or bf16,
    all contiguous), and, for attention, a head dim it takes."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if hd is not None and hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    return _DTYPES[dtype]


def _check_split(name: str, q: torch.Tensor, kv: Sequence[torch.Tensor],
                 hd: int) -> int:
    """The dtype code of a decode-side kernel: q fp32 or bf16; K/V in
    q's dtype (code 0 or 1) or in e4m3 (2 or 3); all contiguous."""
    dt = _check(name, (q,), hd)
    kv_dtype = kv[0].dtype
    if kv_dtype not in (q.dtype, _E4M3):
        raise TypeError(f"{name}: K/V dtype {kv_dtype} under a {q.dtype} "
                        f"query (the query's dtype or {_E4M3})")
    for t in kv:
        if t.dtype != kv_dtype:
            raise TypeError(f"{name}: mixed K/V dtypes {t.dtype} and "
                            f"{kv_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dt + (2 if kv_dtype == _E4M3 else 0)


def _int32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int32).contiguous()


def _flash_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> tuple:
    """``(B, S, H, KV, hd)`` of a flash call; raises where q ``(B,S,H,hd)``
    and k/v ``(B,S,KV,hd)`` do not fit."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not fit")
    return B, S, H, KV, hd


class _FlashAttention(CudaKernel):
    @_observed
    def __call__(self, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        """Causal GQA attention: q ``(B,S,H,hd)``, k/v ``(B,S,KV,hd)``.
        Where grad is enabled and an input requires it, through
        :class:`_FlashFunction` (the backward kernel on the card)."""
        if _on_cpu(q, k, v):
            return self.plain(q, k, v)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashFunction.apply(self, q, k, v)
        return self.run(q, k, v)

    def run(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One launch on CUDA tensors; with ``lse`` (``(B, H, S)`` fp32)
        also each row's log-sum-exp of its scaled scores."""
        B, S, H, KV, hd = _flash_shapes(self.name, q, k, v)
        dt = _check(self.name, (q, k, v), hd)
        if lse is not None and (lse.shape != (B, H, S)
                                or lse.dtype != torch.float32
                                or not lse.is_contiguous()):
            raise ValueError("flash_attention: lse must be a contiguous "
                             f"({B}, {H}, {S}) float32 tensor")
        out = torch.empty_like(q)
        if out.numel():
            self._launch((q, k, v, out, lse), (B, S, H, KV, hd, dt))
        return out

    def cost(self, ptrs, ints):
        return R.flash_cost(*ints[:5], ptrs[0].dtype, lse=ptrs[4] is not None)


class _FlashFunction(torch.autograd.Function):
    """Flash attention with its backward on the card: the forward keeps
    q, k, v, the output and each row's log-sum-exp; the backward launches
    :data:`flash_attention_bwd` (looked up at each call)."""

    @staticmethod
    def forward(ctx, kernel, q, k, v):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = kernel.run(q, k, v, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (None, *flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                           lse))


class _FlashAttentionBwd(CudaKernel):
    """The gradient of causal GQA flash attention: a pre-pass for
    ``rowsum(dO * O)``, a dK/dV kernel and a dQ kernel queued by one C
    call (one launch counted)."""

    @_observed
    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, dout: torch.Tensor,
                 lse: torch.Tensor) -> tuple:
        """``(dq, dk, dv)`` of ``out = flash_attention(q, k, v)`` for the
        output's gradient ``dout``; ``lse`` ``(B, H, S)`` fp32 is the
        forward's.  On the CPU the plain version (autograd of the plain
        forward) ignores ``out`` and ``lse``."""
        if _on_cpu(q, k, v, out, dout, lse):
            return self.plain(q, k, v, dout)
        B, S, H, KV, hd = _flash_shapes(self.name, q, k, v)
        dt = _check(self.name, (q, k, v, out, dout), hd)
        if out.shape != q.shape or dout.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} "
                             f"and dout {tuple(dout.shape)} must be q's "
                             f"{tuple(q.shape)}")
        if (lse.shape != (B, H, S) or lse.dtype != torch.float32
                or not lse.is_contiguous()):
            raise ValueError("flash_attention_bwd: lse must be a contiguous "
                             f"({B}, {H}, {S}) float32 tensor")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if q.numel():
            delta = torch.empty((B, H, S), dtype=torch.float32,
                                device=q.device)
            self._launch((q, k, v, out, dout, lse, dq, dk, dv, delta),
                         (B, S, H, KV, hd, dt))
        return dq, dk, dv

    def cost(self, ptrs, ints):
        return R.flash_bwd_cost(*ints[:5], ptrs[0].dtype)


class _ChunkedPrefillAttention(CudaKernel):
    @_observed
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

    def cost(self, ptrs, ints):
        """The full prefix: on meta the lengths are not known."""
        return R.chunked_prefill_cost(*ints[:6], ptrs[0].dtype)


class _PagedDecodeAttention(_SplitDecode):
    @_observed
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
        dt = _check_split(self.name, q, (k_pool, v_pool), hd)
        table = _int32(page_table, q.device)
        lens = _int32(cache_len, q.device)
        out = torch.empty_like(q)
        if out.numel() and n_slots:
            part = self.partials(B, KV, n_slots * page, H // KV, hd, q.device)
            ints = (B, H, KV, page, n_pages, n_slots, hd, dt)
            self._launch((q, k_pool, v_pool, table, lens, out, part),
                         ints + (part.numel(),), key=ints)
        return out

    def cost(self, ptrs, ints):
        """Every row at the table's capacity: on meta the lengths are
        not known."""
        B, H, KV, page, _, n_slots, hd = ints[:7]
        return R.paged_decode_cost(B, H, KV, hd, page, n_slots,
                                   ptrs[0].dtype, ptrs[1].dtype)


class _SpecVerifyAttention(_SplitDecode):
    @_observed
    def __call__(self, q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, page_table: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
        """A window of K queries ``(B,K,H,hd)`` over pool ``(n_pages,page,
        KV,hd)`` through ``page_table (B,n_slots)``; ``cache_len (B,)`` is
        the length before the window, and query ``j`` sees positions
        ``< cache_len + j + 1``.  A window of more than
        :data:`SPEC_MAX_ROWS` query rows ``K * H / KV`` goes in
        sub-windows of ``SPEC_MAX_ROWS // (H / KV)`` positions, one launch
        each, sub-window ``[k0, k1)`` with ``cache_len + k0``: a row's fold
        does not depend on the other rows, so its bits do not change."""
        if _on_cpu(q, k_pool, v_pool, page_table, cache_len):
            return self.plain(q, k_pool, v_pool, page_table, cache_len)
        B, K, H, hd = q.shape
        n_pages, page, KV, _ = k_pool.shape
        n_slots = page_table.shape[1]
        if (k_pool.shape[3] != hd or v_pool.shape != k_pool.shape
                or page_table.shape != (B, n_slots) or cache_len.shape != (B,)
                or H % KV or H // KV > SPEC_MAX_ROWS):
            raise ValueError("spec_verify_attention: shapes do not fit")
        dt = _check_split(self.name, q, (k_pool, v_pool), hd)
        table = _int32(page_table, q.device)
        lens = _int32(cache_len, q.device)
        out = torch.empty_like(q)
        if not (out.numel() and n_slots):
            return out
        step = SPEC_MAX_ROWS // (H // KV)
        if K <= step:
            self._window(q, k_pool, v_pool, table, lens, out, dt)
            return out
        for k0 in range(0, K, step):
            k1 = min(K, k0 + step)
            sub = torch.empty_like(q[:, k0:k1])
            self._window(q[:, k0:k1].contiguous(), k_pool, v_pool, table,
                         lens + k0, sub, dt)
            out[:, k0:k1] = sub
        return out

    def _window(self, q, k_pool, v_pool, table, lens, out, dt) -> None:
        """One launch over a window of at most :data:`SPEC_MAX_ROWS` rows."""
        B, K, H, hd = q.shape
        n_pages, page, KV, _ = k_pool.shape
        n_slots = table.shape[1]
        part = self.partials(B, KV, n_slots * page, K * (H // KV), hd,
                             q.device)
        ints = (B, K, H, KV, page, n_pages, n_slots, hd, dt)
        self._launch((q, k_pool, v_pool, table, lens, out, part),
                     ints + (part.numel(),), key=ints)

    def cost(self, ptrs, ints):
        """Every window ending at the table's last position: on meta the
        lengths are not known."""
        B, K, H, KV, page, _, n_slots, hd = ints[:8]
        return R.spec_verify_cost(B, K, H, KV, hd, page, n_slots,
                                  ptrs[0].dtype, ptrs[1].dtype)


class _DecodeAttention(_SplitDecode):
    @_observed
    def __call__(self, q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
        """One query ``(B,1,H,hd)`` over a dense cache ``(B,Skv,KV,hd)``
        masked by ``cache_len (B,)``."""
        if _on_cpu(q, k_cache, v_cache, cache_len):
            return self.plain(q, k_cache, v_cache, cache_len)
        B, one, H, hd = q.shape
        Skv, KV = k_cache.shape[1], k_cache.shape[2]
        if (one != 1 or k_cache.shape != (B, Skv, KV, hd)
                or v_cache.shape != k_cache.shape or cache_len.shape != (B,)
                or H % KV or H // KV > 32):
            raise ValueError("decode_attention: shapes do not fit "
                             "(or more than 32 query heads per KV head)")
        dt = _check_split(self.name, q, (k_cache, v_cache), hd)
        lens = _int32(cache_len, q.device)
        out = torch.empty_like(q)
        if out.numel() and Skv:
            part = self.partials(B, KV, Skv, H // KV, hd, q.device)
            ints = (B, H, KV, Skv, hd, dt)
            self._launch((q, k_cache, v_cache, lens, out, part),
                         ints + (part.numel(),), key=ints)
        return out

    def cost(self, ptrs, ints):
        """Every row over the whole cache: on meta the lengths are not
        known."""
        B, H, KV, Skv, hd = ints[:5]
        return R.decode_attention_cost(B, H, KV, hd, Skv, ptrs[0].dtype,
                                       ptrs[1].dtype)


class _TopkSimilarity(CudaKernel):
    """The kernel splits N across blocks and merges each row's split lists
    in the same C call (one launch counted); the wrapper allocates the
    split lists."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._plans = {}   # (device, M, N, k') -> (splits, columns a split)

    def plan(self, M: int, N: int, kk: int, device) -> tuple:
        """``(splits, columns a split)`` of an ``(M, N, k')`` call on
        ``device``: chosen by the kernel from the shape and the card's
        resident blocks; no result depends on it.  On meta,
        :func:`_topk_plan_meta`."""
        if device.type == "meta":
            return _topk_plan_meta(M, N, kk)
        key = (device, M, N, kk)
        if key not in self._plans:
            fn = self._lib().repro_topk_plan
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = (ctypes.c_int * 2)()
            with torch.cuda.device(device):
                rc = fn(M, N, kk, out)
            if rc != 0:
                raise DeviceError(f"{self.name} plan failed: CUDA error {rc}")
            self._plans[key] = (out[0], out[1])
        return self._plans[key]

    @_observed
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
            splits, _ = self.plan(M, N, kk, e1.device)
            pidx = psim = None
            if splits > 1:
                pidx = torch.empty(splits * M * kk, dtype=torch.int32,
                                   device=e1.device)
                psim = torch.empty(splits * M * kk, dtype=torch.float32,
                                   device=e1.device)
            self._launch((e1, e2, idx, sim, pidx, psim),
                         (M, N, D, kk, 0 if pidx is None else pidx.numel()),
                         key=(M, N, D, kk))
        return idx, sim

    def cost(self, ptrs, ints):
        return R.topk_cost(*ints[:4])


def _topk_plan_meta(M: int, N: int, kk: int) -> tuple:
    """``pick_splits`` of csrc/topk_sim.cu on an H100's SMs at the blocks
    per SM its launch bounds promise (2 for the wide body, k' <= 64; 1
    for the deep one): the card's occupancy may allow more blocks, and
    so fewer splits, than this plan of a meta call sizes scratch for."""
    bm, bn, min_blocks = (64, 128, 2) if kk <= 64 else (4, 256, 1)
    slots = H100_SMS * min_blocks
    row_blocks, n_tiles = -(-M // bm), -(-N // bn)
    best, best_cost = (1, n_tiles * bn), 1e30
    for splits in range(1, min(n_tiles, 64) + 1):
        tps = -(-n_tiles // splits)
        if -(-n_tiles // tps) != splits:
            continue
        cps = tps * bn
        if splits > 1 and (cps < kk or N - (splits - 1) * cps < kk):
            continue
        rounds = -(-(row_blocks * splits) // slots)
        cost = rounds * (tps + 0.3) + (0.05 if splits > 1 else 0.0)
        if cost < best_cost:
            best, best_cost = (splits, cps), cost
    return best


class _SsdScan(CudaKernel):
    """One C call queues the scan's kernels (C.B^T and the log-decay sums,
    then, over several chunks, the chunks' states and their serial
    carry, then y): one launch counted.  The wrapper keeps their scratch
    in one buffer per thread and device (``_scratch``), reused by every
    call.  A mamba2 pass makes one call a layer, so each call's checks and
    scratch size are looked up by its shapes and dtypes."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        #: shapes, dtypes and chunk -> (the launch's ints, scratch bytes)
        self._plans = {}

    def scratch_bytes(self, B: int, S: int, H: int, P: int, N: int,
                      chunk: int, meta: bool = False) -> int:
        """Bytes of scratch a call of these shapes needs (from the
        kernel; with ``meta``, from :meth:`meta_scratch_bytes`)."""
        if meta:
            n = self.meta_scratch_bytes(B, S, H, P, N, chunk)
            if n < 0:
                raise ValueError(f"{self.name}: shapes "
                                 f"{(B, S, H, P, N, chunk)} not taken")
            return n
        fn = getattr(self, "_scratch_fn", None)
        if fn is None:
            fn = self._scratch_fn = getattr(self._lib(),
                                            self.symbol + "_scratch")
            fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_longlong
        n = int(fn(B, S, H, P, N, chunk))
        if n < 0:
            raise ValueError(f"{self.name}: shapes {(B, S, H, P, N, chunk)} "
                             "not taken")
        return n

    @staticmethod
    def meta_scratch_bytes(B: int, S: int, H: int, P: int, N: int,
                           chunk: int) -> int:
        """``repro_ssd_scan_scratch`` (``plan`` in csrc/ssd_scan.cu) in
        Python, for meta calls: the fp64 log-decay sums, the C.B^T tile
        pairs and two sets of chunk states, each 256-byte aligned; -1 for
        shapes the kernel does not take."""
        if not _ssd_shape_ok(B, S, H, P, N, chunk):
            return -1
        n_chunks, n_tiles = S // chunk, -(-chunk // 64)
        pairs = n_tiles * (n_tiles + 1) // 2
        states = 4 * B * H * (n_chunks - 1) * SSD_MAX_N * SSD_MAX_P
        return (_round256(8 * B * H * S)
                + _round256(4 * B * n_chunks * pairs * 64 * 64)
                + _round256(states) + states)

    def _plan(self, key, x, dt, A, b, c, chunk) -> tuple:
        B, S, H, P = x.shape
        N = b.shape[-1]
        if (dt.shape != (B, S, H) or A.shape != (H,)
                or b.shape != (B, S, N) or c.shape != b.shape):
            raise ValueError(f"{self.name}: x {tuple(x.shape)}, dt "
                             f"{tuple(dt.shape)}, A {tuple(A.shape)}, b/c "
                             f"{tuple(b.shape)}/{tuple(c.shape)} do not fit")
        if P > SSD_MAX_P or N > SSD_MAX_N:
            raise ValueError(f"{self.name}: P {P} / N {N} above the kernel's "
                             f"caps of {SSD_MAX_P} / {SSD_MAX_N}")
        if dt.dtype != torch.float32 or A.dtype != torch.float32:
            raise TypeError(f"{self.name}: dt and A must be float32")
        dtype = _check(self.name, (x, b, c))
        chunk = L.pick_chunk(S, chunk) if S else chunk
        if chunk > SSD_MAX_CHUNK:
            raise ValueError(f"{self.name}: chunk {chunk} above the kernel's "
                             f"cap of {SSD_MAX_CHUNK}")
        ints = (B, S, H, P, N, chunk, dtype)
        nbytes = (self.scratch_bytes(*ints[:6], meta=x.is_meta)
                  if x.numel() else 0)
        plan = self._plans[key] = (ints, nbytes)
        return plan

    def _plan_of(self, x, dt, A, b, c, chunk) -> tuple:
        """``(ints, scratch bytes)`` of a call on CUDA tensors, checked
        once per shapes, dtypes and chunk; raises on inputs that are not
        contiguous."""
        key = (x.shape, dt.shape, A.shape, b.shape, c.shape, x.dtype,
               dt.dtype, A.dtype, b.dtype, c.dtype, chunk, x.is_meta)
        plan = (self._plans.get(key)
                or self._plan(key, x, dt, A, b, c, chunk))
        if not (x.is_contiguous() and dt.is_contiguous()
                and A.is_contiguous() and b.is_contiguous()
                and c.is_contiguous()):
            raise ValueError(f"{self.name}: inputs must be contiguous")
        return plan

    def _buffer(self, x: torch.Tensor, nbytes: int) -> torch.Tensor:
        """The calling thread's scratch on ``x``'s device (a card's, or
        meta), grown to ``nbytes``."""
        device = "meta" if x.is_meta else x.get_device()
        scratch = self._scratch
        buf = scratch.get(device)
        if buf is None or buf.numel() < nbytes:
            buf = scratch[device] = torch.empty(
                max(nbytes, 1), dtype=torch.uint8,
                device="meta" if x.is_meta else f"cuda:{device}")
        return buf

    @_observed
    def __call__(self, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *,
                 chunk: int = 256) -> torch.Tensor:
        """The SSD chunked scan: x ``(B,S,H,P)``, dt ``(B,S,H)`` fp32, A
        ``(H,)`` fp32, b/c ``(B,S,N)`` → y ``(B,S,H,P)`` in x's dtype,
        over chunks of ``pick_chunk(S, chunk)`` positions.  Where grad is
        enabled and an input requires it, through :class:`_SsdScanFunction`
        (the backward kernel on the card)."""
        d = x.get_device()   # -1 on the CPU
        if (d < 0 or dt.get_device() != d or A.get_device() != d
                or b.get_device() != d or c.get_device() != d):
            if _on_cpu(x, dt, A, b, c):
                return self.plain(x, dt, A, b, c, chunk)
        if torch.is_grad_enabled() and (
                x.requires_grad or dt.requires_grad or A.requires_grad
                or b.requires_grad or c.requires_grad):
            return _SsdScanFunction.apply(self, x, dt, A, b, c, chunk)
        return self.run(x, dt, A, b, c, chunk)

    def run(self, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
        """One launch on CUDA tensors of one device."""
        ints, nbytes = self._plan_of(x, dt, A, b, c, chunk)
        y = torch.empty_like(x)
        if nbytes:
            buf = self._buffer(x, nbytes)
            self._launch((x, dt, A, b, c, y, buf), ints + (buf.numel(),),
                         key=ints)
        return y

    def cost(self, ptrs, ints):
        return R.ssd_scan_cost(*ints[:6], ptrs[0].dtype)


class _SsdScanFunction(torch.autograd.Function):
    """The SSD scan with its backward on the card: the forward keeps its
    inputs (the backward recomputes the chunk states from them) and
    launches the scan; the backward launches :data:`ssd_scan_bwd` (looked
    up at each call)."""

    @staticmethod
    def forward(ctx, kernel, x, dt, A, b, c, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, b, c)
        return kernel.run(x, dt, A, b, c, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, b, c = ctx.saved_tensors
        return (None, *ssd_scan_bwd(x, dt, A, b, c, dy.contiguous(),
                                    chunk=ctx.chunk), None)


class _SsdScanBwd(_SsdScan):
    """The gradient of the SSD scan: one C call queues its kernels (the
    log-decay sums, the recomputed states and the state gradients with
    their serial carries, the tile pairs, dx, dB/dC, then ddt and dA):
    one launch counted.  Its scratch is one buffer per thread and device,
    as the forward's."""

    @staticmethod
    def meta_scratch_bytes(B: int, S: int, H: int, P: int, N: int,
                           chunk: int) -> int:
        """``repro_ssd_scan_bwd_scratch`` (``plan`` in
        csrc/ssd_scan_bwd.cu) in Python, for meta calls; -1 for shapes the
        kernel does not take."""
        if not _ssd_shape_ok(B, S, H, P, N, chunk):
            return -1
        n_chunks, n_tiles = S // chunk, -(-chunk // 64)
        pairs = B * n_chunks * n_tiles * (n_tiles + 1) // 2
        groups = -(-H // 8)
        states = 4 * B * H * (n_chunks - 1) * SSD_MAX_N * SSD_MAX_P
        parts = [8 * B * H * S, states, states, 4 * pairs * 64 * 64,
                 4 * pairs * groups * 64 * 64, 8 * pairs * H * 64,
                 8 * pairs * H * 64, 4 * pairs * H * 64,
                 4 * B * S * groups * N, 4 * B * S * groups * N,
                 4 * B * H * S, 4 * B * H * S, 4 * B * H * S,
                 8 * B * n_chunks * H]
        return sum(_round256(n) for n in parts)

    @_observed
    def __call__(self, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 256) -> tuple:
        """``(dx, ddt, dA, db, dc)`` of ``y = ssd_scan(x, dt, A, b, c,
        chunk=chunk)`` for the output's gradient ``dy`` (x's shape and
        dtype), each in its input's dtype."""
        if _on_cpu(x, dt, A, b, c, dy):
            return self.plain(x, dt, A, b, c, dy, chunk)
        ints, nbytes = self._plan_of(x, dt, A, b, c, chunk)
        if dy.shape != x.shape or dy.dtype != x.dtype:
            raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                             f"is not x's {tuple(x.shape)} {x.dtype}")
        if not dy.is_contiguous():
            raise ValueError("ssd_scan_bwd: inputs must be contiguous")
        grads = tuple(torch.empty_like(t) for t in (x, dt, A, b, c))
        if nbytes:
            buf = self._buffer(x, nbytes)
            self._launch((x, dt, A, b, c, dy, *grads, buf),
                         ints + (buf.numel(),), key=ints)
        else:
            for g in grads:
                g.zero_()
        return grads

    def cost(self, ptrs, ints):
        return R.ssd_bwd_cost(*ints[:6], ptrs[0].dtype)


class _RmsNorm(CudaKernel):
    """A granite pass makes 81 of these calls, so the host work before the
    launch is two device tests, one cached lookup of the call's plan by
    its shapes and dtypes, the contiguity tests and the output's
    allocation, and the C entry point is called directly."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        #: (x.shape, weight.shape, x.dtype, weight.dtype) -> (rows, D,
        #: dtype code, weight dtype code), checked once
        self._plans = {}

    def _plan(self, x: torch.Tensor, weight: torch.Tensor) -> tuple:
        codes = _NORM_CODES.get((x.dtype, weight.dtype))
        if codes is None:
            raise TypeError(f"rmsnorm: dtypes {x.dtype} / {weight.dtype} not "
                            "supported (float32 or bfloat16)")
        D = x.shape[-1]
        if weight.shape != (D,):
            raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} does "
                             f"not fit x {tuple(x.shape)}")
        if D > NORM_MAX_D[codes[0]]:
            raise ValueError(f"rmsnorm: D {D} above the kernel's cap of "
                             f"{NORM_MAX_D[codes[0]]} for {x.dtype}")
        plan = (x.numel() // D if D else 0, D) + codes
        self._plans[(x.shape, weight.shape, x.dtype, weight.dtype)] = plan
        return plan

    @_observed
    def __call__(self, x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
        """``x * rsqrt(mean(x^2) + eps) * weight`` over the last axis in
        fp32, in x's dtype; x ``(..., D)``, weight ``(D,)``, each fp32 or
        bf16 and contiguous."""
        d = x.get_device()   # -1 on the CPU
        if d < 0 or weight.get_device() != d:
            if _on_cpu(x, weight):
                return self.plain(x, weight, eps)
        refuse_grad(self.name, (x, weight))
        plan = (self._plans.get((x.shape, weight.shape, x.dtype, weight.dtype))
                or self._plan(x, weight))
        if not (x.is_contiguous() and weight.is_contiguous()):
            raise ValueError("rmsnorm: inputs must be contiguous")
        out = torch.empty_like(x)
        if plan[0] and x.is_meta:
            self._meta_launch((x, weight, out), plan, (plan,))
        elif plan[0]:
            fn = self._fn or self._bind()
            rc = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), *plan,
                    eps, _raw_stream(d))
            if rc != 0:
                raise DeviceError(f"rmsnorm kernel launch failed: CUDA "
                                  f"error {rc}")
            self.count(1, (plan,))
        return out

    def cost(self, ptrs, ints):
        return R.rmsnorm_cost(ints[0], ints[1], ptrs[0].dtype, ptrs[1].dtype)


class _DecodeGemm(CudaKernel):
    """``x @ w`` with a result per row of x that does not depend on the
    other rows or their number (csrc/decode_gemm.cu), for one weight or
    for up to :data:`DECODE_MAX_GROUP` weights of one ``x`` in one launch
    (:meth:`group`).  A granite pass makes 161 calls for its 281
    products, so the wrapper keeps its host work small.  bf16 needs no
    scratch (the splits combine in the cluster's shared memory); fp32
    keeps its partials and counters in one pair of buffers per thread and
    device (``_scratch``), reused by every call."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._splits = {}     # fp32 (K, N) -> the kernel's K splits

    def splits(self, K: int, N: int, meta: bool = False) -> int:
        """K splits of an fp32 (K, N) product (sizes its partials); with
        ``meta``, :meth:`meta_splits`."""
        if meta:
            return self.meta_splits(K, N)
        n = self._splits.get((K, N))
        if n is None:
            fn = self._lib().repro_decode_gemm_splits
            fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
            n = self._splits[(K, N)] = int(fn(K, N))
        return n

    @staticmethod
    def meta_splits(K: int, N: int) -> int:
        """``splits_f32`` of csrc/decode_gemm.cu in Python, for meta
        calls: doubled up to 16 while the grid stays within 512 blocks of
        64 columns and each split keeps 4 k-tiles of 64."""
        n_tiles, k_tiles, s = -(-N // 64), -(-K // 64), 1
        while 2 * s <= 16 and 2 * s * n_tiles <= 512 and k_tiles >= 8 * s:
            s *= 2
        return s

    def _buffers(self, device, n_part: int):
        scratch = self._scratch
        part, counters = scratch.get(device, (None, None))
        if counters is None:   # zeroed once; the kernel resets its counters
            counters = torch.zeros(_GEMM_COUNTERS, dtype=torch.int32,
                                   device=device)
        if part is None or part.numel() < n_part:
            part = torch.empty(n_part, dtype=torch.float32, device=device)
        scratch[device] = (part, counters)
        return part, counters

    @_observed
    def __call__(self, x: torch.Tensor, w) -> torch.Tensor:
        """x ``(..., K)`` @ w ``(K, N)`` → ``(..., N)`` in x's dtype, fp32
        accumulation.  ``w`` is a contiguous ``(K, N)`` matrix, the
        transpose of a contiguous ``(N, K)`` one (``table.t()``), or an
        int8 ``QuantizedTensor`` of a ``(K, N)`` matrix."""
        return self.group(x, (w,))[0]

    @_observed
    def group(self, x: torch.Tensor, ws: Sequence) -> list:
        """``[x @ w for w in ws]`` in one launch: every ``w`` a ``(K, N_i)``
        weight of x's dtype and device, all contiguous or all transposed
        contiguous tables; or every ``w`` an int8 ``QuantizedTensor``
        (``q`` a contiguous ``(K, N_i)`` matrix, its fp32 scales ``s``
        of one column each, column ``n`` reading ``s[n % len(s)]``), for
        ``x @ deq(w, x.dtype)``: the kernel dequantizes each element as
        ``deq`` does, so the result has the bits of the dense call on
        the dequantized weight.  Each result's bits are those of its
        product alone.  On the card the rows go in blocks of
        :data:`DECODE_MAX_ROWS`, one launch each: a row's bits depend
        only on that row and on w, so the blocks change none."""
        n = len(ws)
        if not 0 < n <= DECODE_MAX_GROUP:
            raise ValueError(f"decode_gemm: {n} weights in a group "
                             f"(1 to {DECODE_MAX_GROUP})")
        quant = isinstance(ws[0], QuantizedTensor)
        if any(isinstance(w, QuantizedTensor) != quant for w in ws):
            raise TypeError("decode_gemm: a group is all int8 weights or "
                            "all dense ones")
        mats = [w.q for w in ws] if quant else ws
        # a decode pass makes 161 of these calls: one pass over the weights
        # (Tensor.size and get_device are the cheap accessors)
        K = x.size(-1)
        d = x.get_device()   # -1 on the CPU
        Ns = []
        for w in mats:
            if w.dim() != 2 or w.size(0) != K:
                raise ValueError(f"decode_gemm: x {tuple(x.shape)} and w "
                                 f"{tuple(w.shape)} do not fit")
            if quant and w.dtype != torch.int8:
                raise TypeError(f"decode_gemm: an int8 weight's payload is "
                                f"{w.dtype}")
            if not quant and w.dtype != x.dtype:
                raise TypeError(f"decode_gemm: mixed dtypes {x.dtype} and "
                                f"{w.dtype}")
            if w.get_device() != d:
                d = -2   # a mix: _on_cpu raises on it
            Ns.append(w.size(1))
        scales = [w.scale.reshape(-1) for w in ws] if quant else []
        if d < 0:
            if _on_cpu(x, *mats, *scales):
                return [self.plain(x, deq(w, x.dtype)) for w in ws]
        dt = _DTYPES.get(x.dtype)
        if dt is None:
            raise TypeError(f"decode_gemm: dtype {x.dtype} not supported "
                            "(float32 or bfloat16)")
        w_nk = 0 if mats[0].is_contiguous() else 1
        for w in mats:
            if not (w.is_contiguous() if w_nk == 0 else w.stride() == (1, K)):
                raise ValueError("decode_gemm: the weights must all be "
                                 "contiguous (K, N) matrices or all "
                                 "transposes of contiguous ones")
        NSs = [0] * n
        if quant:
            if w_nk:
                raise ValueError("decode_gemm: int8 weights are (K, N) "
                                 "matrices")
            for i, (s, N) in enumerate(zip(scales, Ns)):
                if (s.dtype != torch.float32 or not s.is_contiguous()
                        or s.get_device() != d or N % s.numel()):
                    raise ValueError(
                        f"decode_gemm: int8 scales {tuple(s.shape)} "
                        f"{s.dtype} for {N} columns (fp32, contiguous, a "
                        "divisor of N on the weight's device)")
                NSs[i] = s.numel()
        if K % 8 or any(N % (16 if quant else 8) for N in Ns):
            raise ValueError(f"decode_gemm: K {K} and N {Ns} must be "
                             f"multiples of 8 (N of {16 if quant else 8} "
                             "for int8 weights)")
        if not x.is_contiguous():
            raise ValueError("decode_gemm: x must be contiguous")
        M = x.numel() // K if K else 0
        lead = x.shape[:-1]
        ys = [torch.empty(lead + (N,), dtype=x.dtype, device=x.device)
              for N in Ns]
        if M == 0:
            return ys
        part = counters = None
        n_part = 0
        if dt == 0:   # fp32: partials for its largest split product
            rows = min(M, DECODE_MAX_ROWS)
            part, counters = self._buffers(
                x.device, max(self.splits(K, N, x.is_meta) * rows * N
                              for N in Ns))
            n_part = part.numel()
        pad = (None,) * (DECODE_MAX_GROUP - n)
        zeros = (0,) * (DECODE_MAX_GROUP - n)
        tail = (*zeros, *NSs, *zeros, n, w_nk, dt, int(quant), n_part,
                _GEMM_COUNTERS)
        # launches count under (M, K, N, layout, dtype code): 2 + x's code
        # for int8 weights
        code = dt + 2 * int(quant)
        wp = (*mats, *pad, *(scales or (None,) * n), *pad)
        if M <= DECODE_MAX_ROWS:   # every call of a decode or verify pass
            self._launch((x, *wp, *ys, *pad, part, counters),
                         (M, K, *Ns, *tail),
                         keys=[(M, K, N, w_nk, code) for N in Ns])
            return ys
        x2 = x.view(M, K)
        y2 = [y.view(M, N) for y, N in zip(ys, Ns)]
        for r0 in range(0, M, DECODE_MAX_ROWS):
            xb = x2[r0:r0 + DECODE_MAX_ROWS]
            rows = xb.shape[0]
            self._launch((xb, *wp, *[y[r0:r0 + rows] for y in y2],
                          *pad, part, counters), (rows, K, *Ns, *tail),
                         keys=[(rows, K, N, w_nk, code) for N in Ns])
        return ys

    def cost(self, ptrs, ints):
        M, K, n = ints[0], ints[1], ints[8]
        quant = ints[11]
        return R.decode_gemm_cost(M, K, ints[2:2 + n], ptrs[0].dtype,
                                  scales=ints[5:5 + n] if quant else None)


flash_attention = _FlashAttention(
    "flash_attention", "flash_attention", "repro_flash_attention",
    n_ptrs=5, n_ints=6, plain=L.flash_attention,
    replaces="src/repro/kernels/flash_attention.py:81")
chunked_prefill_attention = _ChunkedPrefillAttention(
    "chunked_prefill_attention", "chunked_prefill",
    "repro_chunked_prefill_attention", n_ptrs=7, n_ints=7,
    plain=L.chunked_prefill_attention,
    replaces="src/repro/kernels/chunked_prefill.py:110")
paged_decode_attention = _PagedDecodeAttention(
    "paged_decode_attention", "paged_decode_attention",
    "repro_paged_decode_attention", n_ptrs=7, n_ints=9,
    plain=L.paged_decode_attention,
    replaces="src/repro/kernels/paged_decode_attention.py:75")
topk_similarity = _TopkSimilarity(
    "topk_similarity", "topk_sim", "repro_topk_similarity", n_ptrs=6,
    n_ints=4, n_longs=1, plain=L.topk_similarity,
    replaces="src/repro/kernels/topk_sim.py:75")
spec_verify_attention = _SpecVerifyAttention(
    "spec_verify_attention", "spec_verify_attention",
    "repro_spec_verify_attention", n_ptrs=7, n_ints=10,
    plain=L.spec_verify_attention_paged,
    replaces="src/repro/kernels/spec_verify_attention.py:84")
decode_attention = _DecodeAttention(
    "decode_attention", "decode_attention", "repro_decode_attention",
    n_ptrs=6, n_ints=7, plain=L.decode_attention,
    replaces="src/repro/kernels/decode_attention.py:65")
ssd_scan = _SsdScan(
    "ssd_scan", "ssd_scan", "repro_ssd_scan", n_ptrs=7, n_ints=7, n_longs=1,
    plain=L.ssd_chunk_scan, replaces="src/repro/kernels/ssd_scan.py:65")
rmsnorm = _RmsNorm(
    "rmsnorm", "rmsnorm", "repro_rmsnorm", n_ptrs=3, n_ints=4, n_floats=1,
    plain=L.rms_norm, replaces="src/repro/kernels/rmsnorm.py:26")
decode_gemm = _DecodeGemm(
    "decode_gemm", "decode_gemm", "repro_decode_gemm", n_ptrs=12, n_ints=14,
    plain=L.matmul,
    replaces="none (the JAX package leaves these products to XLA): the "
             "repair of ROADMAP.md C1, greedy parity of speculative "
             "decoding on the card")
ssd_scan_bwd = _SsdScanBwd(
    "ssd_scan_bwd", "ssd_scan_bwd", "repro_ssd_scan_bwd", n_ptrs=12,
    n_ints=7, n_longs=1, plain=L.ssd_chunk_scan_bwd,
    replaces="none (the JAX package trains through XLA's autodiff of "
             "src/repro/models/mamba2.py:70 and gives "
             "src/repro/kernels/ssd_scan.py:65 no custom_vjp): the gradient "
             "of the ported scan kernel's function")
flash_attention_bwd = _FlashAttentionBwd(
    "flash_attention_bwd", "flash_attention_bwd",
    "repro_flash_attention_bwd", n_ptrs=10, n_ints=6,
    plain=L.flash_attention_bwd,
    replaces="none (the JAX package trains through XLA's attention and "
             "gives src/repro/kernels/flash_attention.py:81 no custom_vjp): "
             "the gradient of the ported flash kernel's function")

#: every kernel of the port: the three attention kernels of the paged
#: engine in the order the model reaches them, the prefilter's top-k, the
#: speculative verify and the dense engine's decode, the mamba2 scan,
#: RMSNorm, the decode and verify passes' GEMM, and training's flash and
#: scan backwards
KERNELS = (flash_attention, chunked_prefill_attention, paged_decode_attention,
           topk_similarity, spec_verify_attention, decode_attention,
           ssd_scan, rmsnorm, decode_gemm, flash_attention_bwd, ssd_scan_bwd)


def decode_linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` on the decode and verify passes (``x @ deq(w, x.dtype)``
    for an int8 ``w``): :data:`decode_gemm` (looked up at each call, so a
    run that swaps the module's kernels for their plain versions swaps
    this one too).  On the CPU exactly ``x @ w``, or ``x @ deq(w,
    x.dtype)``."""
    kernel = decode_gemm
    if isinstance(kernel, _DecodeGemm):
        return kernel(x, w)
    return kernel(x, deq(w, x.dtype))


def decode_linear_group(x: torch.Tensor, ws: Sequence) -> list:
    """``[decode_linear(x, w) for w in ws]`` on the decode and verify
    passes, in one launch of :data:`decode_gemm` (looked up at each call,
    as in :func:`decode_linear`); each result has the bits of
    ``decode_linear(x, w)``.  A group is all int8 or all dense."""
    kernel = decode_gemm
    if isinstance(kernel, _DecodeGemm):
        return kernel.group(x, ws)
    return [kernel(x, deq(w, x.dtype)) for w in ws]


def top1_similarity(e1: torch.Tensor, e2: torch.Tensor) -> tuple:
    """``(idx (M,) int32, sim (M,) fp32)``: column 0 of a k = 1
    :func:`topk_similarity`, as ``repro.kernels.topk_sim`` defines it."""
    idx, sim = topk_similarity(e1, e2, k=1)
    return idx[:, 0], sim[:, 0]


def scratch_buffers() -> list:
    """The persistent scratch tensors the wrappers hold now for the
    calling thread (the decode GEMM's fp32 partials and counters, the
    scan's buffer).  A wrapper replaces a buffer that a larger call
    outgrows; a CUDA graph captured with the old one keeps writing it, so
    the graph holds these (:class:`repro_torch.serve.graphs.PassGraph`)."""
    out = []
    for bufs in getattr(_local, "scratch", {}).values():
        for buf in bufs.values():
            out.extend(buf if isinstance(buf, tuple) else (buf,))
    return out


def thread_tally() -> Optional[collections.Counter]:
    """The calling thread's tally (:func:`counting_into`), or None."""
    return getattr(_local, "tally", None)


@contextlib.contextmanager
def counting_into(tally: collections.Counter):
    """Also count the calling thread's launches, by kernel name, into
    ``tally`` (a cluster replica's own counts) while the block runs."""
    prev = getattr(_local, "tally", None)
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = prev


def reset_launch_counts() -> None:
    with COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0
            k.shapes.clear()


def launch_counts() -> dict:
    with COUNT_LOCK:
        return {k.name: k.launches for k in KERNELS}
