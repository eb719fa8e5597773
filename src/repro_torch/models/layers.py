"""Shared layers in plain PyTorch, and the plain versions of the eleven
kernels (five attention kernels and the flash backward, the prefilter's
top-k, the mamba2 SSD scan and its backward, RMSNorm and the decode
GEMM).

Conventions follow ``repro.models.layers``:

* activations ``(batch, seq, ...)``; matmuls in the activation dtype
  (bf16 on the card), norms, softmax and logits in fp32;
* GQA: K/V keep ``n_kv_heads`` heads; query head ``h`` reads KV head
  ``h // G`` with ``G = H / KV``.  Nothing is repeated to ``H`` heads.

The attention functions here are the *plain versions* of the hand-written
kernels in :mod:`repro_torch.kernels` — the same function in a few tensor
ops, with fp32 scores, an fp32 softmax and fp32 accumulation.  The
wrappers in :mod:`repro_torch.kernels.ops` call them for CPU tensors
only; ``chip_smoke.py`` holds each kernel against them on the card.  They
mirror ``repro.models.layers`` (``blockwise_causal_attention``,
``chunked_prefill_attention``, ``decode_attention``,
``paged_decode_attention``, ``spec_verify_attention(_paged)``,
``topk_similarity``) and ``repro.kernels.ref``;
:func:`flash_attention_bwd` is the plain version of the flash backward
kernel (autograd of :func:`flash_attention`).  :func:`rms_norm` is the
plain version of the RMSNorm kernel, :func:`ssd_chunk_scan` (after
``repro.models.mamba2._ssd_chunk_scan``) that of the SSD scan kernel,
:func:`ssd_chunk_scan_bwd` (its autograd) that of the scan's backward
kernel, and :func:`matmul` that of the decode GEMM.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# RMSNorm, RoPE, SwiGLU, embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs        # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D); w_gate/w_up: (D,F); w_down: (F,D)."""
    return swiglu_gate(x @ w_gate, x @ w_up) @ w_down


def swiglu_gate(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) * u``, the silu in fp32, in g's dtype: the hidden layer of
    :func:`swiglu` from its two products (the decode and verify passes
    take them from the decode GEMM)."""
    return F.silu(g.float()).to(g.dtype) * u


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: the plain version of the decode GEMM kernel."""
    return x @ w


#: e4m3's largest finite value is 448; the JAX package's cast (ml_dtypes)
#: rounds to nearest even and gives NaN above 464, the midpoint between
#: 448 and the next step, 480, where torch's own cast on the CPU saturates
#: to 448
E4M3_ROUNDS_FINITE = 464.0


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the KV cache stores it in ``dtype``: every write of K/V
    into a cache goes through here.  For e4m3 this is the JAX package's
    ``astype(float8_e4m3fn)`` bit for bit on either device: round to
    nearest even, and NaN (the sign kept) where ``|x| > 464`` in ``x``'s
    own dtype; other dtypes are a plain cast."""
    if x.dtype == dtype:
        return x
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    bits = y.view(torch.uint8)
    return torch.where(x.abs() > E4M3_ROUNDS_FINITE, bits | 0x7F,
                       bits).view(dtype)


#: the score of a masked-out logit (``repro.models.layers._NEG_INF``)
_NEG_INF = -1e30


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean NLL of ``labels (B, S)`` under ``logits (B, S, Vpad)`` fp32,
    the padded vocab past ``vocab_size`` masked to ``_NEG_INF`` (granite's
    49,155 -> 49,168), after ``repro.models.layers.cross_entropy``."""
    vpad = logits.shape[-1]
    if vpad > vocab_size:
        mask = torch.arange(vpad, device=logits.device) < vocab_size
        logits = torch.where(mask, logits, _NEG_INF)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits over the (possibly padded) vocab, returned in fp32.

    fp32 weights multiply in fp32; bf16 weights multiply in bf16 on the
    tensor cores (fp32 accumulation) and the result is widened."""
    return (x @ table.t()).float()


# ---------------------------------------------------------------------------
# Plain versions of the attention kernels
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention.  q: (B,S,H,hd); k/v: (B,S,KV,hd) (not
    repeated); returns (B,S,H,hd) in ``q.dtype``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor) -> tuple:
    """``(dq, dk, dv)`` of :func:`flash_attention` for the output's
    gradient ``dout``, by autograd of the plain forward: the plain version
    of the flash backward kernel."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*qkv)
        return torch.autograd.grad(out, qkv, dout)


def chunked_prefill_attention(
    q: torch.Tensor,           # (B, S, H, hd) — suffix queries
    k_suffix: torch.Tensor,    # (B, S, KV, hd)
    v_suffix: torch.Tensor,    # (B, S, KV, hd)
    k_prefix: torch.Tensor,    # (B, P, KV, hd) — gathered cached pages
    v_prefix: torch.Tensor,    # (B, P, KV, hd)
    prefix_len: torch.Tensor,  # (B,) int — valid cached tokens per row
) -> torch.Tensor:
    """Suffix queries over the valid cached prefix (``col < prefix_len``)
    and causally within the suffix (suffix-local coordinates).  One
    softmax spans both parts."""
    B, S, H, hd = q.shape
    KV = k_suffix.shape[2]
    P = k_prefix.shape[1]
    if P == 0:
        raise ValueError("P == 0: use flash_attention for the no-prefix case")
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, KV, G, hd)
    sp = torch.einsum("bqkgd,bpkd->bkgqp", qg, k_prefix.float()) * scale
    cols = torch.arange(P, device=q.device)
    pvalid = cols[None, :] < prefix_len.to(q.device)[:, None]     # (B, P)
    sp = sp.masked_fill(~pvalid[:, None, None, None, :], float("-inf"))
    ss = torch.einsum("bqkgd,bskd->bkgqs", qg, k_suffix.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    ss = ss.masked_fill(~causal, float("-inf"))
    p = torch.softmax(torch.cat([sp, ss], dim=-1), dim=-1)
    vall = torch.cat([v_prefix, v_suffix], dim=1).float()
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vall)
    return o.reshape(B, S, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """One query token against a dense cache masked by ``cache_len``.
    q: (B,1,H,hd); caches: (B,Skv,KV,hd); returns (B,1,H,hd)."""
    B, Skv, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    pos = torch.arange(Skv, device=q.device)
    valid = pos[None, :] < cache_len.to(q.device)[:, None]        # (B, Skv)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,           # (B, 1, H, hd)
    k_pool: torch.Tensor,      # (n_pages, page, KV, hd) — shared page pool
    v_pool: torch.Tensor,      # (n_pages, page, KV, hd)
    page_table: torch.Tensor,  # (B, n_slots) int — pool page per table slot
    cache_len: torch.Tensor,   # (B,) int — valid context length per row
) -> torch.Tensor:
    """One query token through a per-row page table.  Table slot ``i``
    holds positions ``[i·page, (i+1)·page)``; ids are clamped to
    ``[0, n_pages)`` and positions ``>= cache_len`` are masked."""
    n_pages, page, KV, hd = k_pool.shape
    B, n_slots = page_table.shape
    table = page_table.long().clamp(0, n_pages - 1)
    k = k_pool[table].reshape(B, n_slots * page, KV, hd)
    v = v_pool[table].reshape(B, n_slots * page, KV, hd)
    return decode_attention(q, k, v, cache_len)


def spec_verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          cache_len: torch.Tensor) -> torch.Tensor:
    """A window of K queries ``(B,K,H,hd)`` against a dense cache that
    already holds the window's K/V; ``cache_len (B,)`` is the length
    before the window.  Query ``j`` sees positions ``< cache_len + j +
    1``: a static loop over :func:`decode_attention`, so every window row
    is the single-token decode it replaces, bit for bit."""
    return torch.cat(
        [decode_attention(q[:, j:j + 1], k_cache, v_cache, cache_len + j + 1)
         for j in range(q.shape[1])], dim=1)


def spec_verify_attention_paged(
    q: torch.Tensor,           # (B, K, H, hd)
    k_pool: torch.Tensor,      # (n_pages, page, KV, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_slots) int
    cache_len: torch.Tensor,   # (B,) int — length BEFORE the window
) -> torch.Tensor:
    """The plain version of the ``spec_verify_attention`` kernel: a static
    loop over :func:`paged_decode_attention`, one window position at a
    time, so row ``j`` equals paged decode at ``cache_len + j + 1`` bit
    for bit."""
    return torch.cat(
        [paged_decode_attention(q[:, j:j + 1], k_pool, v_pool, page_table,
                                cache_len + j + 1)
         for j in range(q.shape[1])], dim=1)


# ---------------------------------------------------------------------------
# Plain version of the SSD scan kernel (mamba2)
# ---------------------------------------------------------------------------


def pick_chunk(seq_len: int, target: int = 512) -> int:
    """Largest divisor of ``seq_len`` that is <= target (>= 1)."""
    c = min(target, seq_len)
    while seq_len % c != 0:
        c -= 1
    return c


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   chunk: int = 256, *,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The Mamba2 SSD chunked scan, after ``mamba2._ssd_chunk_scan``: a
    loop over chunks of ``pick_chunk(S, chunk)`` positions, each with its
    intra-chunk quadratic term and the inter-chunk term of the ``(N, P)``
    state carried in fp32.

    x ``(B,S,H,P)``; dt ``(B,S,H)`` fp32 (post-softplus); A ``(H,)`` fp32
    (negative); b/c ``(B,S,N)``, one group shared by every head; y
    ``(B,S,H,P)`` in ``x.dtype``, as the XLA path returns it.

    Arithmetic in fp32, but for the log-decays: their running sum ``cum``
    reaches hundreds within a chunk of 256, and in fp32 each
    ``cum_i - cum_j`` would carry the rounding of two large sums (at
    mamba2-130m's widths that alone moves y by ~1.5e-3 against fp64
    arithmetic), so the sum and its differences are taken in fp64 and
    rounded to fp32 once, before the exp — as the kernel takes them.
    ``dtype=torch.float64`` takes everything in fp64: the oracle that
    the checks hold the fp32 gradients against.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    chunk = pick_chunk(S, chunk)
    xf, bf, cf = x.to(dtype), b.to(dtype), c.to(dtype)
    dt, A = dt.to(dtype), A.to(dtype)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]   # (1,c,c,1)
    h = torch.zeros((B, H, N, P), dtype=dtype, device=x.device)
    ys = []
    for s0 in range(0, S, chunk):
        xk = xf[:, s0:s0 + chunk]                 # (B,c,H,P)
        dtk = dt[:, s0:s0 + chunk]                # (B,c,H)
        bk, ck = bf[:, s0:s0 + chunk], cf[:, s0:s0 + chunk]   # (B,c,N)
        cum = torch.cumsum((dtk * A[None, None, :]).double(), dim=1)
        # L[i,j] = exp(cum_i - cum_j) for i >= j, else 0.  Mask BEFORE
        # exp: the upper triangle's positive differences overflow, and
        # inf * 0 is NaN
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).to(dtype)  # (B,c,c,H)
        Lm = torch.exp(diff.masked_fill(~causal, float("-inf")))
        cb = torch.einsum("bin,bjn->bij", ck, bk)             # (B,c,c)
        w = cb[..., None] * Lm * dtk[:, None, :, :]           # (B,c,c,H)
        y = torch.einsum("bijh,bjhp->bihp", w, xk)
        y = y + (torch.einsum("bin,bhnp->bihp", ck, h)
                 * torch.exp(cum.to(dtype))[..., None])
        # h' = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j B_j x_j
        w_state = torch.exp((cum[:, -1:, :] - cum).to(dtype)) * dtk  # (B,c,H)
        h = (h * torch.exp(cum[:, -1, :].to(dtype))[:, :, None, None]
             + torch.einsum("bjn,bjhp->bhnp", bk,
                            xk * w_state[..., None]))
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1)


def ssd_chunk_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                       chunk: int = 256) -> tuple:
    """``(dx, ddt, dA, db, dc)`` of :func:`ssd_chunk_scan` for the
    output's gradient ``dy``, by autograd of the plain forward (each in
    its input's dtype): the plain version of the scan's backward kernel.
    Autograd takes the log-decay terms in fp32 and sums them in fp64, as
    ``cum`` is fp64, and rounds their gradient to fp32 once."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, b, c)]
        y = ssd_chunk_scan(*ins, chunk)
        return torch.autograd.grad(y, ins, dy)


# ---------------------------------------------------------------------------
# Plain version of the top-k similarity kernel (embedding prefilter)
# ---------------------------------------------------------------------------


def topk_similarity(e1: torch.Tensor, e2: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k' = min(k, N)`` most similar rows of ``e2 (N, D)`` for every
    row of ``e1 (M, D)``: ``(idx (M, k') int32, sim (M, k') fp32)``,
    sorted by value descending with ties to the lower index.

    The fp32 dots are a rounded product then a rounded sum over ``d = 0,
    1, ..., D-1`` in order, one tensor op each, exactly as the kernel
    takes them: equal vectors give equal values (ties stay ties) and the
    kernel's values match bit for bit.  The order is then a *stable*
    descending sort, so ties go to the lower index; ``torch.topk`` leaves
    the order among equal values unspecified.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    a, b = e1.float(), e2.float()
    sim = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    for d in range(a.shape[1]):
        sim.add_(a[:, d, None] * b[None, :, d])
    vals, idx = torch.sort(sim, dim=1, descending=True, stable=True)
    kk = min(k, b.shape[0])
    return idx[:, :kk].to(torch.int32), vals[:, :kk].contiguous()
