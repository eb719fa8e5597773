"""Shared layers in plain PyTorch, and the plain versions of the four
kernels (three attention kernels and the prefilter's top-k).

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
``chunked_prefill_attention``, ``paged_decode_attention``,
``topk_similarity``) and ``repro.kernels.ref``.
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
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


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
