"""Transformer blocks: pre-norm GQA attention with RoPE, a pre-norm
SwiGLU FFN and the MoE family's routed-expert FFN (specs + apply), after
``repro.models.blocks``.

Attention goes through the kernel wrappers of
:mod:`repro_torch.kernels.ops` with K/V unrepeated: on the card that is
the CUDA kernel, on the CPU its plain version.  The dense projections
and the MLP of prefill are ``torch.matmul``, as the JAX package leaves
them to XLA.  The decode and verify blocks (``decode=True``) take their
norms through ``ops.rmsnorm`` and their products through
``ops.decode_linear`` (``ops.decode_linear_group`` for the products that
share an input: q/k/v, and gate/up), whose result per row does not
depend on the number of rows: a verify pass over slots x K rows then gives each row
the bits of the decode step over slots rows that it replaces (on the
CPU both are the plain ``rms_norm`` and ``x @ w``).  ``cfg.use_pallas``
has no meaning here.

Int8 weights (:mod:`repro_torch.models.quant`) are dequantized at every
use site where the JAX package calls ``deq``: ``deq(w, x.dtype)`` before
the ``torch.matmul`` of a prefill-shaped pass; whole to the decode GEMM,
which dequantizes as it loads, on the decode and verify passes.  The MoE
block's expert products dequantize a bounded group of experts at a time
(:func:`expert_products`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import Spec
from repro_torch.models.quant import (QuantizedTensor, as_matrix, deq,
                                      is_quantized)

#: the most bytes one dequantized group of experts may take (a transient
#: of the MoE block's expert products, and of a captured pass's pool)
EXPERT_DEQ_BYTES = 2 ** 31


# ---------------------------------------------------------------------------
# Attention block (pre-norm, GQA + RoPE)
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    D, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    H = cfg.padded_heads  # TP head padding (see ModelConfig.head_pad_to)
    return {
        "norm": Spec((D,), ("embed",), init="ones"),
        "wq": Spec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((H, hd, D), ("heads", "head_dim", "embed")),
    }


def _head_mask(cfg: ModelConfig, dtype, device) -> Optional[torch.Tensor]:
    """(Hp,) mask zeroing padded heads' outputs."""
    if cfg.padded_heads == cfg.n_heads:
        return None
    return (torch.arange(cfg.padded_heads, device=device)
            < cfg.n_heads).to(dtype)


def row_ops(decode: bool):
    """``(norm, matmul)`` of a pass: the row-invariant kernels on the
    decode and verify passes, the plain ops on prefill."""
    if decode:
        return ops.rmsnorm, ops.decode_linear
    return L.rms_norm, torch.matmul


def _proj(x: torch.Tensor, ws, decode: bool = False) -> list:
    """``einsum("bsd,dhk->bshk")`` for each weight of ``ws``, one matmul
    each; on the decode and verify passes one grouped call of the decode
    GEMM for all of them."""
    B, S, D = x.shape
    ys = (ops.decode_linear_group(x, [as_matrix(w, D) for w in ws]) if decode
          else [x @ deq(w, x.dtype).reshape(D, -1) for w in ws])
    return [y.view(B, S, w.shape[1], w.shape[2]) for y, w in zip(ys, ws)]


def _qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
         decode: bool = False):
    xn = row_ops(decode)[0](x, p["norm"], cfg.norm_eps)
    q, k, v = _proj(xn, (p["wq"], p["wk"], p["wv"]), decode)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(cfg: ModelConfig, p, o: torch.Tensor,
              decode: bool = False) -> torch.Tensor:
    """Dead-head mask, then ``einsum("bshk,hkd->bsd")``."""
    mask = _head_mask(cfg, o.dtype, o.device)
    if mask is not None:
        o = o * mask[None, None, :, None]
    B, S, H, hd = o.shape
    o = o.reshape(B, S, H * hd)
    if decode:
        return ops.decode_linear(o, as_matrix(p["wo"], H * hd))
    return o @ deq(p["wo"], o.dtype).reshape(H * hd, -1)


def attn_apply(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
               *, return_kv: bool = False):
    """Full-sequence causal attention (bucketed prefill)."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = ops.flash_attention(q, k, v)
    out = _out_proj(cfg, p, o)
    if return_kv:
        return out, (k, v)
    return out


def attn_apply_chunked(cfg: ModelConfig, p, x: torch.Tensor,
                       positions: torch.Tensor, k_prefix: torch.Tensor,
                       v_prefix: torch.Tensor, prefix_len: torch.Tensor):
    """Chunked prefill: suffix tokens at absolute positions
    ``prefix_len + i`` attend to the gathered prefix K/V ``(B, P, KV,
    hd)`` and causally to each other.  Returns ``(out, (k, v))`` with the
    *suffix* K/V only."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = ops.chunked_prefill_attention(
        q, k, v, k_prefix.to(k.dtype).contiguous(),
        v_prefix.to(v.dtype).contiguous(), prefix_len)
    return _out_proj(cfg, p, o), (k, v)


def attn_decode(cfg: ModelConfig, p, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cache_len: torch.Tensor):
    """One-token attention against a dense cache ``(B, Skv, KV, hd)``.

    The new token's K/V are written in place at each row's ``cache_len``
    (a per-row point scatter; rows may be ragged).  A position past the
    cache writes its last slot, as ``dynamic_update_slice`` clamps in the
    JAX package; such a row is retired and its write masked.  Returns
    ``(out, k_cache, v_cache)``.
    """
    positions = cache_len[:, None]
    q, k, v = _qkv(cfg, p, x, positions, decode=True)
    rows = torch.arange(x.shape[0], device=x.device)
    at = (rows, cache_len.long().clamp(0, k_cache.shape[1] - 1))
    k_cache.index_put_(at, L.to_cache(k[:, 0], k_cache.dtype))
    v_cache.index_put_(at, L.to_cache(v[:, 0], v_cache.dtype))
    o = ops.decode_attention(q, k_cache, v_cache, cache_len + 1)
    return _out_proj(cfg, p, o, decode=True), k_cache, v_cache


def _write_window(cache: torch.Tensor, write_at: tuple, keep: torch.Tensor,
                  new: torch.Tensor) -> None:
    """Write a verify window's K or V ``(B, K, KV, hd)`` in place at the
    cells ``write_at`` (two ``(B, K)`` index tensors).  A cell that
    ``keep`` leaves out writes the value its target cell already holds,
    so the write has a fixed shape and changes no bit there."""
    new = torch.where(keep[..., None, None], L.to_cache(new, cache.dtype),
                      cache[write_at])
    cache.index_put_(write_at, new)


def attn_verify(cfg: ModelConfig, p, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cache_len: torch.Tensor,
                write_at: tuple, keep: torch.Tensor):
    """K-token speculative-verification attention against a dense cache.

    ``x``: (B, K, D), the window at positions ``cache_len + j``.  All K
    tokens' K/V are written first, window cell ``(b, j)`` at cache cell
    ``(write_at[0][b, j], write_at[1][b, j])``; the cells ``keep`` leaves
    out (positions at or past the cache's end, which the JAX package
    drops with ``mode="drop"``) rewrite the value their target already
    holds (:func:`_write_window`).  Then each query ``j`` attends to
    positions ``< cache_len + j + 1`` through ``decode_attention`` called
    once per window position, as the Pallas branch of the JAX
    ``attn_verify`` does: the verify logits come from the same numeric
    path as the decode steps this engine would otherwise run.  Returns
    ``(out, k_cache, v_cache)``.
    """
    K = x.shape[1]
    positions = (cache_len[:, None]
                 + torch.arange(K, device=x.device, dtype=cache_len.dtype))
    q, k, v = _qkv(cfg, p, x, positions, decode=True)
    _write_window(k_cache, write_at, keep, k)
    _write_window(v_cache, write_at, keep, v)
    o = torch.cat(
        [ops.decode_attention(q[:, j:j + 1].contiguous(), k_cache, v_cache,
                              cache_len + j + 1) for j in range(K)], dim=1)
    return _out_proj(cfg, p, o, decode=True), k_cache, v_cache


def attn_decode_paged(cfg: ModelConfig, p, x: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      page_table: torch.Tensor, cache_len: torch.Tensor,
                      write_page: torch.Tensor, write_off: torch.Tensor):
    """One-token attention through a per-row page table.

    ``x``: (B, 1, D); ``k_pool``/``v_pool``: this layer's pool ``(n_pages,
    page, KV, hd)``; the new token's K/V lands at ``(write_page,
    write_off)`` (the engine routes inactive rows to its dump page).
    Returns ``(out, k_pool, v_pool)``.
    """
    positions = cache_len[:, None]
    q, k, v = _qkv(cfg, p, x, positions, decode=True)
    # The append is an in-place index_put_ into the engine's pool: the
    # JAX engine donates the pool to the jitted decode step for the same
    # effect (engine.py:471-478) -- one copy of the KV cache, never two.
    k_pool.index_put_((write_page, write_off), L.to_cache(k[:, 0],
                                                          k_pool.dtype))
    v_pool.index_put_((write_page, write_off), L.to_cache(v[:, 0],
                                                          v_pool.dtype))
    o = ops.paged_decode_attention(q, k_pool, v_pool, page_table,
                                   cache_len + 1)
    return _out_proj(cfg, p, o, decode=True), k_pool, v_pool


def attn_verify_paged(cfg: ModelConfig, p, x: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      page_table: torch.Tensor, cache_len: torch.Tensor,
                      write_at: tuple, keep: torch.Tensor):
    """K-token speculative-verification attention through a per-row page
    table.

    ``x``: (B, K, D), the window at positions ``cache_len + j``.  Window
    cell ``(b, j)`` writes its K/V in place at pool cell ``(write_at[0][b,
    j], write_at[1][b, j])`` (page, offset); the engine pre-extends each
    row's pages over its window.  The cells ``keep`` leaves out (past the
    table's capacity: the JAX package routes them to the out-of-range
    page ``n_pages`` and drops them) rewrite the value their target
    already holds (:func:`_write_window`).  Attention then reads through
    the table, causal inside the window (the ``spec_verify_attention``
    kernel).  Returns ``(out, k_pool, v_pool)``.
    """
    K = x.shape[1]
    positions = (cache_len[:, None]
                 + torch.arange(K, device=x.device, dtype=cache_len.dtype))
    q, k, v = _qkv(cfg, p, x, positions, decode=True)
    _write_window(k_pool, write_at, keep, k)
    _write_window(v_pool, write_at, keep, v)
    o = ops.spec_verify_attention(q, k_pool, v_pool, page_table, cache_len)
    return _out_proj(cfg, p, o, decode=True), k_pool, v_pool


# ---------------------------------------------------------------------------
# Dense FFN block (pre-norm SwiGLU)
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Spec]:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    return {
        "norm": Spec((D,), ("embed",), init="ones"),
        "w_gate": Spec((D, F), ("embed", "mlp")),
        "w_up": Spec((D, F), ("embed", "mlp")),
        "w_down": Spec((F, D), ("mlp", "embed")),
    }


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor,
              decode: bool = False) -> torch.Tensor:
    """The SwiGLU FFN; on the decode and verify passes the gate and up
    products are one grouped call of the decode GEMM."""
    xn = row_ops(decode)[0](x, p["norm"], cfg.norm_eps)
    if not decode:
        return L.swiglu(xn, deq(p["w_gate"], xn.dtype),
                        deq(p["w_up"], xn.dtype), deq(p["w_down"], xn.dtype))
    g, u = ops.decode_linear_group(xn, (p["w_gate"], p["w_up"]))
    return ops.decode_linear(L.swiglu_gate(g, u), p["w_down"])


# ---------------------------------------------------------------------------
# MoE FFN block -- GShard-style token-dropping dispatch
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs = {
        "norm": Spec((D,), ("embed",), init="ones"),
        "router": Spec((D, E), ("embed", "experts"), scale=0.02),
        "w_gate": Spec((E, D, F), ("experts", "embed", "expert_mlp")),
        "w_up": Spec((E, D, F), ("experts", "embed", "expert_mlp")),
        "w_down": Spec((E, F, D), ("experts", "expert_mlp", "embed")),
    }
    if cfg.moe_dense_residual:  # arctic: parallel dense FFN
        specs["dense"] = mlp_specs(cfg)
    return specs


def moe_groups(cfg: ModelConfig, T: int) -> Tuple[int, int]:
    """``(G, C)`` of a pass over ``T`` tokens: ``cfg.moe_groups`` or one
    group per 512 tokens, lowered until it divides ``T``, and each
    expert's capacity ``ceil(N k capacity_factor / E)`` in a group of
    ``N = T / G`` tokens."""
    G = cfg.moe_groups or max(1, T // 512)
    while T % G:
        G -= 1
    N = T // G
    C = math.ceil(N * cfg.experts_per_token * cfg.capacity_factor
                  / cfg.n_experts)
    return G, max(int(C), 1)


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """The ``k`` largest of each row of ``gates (..., E)`` in descending
    order, equal values to the lower index, as ``jax.lax.top_k`` takes
    them → ``(values, indices)`` ``(..., k)``.  Each entry's rank is the
    count of entries ahead of it; the entry of rank ``j`` is choice
    ``j``.  Elementwise ops and sums only (a sort copies its input with
    a device-to-device memcpy, which a CUDA graph replays as a kernel of
    another name)."""
    E = gates.shape[-1]
    idx = torch.arange(E, device=gates.device)
    row, col = gates[..., :, None], gates[..., None, :]
    ahead = (col > row) | ((col == row) & (idx[None, :] < idx[:, None]))
    rank = ahead.sum(dim=-1)                                  # (..., E)
    pick = rank[..., None] == torch.arange(k, device=gates.device)
    # one entry of each column is picked: the sums are exact
    values = (gates[..., None] * pick).sum(dim=-2)
    indices = (idx[:, None] * pick).sum(dim=-2)
    return values, indices


def moe_dispatch(cfg: ModelConfig, gates: torch.Tensor, C: int):
    """The capacity assignment of ``gates (G, N, E)`` fp32 →
    ``(dispatch, combine, keep)``: ``dispatch``/``combine`` ``(G, N, E,
    C)`` (combine weighted by the renormalised top-k gates) and ``keep``
    ``(G, N * k, E)``, the routed choices that found a slot.

    Each token takes its top ``k`` experts, ties to the lower index
    (:func:`top_k`); choices take slots in token-major, choice-major
    order through an exclusive cumsum, and a choice past ``C`` is
    dropped.  Every step is a fixed-shape tensor op (one-hots by
    comparison with an ``arange``), so a captured pass holds it."""
    G, N, E = gates.shape
    k = cfg.experts_per_token
    topv, topi = top_k(gates, k)                             # (G,N,k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    experts = torch.arange(E, device=gates.device)
    flat = (topi[..., None] == experts).to(torch.float32).reshape(G, N * k, E)
    pos = torch.cumsum(flat, dim=1) - flat                  # exclusive
    keep = (pos < C).to(torch.float32) * flat               # (G,N*k,E)
    slots = torch.arange(C, device=gates.device, dtype=pos.dtype)
    slot = (pos[..., None] == slots).to(torch.float32)      # (G,N*k,E,C)
    dispatch = (keep[..., None] * slot).reshape(G, N, k, E, C)
    combine = (dispatch * topv[..., None, None]).sum(dim=2)
    return dispatch.sum(dim=2), combine, keep


def expert_products(p, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their slots ``xe (E, slots, D)`` →
    ``(E, slots, D)``: batched matmuls over all experts.  Int8 experts
    are dequantized a group at a time (as many experts as
    :data:`EXPERT_DEQ_BYTES` holds, at least one), so no dequantized
    transient is larger than that (jamba-1.5-large-398b: 5 of its 16
    experts' 403 MB in bf16)."""
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if not is_quantized(wg):
        return L.swiglu_gate(xe @ wg, xe @ wu) @ wd
    E, _, D = xe.shape
    step = max(1, EXPERT_DEQ_BYTES // (D * wg.shape[-1] * xe.element_size()))
    ye = torch.empty_like(xe)
    for e0 in range(0, E, step):
        e = slice(e0, min(E, e0 + step))

        def w(t):   # the group's experts, their shared scales broadcast
            return deq(QuantizedTensor(t.q[e], t.scale), xe.dtype)
        h = L.swiglu_gate(xe[e] @ w(wg), xe[e] @ w(wu))
        ye[e] = h @ w(wd)
    return ye


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor,
              decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with capacity-bounded one-hot dispatch →
    ``(out, aux)``, ``aux`` the Switch load-balance loss (fp32 scalar).

    The tokens of the whole pass are routed together (``moe_groups``), so
    a row's output depends on the pass's other rows, pad and inactive
    rows included.  The block's norm and the router product go through
    :func:`row_ops` (the row-invariant kernels on the decode and verify
    passes); the router's softmax is fp32.  ``dispatch`` and ``combine``
    are cast to ``x.dtype`` before their products, as the JAX package
    casts them (bf16 gate weights on the card).  The expert products are
    batched matmuls over all ``E`` experts and ``C`` slots, empty slots
    included (:func:`expert_products`).  arctic's dense residual is
    :func:`mlp_apply` on ``x``."""
    Bsz, S, D = x.shape
    T = Bsz * S
    E = cfg.n_experts
    G, C = moe_groups(cfg, T)
    N = T // G
    norm, mm = row_ops(decode)
    xg = norm(x, p["norm"], cfg.norm_eps).reshape(G, N, D)
    gates = torch.softmax(mm(xg, p["router"]).float(), dim=-1)  # (G,N,E)
    dispatch, combine, keep = moe_dispatch(cfg, gates, C)
    dt = x.dtype
    # "gnd,gnec->gecd": each group's slots gather their tokens
    xe = dispatch.to(dt).reshape(G, N, E * C).transpose(1, 2) @ xg
    xe = xe.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    ye = expert_products(p, xe).reshape(E, G, C, D).transpose(0, 1)
    # "gecd,gnec->gnd": each token sums its slots' outputs
    y = combine.to(dt).reshape(G, N, E * C) @ ye.reshape(G, E * C, D)
    out = y.reshape(Bsz, S, D)
    # Switch aux loss: E * sum_e (share routed to e) * (mean gate of e)
    k = cfg.experts_per_token
    frac = keep.reshape(G, N, k, E).sum(dim=(1, 2)) / (N * k)  # (G,E)
    aux = E * torch.mean(torch.sum(frac * gates.mean(dim=1), dim=-1))
    if cfg.moe_dense_residual:
        out = out + mlp_apply(cfg, p["dense"], x, decode)
    return out, aux
