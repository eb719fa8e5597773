"""Transformer blocks of the dense family: pre-norm GQA attention with
RoPE and a pre-norm SwiGLU FFN (specs + apply), after
``repro.models.blocks``.

Attention goes through the kernel wrappers of
:mod:`repro_torch.kernels.ops` with K/V unrepeated: on the card that is
the CUDA kernel, on the CPU its plain version.  The dense projections,
the MLP and the unembed are ``torch.matmul``, as the JAX package leaves
them to XLA.  ``cfg.use_pallas`` has no meaning here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import Spec


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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, S, w.shape[1], w.shape[2])


def _qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q = L.apply_rope(_proj(xn, p["wq"]), positions, cfg.rope_theta)
    k = L.apply_rope(_proj(xn, p["wk"]), positions, cfg.rope_theta)
    v = _proj(xn, p["wv"])
    return q, k, v


def _out_proj(cfg: ModelConfig, p, o: torch.Tensor) -> torch.Tensor:
    """Dead-head mask, then ``einsum("bshk,hkd->bsd")``."""
    mask = _head_mask(cfg, o.dtype, o.device)
    if mask is not None:
        o = o * mask[None, None, :, None]
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, -1)


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
    q, k, v = _qkv(cfg, p, x, positions)
    # The append is an in-place index_put_ into the engine's pool: the
    # JAX engine donates the pool to the jitted decode step for the same
    # effect (engine.py:471-478) -- one copy of the KV cache, never two.
    k_pool.index_put_((write_page, write_off), k[:, 0].to(k_pool.dtype))
    v_pool.index_put_((write_page, write_off), v[:, 0].to(v_pool.dtype))
    o = ops.paged_decode_attention(q, k_pool, v_pool, page_table,
                                   cache_len + 1)
    return _out_proj(cfg, p, o), k_pool, v_pool


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


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
    return L.swiglu(xn, p["w_gate"], p["w_up"], p["w_down"])
