"""Decoder assembly of the dense family, after ``repro.models.model``.

Public surface (plain functions of ``(cfg, params, ...)``):

* :func:`model_specs`     — parameter spec tree (scan-stacked layers)
* :func:`cache_specs`     — cache tree, dense or paged
* :func:`prefill`         — ragged bucketed prefill → (cache, logits)
* :func:`chunked_prefill` — the uncached suffix over a gathered prefix;
  with ``paged=True`` it returns the suffix K/V only
* :func:`decode_step`     — one paged decode step with the ``active`` mask

The JAX package scans the stacked layer weights with ``lax.scan``; here a
Python loop takes layer ``i``'s views ``leaf[i]``.  Only the KV-only
dense family is ported; the others wait for later slices (ROADMAP.md
queue A items 10–12).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import Spec, stack_specs

def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"family {cfg.family!r} (input_mode {cfg.input_mode!r}) is not "
            "yet ported to repro_torch: MoE is ROADMAP.md queue A item 10, "
            "SSM/hybrid item 11, embedding inputs item 12")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_dense(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, Any] = {
        "embed": Spec((V, D), ("vocab", "embed"), scale=0.02),
        "final_norm": Spec((D,), ("embed",), init="ones"),
        "blocks": stack_specs({"attn": B.attn_specs(cfg),
                               "mlp": B.mlp_specs(cfg)}, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = Spec((V, D), ("vocab", "embed"), scale=0.02)
    return specs


def cache_specs(
    cfg: ModelConfig, batch: int, max_seq: int,
    *, page_size: Optional[int] = None, n_pages: Optional[int] = None,
) -> Dict[str, Any]:
    """Cache tree (Spec leaves).  With ``page_size``/``n_pages`` K/V live
    in one shared page pool ``(layers, n_pages, page, KV, hd)`` and each
    row carries a page table; otherwise rows are ``max_seq`` long."""
    _require_dense(cfg)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if page_size is not None:
        if n_pages is None:
            raise ValueError("paged cache_specs needs n_pages")
        kv = Spec((cfg.n_layers, n_pages, page_size, KV, hd),
                  ("layers", "pages", "page", "kv_heads", "head_dim"),
                  init="zeros")
        return {
            "len": Spec((batch,), (None,), init="zeros"),
            # ceil: a max_seq not divisible by the page size still needs
            # a table slot for its final, partial page
            "pages": Spec((batch, -(-max_seq // page_size)), (None, None),
                          init="zeros"),
            "k": kv, "v": kv,
        }
    kv = Spec((cfg.n_layers, batch, max_seq, KV, hd),
              ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
              init="zeros")
    return {"len": Spec((batch,), (None,), init="zeros"), "k": kv, "v": kv}


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _layer(params, i: int):
    """Layer ``i``'s weights: views into the stacked leaves."""
    return {blk: {name: w[i] for name, w in leaves.items()}
            for blk, leaves in params["blocks"].items()}


def _unembed_table(cfg: ModelConfig, params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _last_logits(cfg: ModelConfig, params, x: torch.Tensor,
                 valid_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Unembed each row's last valid position → (B, vocab) fp32."""
    Bsz, S = x.shape[0], x.shape[1]
    if valid_len is None:
        x_last = x[:, -1]
    else:
        idx = torch.clamp(valid_len.long() - 1, 0, S - 1)
        x_last = x[torch.arange(Bsz, device=x.device), idx]
    return L.unembed(x_last, _unembed_table(cfg, params))


def _cache_dtype(cfg: ModelConfig, x: torch.Tensor):
    if cfg.kv_cache_dtype != "auto":
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not yet ported")
    return x.dtype


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(
    cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], max_seq: int,
    valid_len: Optional[torch.Tensor] = None, all_logits: bool = False,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Process right-padded prompts; return ``(cache, logits)``.

    ``cache["k"/"v"]`` are ``(layers, B, max_seq, KV, hd)`` with the
    prompt's K/V at ``[0, S)``; ``valid_len`` (B,) makes ragged rows
    exact (causality keeps padding out of every valid position) and
    selects each row's last valid position for the logits.
    ``all_logits=True`` returns ``(B, S, vocab)`` instead.
    """
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = L.embed(tokens, params["embed"])
    Bsz, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(Bsz, S)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _cache_dtype(cfg, x)
    shape = (cfg.n_layers, Bsz, max_seq, KV, hd)
    ks = torch.zeros(shape, dtype=dt, device=x.device)
    vs = torch.zeros(shape, dtype=dt, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        out, (k, v) = B.attn_apply(cfg, lp["attn"], x, positions,
                                   return_kv=True)
        x = x + out
        ks[i, :, :S] = k
        vs[i, :, :S] = v
        x = x + B.mlp_apply(cfg, lp["mlp"], x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if all_logits:
        logits = L.unembed(x, _unembed_table(cfg, params))
    else:
        logits = _last_logits(cfg, params, x, valid_len)
    lens = (torch.full((Bsz,), S, dtype=torch.int32, device=x.device)
            if valid_len is None else valid_len.to(torch.int32))
    return {"k": ks, "v": vs, "len": lens}, logits


def chunked_prefill(
    cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], max_seq: int,
    valid_len: torch.Tensor, prefix_k: torch.Tensor, prefix_v: torch.Tensor,
    prefix_len: torch.Tensor, paged: bool = False, all_logits: bool = False,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Prefill only the uncached suffix of each prompt over gathered
    prefix K/V ``(layers, B, P, KV, hd)`` masked by ``prefix_len`` (B,).

    Suffix tokens sit at absolute positions ``prefix_len + i``.  With
    ``paged=True`` the cache holds the suffix K/V only, ``(layers, B, S,
    KV, hd)``, for the engine to page-scatter; ``len = prefix_len +
    valid_len``.
    """
    _require_dense(cfg)
    if not paged:
        raise NotImplementedError(
            "chunked_prefill(paged=False) builds dense slot rows for the "
            "dense-KV engine, which is not yet ported (ROADMAP.md queue A, "
            "left out of the first slice)")
    tokens = batch["tokens"]
    x = L.embed(tokens, params["embed"])
    Bsz, S = tokens.shape
    positions = (prefix_len.long()[:, None]
                 + torch.arange(S, device=x.device)[None])
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _cache_dtype(cfg, x)
    shape = (cfg.n_layers, Bsz, S, KV, hd)
    ks = torch.empty(shape, dtype=dt, device=x.device)
    vs = torch.empty(shape, dtype=dt, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        out, (k, v) = B.attn_apply_chunked(
            cfg, lp["attn"], x, positions, prefix_k[i], prefix_v[i],
            prefix_len)
        x = x + out
        ks[i] = k
        vs[i] = v
        x = x + B.mlp_apply(cfg, lp["mlp"], x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if all_logits:
        logits = L.unembed(x, _unembed_table(cfg, params))
    else:
        logits = _last_logits(cfg, params, x, valid_len)
    lens = (prefix_len + valid_len).to(torch.int32)
    return {"k": ks, "v": vs, "len": lens}, logits


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(
    cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor, active: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One greedy-decode step through page tables.  tokens: (B, 1).

    ``cache`` holds ``len`` (B,), ``pages`` (B, n_slots) and the pool
    ``k``/``v`` ``(layers, n_pages, page, KV, hd)``.  Each row's new K/V
    is appended **in place** into the page holding position ``len``
    (``index_put_``: the returned ``k``/``v`` are the same tensors);
    inactive rows, pointed by the engine at its dump page with
    ``len = 0``, keep their length.  Returns ``(cache', logits)``.
    """
    _require_dense(cfg)
    if "pages" not in cache:
        raise NotImplementedError(
            "dense-KV decode_step is not yet ported (the dense engine is "
            "left out of the first slice; see ROADMAP.md queue A)")
    x = L.embed(tokens, params["embed"])
    cache_len = cache["len"]
    k_pool, v_pool = cache["k"], cache["v"]
    page = k_pool.shape[2]
    page_table = cache["pages"]
    slot_idx = torch.clamp(cache_len.long() // page, 0,
                           page_table.shape[1] - 1)
    write_page = torch.gather(page_table.long(), 1, slot_idx[:, None])[:, 0]
    write_off = cache_len.long() % page
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        out, _, _ = B.attn_decode_paged(
            cfg, lp["attn"], x, k_pool[i], v_pool[i], page_table, cache_len,
            write_page, write_off)
        x = x + out
        x = x + B.mlp_apply(cfg, lp["mlp"], x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(x, _unembed_table(cfg, params))[:, 0]
    step = 1 if active is None else active.to(cache_len.dtype)
    new_cache = {"len": cache_len + step, "pages": page_table,
                 "k": k_pool, "v": v_pool}
    return new_cache, logits
