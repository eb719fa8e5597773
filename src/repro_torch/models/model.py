"""Decoder assembly of the dense family, after ``repro.models.model``.

Public surface (plain functions of ``(cfg, params, ...)``):

* :func:`model_specs`     — parameter spec tree (scan-stacked layers)
* :func:`cache_specs`     — cache tree, dense or paged
* :func:`prefill`         — ragged bucketed prefill → (cache, logits)
* :func:`encode`          — mean-pooled final-norm hidden states, no cache
* :func:`chunked_prefill` — the uncached suffix over a gathered prefix;
  dense slot rows with the prefix copied in, or with ``paged=True`` the
  suffix K/V only
* :func:`decode_step`     — one decode step, dense or paged, with the
  ``active`` mask
* :func:`verify_step`     — one pass over a K-token speculative window,
  dense or paged

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


def _backbone(cfg: ModelConfig, params, x: torch.Tensor,
              positions: torch.Tensor, ks: Optional[torch.Tensor] = None,
              vs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layers over full sequences (causal, flash attention), then the
    final norm.  With ``ks``/``vs`` ``(layers, B, >= S, KV, hd)`` each
    layer's K/V land at ``[i, :, :S]``; without them nothing is kept."""
    S = x.shape[1]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        out, (k, v) = B.attn_apply(cfg, lp["attn"], x, positions,
                                   return_kv=True)
        x = x + out
        if ks is not None:
            ks[i, :, :S] = k
            vs[i, :, :S] = v
        x = x + B.mlp_apply(cfg, lp["mlp"], x)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Prefill and encode
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
    x = _backbone(cfg, params, x, positions, ks, vs)
    if all_logits:
        logits = L.unembed(x, _unembed_table(cfg, params))
    else:
        logits = _last_logits(cfg, params, x, valid_len)
    lens = (torch.full((Bsz,), S, dtype=torch.int32, device=x.device)
            if valid_len is None else valid_len.to(torch.int32))
    return {"k": ks, "v": vs, "len": lens}, logits


def encode(
    cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
    valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence embeddings: final-norm hidden states mean-pooled in fp32
    over each row's valid positions → ``(B, d_model)`` fp32.

    The same backbone as :func:`prefill` (so flash attention on the
    card), but no KV cache is allocated and nothing is unembedded: the
    serving tier's embedding surface (``Engine.embed_rows``).  Causality
    keeps right-padding out of every position ``< valid_len``, and only
    those are pooled.
    """
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = L.embed(tokens, params["embed"])
    Bsz, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(Bsz, S)
    xf = _backbone(cfg, params, x, positions).float()
    if valid_len is None:
        return xf.mean(dim=1)
    mask = (positions < valid_len.to(x.device)[:, None]).float()   # (B, S)
    denom = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    return (xf * mask[..., None]).sum(dim=1) / denom


def chunked_prefill(
    cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], max_seq: int,
    valid_len: torch.Tensor, prefix_k: torch.Tensor, prefix_v: torch.Tensor,
    prefix_len: torch.Tensor, paged: bool = False, all_logits: bool = False,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Prefill only the uncached suffix of each prompt over gathered
    prefix K/V ``(layers, B, P, KV, hd)`` masked by ``prefix_len`` (B,).

    Suffix tokens sit at absolute positions ``prefix_len + i``.  With
    ``paged=False`` (the dense engine) the cache is laid out as
    :func:`prefill`'s, ``(layers, B, max_seq, KV, hd)``: the gathered
    prefix at ``[0, P)``, each row's suffix written over it from its own
    ``prefix_len``.  With ``paged=True`` the cache holds the suffix K/V
    only, ``(layers, B, S, KV, hd)``, for the engine to page-scatter.
    Either way ``len = prefix_len + valid_len``.
    """
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = L.embed(tokens, params["embed"])
    Bsz, S = tokens.shape
    positions = (prefix_len.long()[:, None]
                 + torch.arange(S, device=x.device)[None])
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = _cache_dtype(cfg, x)
    shape = (cfg.n_layers, Bsz, S if paged else max_seq, KV, hd)
    ks = torch.empty(shape, dtype=dt, device=x.device)
    vs = torch.empty(shape, dtype=dt, device=x.device)
    rows = torch.arange(Bsz, device=x.device)[:, None]
    P = prefix_k.shape[2]

    def place(dst, suffix, prefix):
        """A dense slot row: prefix at [0, P), the suffix from each row's
        prefix_len on.  The scratch is max_seq + S long so a near-full
        row's suffix never falls off; positions past ``len`` are masked
        by decode."""
        buf = torch.zeros((Bsz, max_seq + S, KV, hd), dtype=dt,
                          device=x.device)
        buf[:, :P] = prefix
        buf[rows, positions] = suffix.to(dt)
        dst.copy_(buf[:, :max_seq])

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        out, (k, v) = B.attn_apply_chunked(
            cfg, lp["attn"], x, positions, prefix_k[i], prefix_v[i],
            prefix_len)
        x = x + out
        if paged:
            ks[i] = k
            vs[i] = v
        else:
            place(ks[i], k, prefix_k[i])
            place(vs[i], v, prefix_v[i])
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
    """One greedy-decode step.  tokens: (B, 1).

    Dense cache: ``len`` (B,) and rows ``k``/``v`` ``(layers, B, max_seq,
    KV, hd)``; each row's new K/V is written at its ``len``.  Paged cache:
    ``len``, ``pages`` (B, n_slots) and the pool ``k``/``v`` ``(layers,
    n_pages, page, KV, hd)``; the new K/V is appended into the page
    holding position ``len``.  Either way the write is **in place**
    (``index_put_``: the returned ``k``/``v`` are the same tensors), and
    rows with ``active`` False keep their length (the paged engine points
    them at its dump page with ``len = 0``; a dense row is overwritten
    when its slot is refilled).  Returns ``(cache', logits)``.
    """
    _require_dense(cfg)
    x = L.embed(tokens, params["embed"])
    cache_len = cache["len"]
    k_all, v_all = cache["k"], cache["v"]
    paged = "pages" in cache
    if paged:
        page = k_all.shape[2]
        page_table = cache["pages"]
        slot_idx = torch.clamp(cache_len.long() // page, 0,
                               page_table.shape[1] - 1)
        write_page = torch.gather(page_table.long(), 1,
                                  slot_idx[:, None])[:, 0]
        write_off = cache_len.long() % page
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if paged:
            out, _, _ = B.attn_decode_paged(
                cfg, lp["attn"], x, k_all[i], v_all[i], page_table,
                cache_len, write_page, write_off)
        else:
            out, _, _ = B.attn_decode(cfg, lp["attn"], x, k_all[i], v_all[i],
                                      cache_len)
        x = x + out
        x = x + B.mlp_apply(cfg, lp["mlp"], x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(x, _unembed_table(cfg, params))[:, 0]
    step = 1 if active is None else active.to(cache_len.dtype)
    new_cache = dict(cache, len=cache_len + step)
    return new_cache, logits


def verify_step(
    cfg: ModelConfig, params, cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Score a K-token speculative window in one pass.

    ``tokens``: (B, K), each row's window (the greedy token plus up to
    K - 1 drafted continuations, padded).  Every window token's K/V is
    written in place at positions ``len .. len + K - 1`` and the logits of
    every window position come back, ``(B, K, vocab)``: ``logits[:, j]``
    is the next-token distribution after tokens ``0..j``, attention being
    causal inside the window.  Positions the cache cannot hold (past
    ``max_seq`` on the dense cache, past the page table's capacity on the
    paged one) are not written, as the JAX package drops them.

    ``cache["len"]`` is **not** advanced: the engine commits the accepted
    prefix on the host (``Engine.commit_spec``); the rejected tail stays
    as masked garbage that the next write at those positions overwrites.
    """
    _require_dense(cfg)
    x = L.embed(tokens, params["embed"])
    K = tokens.shape[1]
    cache_len = cache["len"]
    k_all, v_all = cache["k"], cache["v"]
    pos = cache_len.long()[:, None] + torch.arange(K, device=x.device)[None]
    paged = "pages" in cache
    if paged:
        page = k_all.shape[2]
        page_table = cache["pages"]
        n_slots = page_table.shape[1]
        # the window cells the table can hold: one host sync a pass, so
        # that no layer indexes the pool out of range
        window_at = torch.nonzero(pos < n_slots * page, as_tuple=True)
        wpos = pos[window_at]
        write_at = (page_table.long()[window_at[0], wpos // page],
                    wpos % page)
    else:
        window_at = torch.nonzero(pos < k_all.shape[2], as_tuple=True)
        write_at = (window_at[0], pos[window_at])
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if paged:
            out, _, _ = B.attn_verify_paged(
                cfg, lp["attn"], x, k_all[i], v_all[i], page_table,
                cache_len, write_at, window_at)
        else:
            out, _, _ = B.attn_verify(cfg, lp["attn"], x, k_all[i], v_all[i],
                                      cache_len, write_at, window_at)
        x = x + out
        x = x + B.mlp_apply(cfg, lp["mlp"], x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(x, _unembed_table(cfg, params))   # (B, K, vocab)
    return dict(cache), logits
