"""Decoder assembly of the dense, MoE, ssm, hybrid and embedding-input
families, after ``repro.models.model``.

Public surface (plain functions of ``(cfg, params, ...)``):

* :func:`model_specs`     — parameter spec tree (scan-stacked layers)
* :func:`forward`         — teacher-forcing logits over whole sequences
* :func:`cache_specs`     — cache tree: K/V (dense or paged), or the
  ssm family's conv and SSM states, or the hybrid family's K/V and states
* :func:`prefill`         — ragged bucketed prefill → (cache, logits)
* :func:`encode`          — mean-pooled final-norm hidden states, no cache
* :func:`chunked_prefill` — the uncached suffix over a gathered prefix;
  dense slot rows with the prefix copied in, or with ``paged=True`` the
  suffix K/V only
* :func:`decode_step`     — one decode step, dense, paged or SSM, with
  the ``active`` mask
* :func:`verify_step`     — one pass over a K-token speculative window,
  dense or paged

On the decode and verify passes every norm and dense product goes
through the row-invariant kernels (``ops.rmsnorm``,
``ops.decode_linear``): a dense-family row's logits do not depend on how
many rows the pass holds, so a verify window's rows equal the decode
steps they stand for, bit for bit, on the card as on the CPU.  The MoE
family routes the tokens of a whole pass together under a capacity
(:func:`blocks.moe_apply`), so its rows are coupled and a verify window
is not its decode steps, in the reference too (ROADMAP.md §C).

The JAX package scans the stacked layer weights with ``lax.scan``; here a
Python loop takes layer ``i``'s views ``leaf[i]``.  Ported families:
``dense`` (granite-3-2b, yi-9b, starcoder2-7b with its padded heads,
mistral-large-123b; attention layers over a KV cache, in the activation
dtype or, with ``cfg.kv_cache_dtype="float8_e4m3fn"``, in e4m3, every
write through :func:`layers.to_cache`), ``moe`` (grok-1-314b,
arctic-480b with its dense residual and padded heads: the dense layers
with the MoE block for the MLP), ``audio`` and ``vlm`` (musicgen-large,
pixtral-12b: the dense layers over ``batch["embeds"]`` in prefill,
``forward`` and ``encode``; decode and verify embed tokens, as in the
reference), ``ssm`` (mamba2-130m; Mamba2 layers over a conv and an SSM
state, which ``chunked_prefill`` and ``verify_step`` refuse as the JAX
package does) and ``hybrid`` (jamba-1.5-large-398b: superblocks of
``attn_period`` layers stacked twice, slot 0 attention over a dense KV
cache and the other slots Mamba2, the FFN dense on even slots and MoE on
odd ones; refused by ``chunked_prefill`` and ``verify_step`` as ssm is).
Any family runs on an int8 tree (:mod:`repro_torch.models.quant`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.params import Spec, stack_specs, tree_items, tree_map

#: Families whose per-request state is a pure KV cache — the only ones the
#: engine pages, prefix-caches and speculates for.  An SSM state (the
#: ssm and hybrid families) summarizes the whole prefix into a fixed-size
#: vector that cannot be re-anchored mid-sequence or rolled back
#: (``repro.models.model``).
KV_ONLY_FAMILIES = ("dense", "audio", "vlm", "moe")

#: the families the port runs, by input mode
_PORTED = {"tokens": ("dense", "moe", "ssm", "hybrid"),
           "embeddings": ("audio", "vlm")}

#: the K/V storage dtypes ``cfg.kv_cache_dtype`` may name besides "auto"
_KV_CACHE_DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn}


def _family(cfg: ModelConfig) -> str:
    """``cfg.family`` if the port runs it (``dense``, ``moe``, ``ssm`` or
    ``hybrid`` on token inputs, ``audio`` or ``vlm`` on embeddings);
    raises ``NotImplementedError`` otherwise."""
    if cfg.family in _PORTED.get(cfg.input_mode, ()):
        return cfg.family
    raise NotImplementedError(
        f"family {cfg.family!r} on input_mode {cfg.input_mode!r} is not "
        f"ported to repro_torch (ported: {_PORTED})")


def _require_kv(cfg: ModelConfig, what: str) -> None:
    if _family(cfg) not in KV_ONLY_FAMILIES:
        raise ValueError(
            f"{what} needs a KV-only cache; family {cfg.family!r} carries "
            "SSM state")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _superblock_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """One hybrid superblock of ``P = attn_period`` layers: slot 0
    attention, slots 1..P-1 mamba (stacked), the FFN dense on even slots
    and MoE on odd ones (each stacked)."""
    P = cfg.attn_period
    return {
        "attn": B.attn_specs(cfg),
        "mamba": stack_specs(M.mamba_specs(cfg), P - 1),
        "ffn_dense": stack_specs(B.mlp_specs(cfg), (P + 1) // 2),
        "ffn_moe": stack_specs(B.moe_specs(cfg), P // 2),
    }


def n_stacks(cfg: ModelConfig) -> int:
    """The stacked blocks: superblocks for the hybrid family, else
    layers."""
    if _family(cfg) == "hybrid":
        if cfg.n_layers % cfg.attn_period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"whole superblocks of {cfg.attn_period}")
        return cfg.n_layers // cfg.attn_period
    return cfg.n_layers


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.padded_vocab
    fam = _family(cfg)
    if fam == "ssm":
        block = {"mamba": M.mamba_specs(cfg)}
    elif fam == "moe":
        block = {"attn": B.attn_specs(cfg), "moe": B.moe_specs(cfg)}
    elif fam == "hybrid":
        block = _superblock_specs(cfg)
    else:
        block = {"attn": B.attn_specs(cfg), "mlp": B.mlp_specs(cfg)}
    specs: Dict[str, Any] = {
        "embed": Spec((V, D), ("vocab", "embed"), scale=0.02),
        "final_norm": Spec((D,), ("embed",), init="ones"),
        "blocks": stack_specs(block, n_stacks(cfg)),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = Spec((V, D), ("vocab", "embed"), scale=0.02)
    return specs


def cache_specs(
    cfg: ModelConfig, batch: int, max_seq: int,
    *, page_size: Optional[int] = None, n_pages: Optional[int] = None,
) -> Dict[str, Any]:
    """Cache tree (Spec leaves; :func:`cache_dtype` gives each leaf's
    dtype).  With ``page_size``/``n_pages`` K/V live in one shared page
    pool ``(layers, n_pages, page, KV, hd)`` and each row carries a page
    table; otherwise K/V rows are ``max_seq`` long.  The ssm family keeps
    ``conv (layers, batch, W-1, DI+2N)`` and ``ssm (layers, batch, H, N,
    P)`` per row instead, and cannot be paged.  The hybrid family keeps
    dense K/V ``(superblocks, batch, max_seq, KV, hd)`` for its attention
    slots and ``(superblocks, P-1, batch, ...)`` conv and SSM states for
    its mamba slots (batch at axis 2), and cannot be paged."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    nst = n_stacks(cfg)
    if page_size is not None:
        _require_kv(cfg, "a paged cache")
        if n_pages is None:
            raise ValueError("paged cache_specs needs n_pages")
        kv = Spec((nst, n_pages, page_size, KV, hd),
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
    out = {"len": Spec((batch,), (None,), init="zeros")}
    fam = _family(cfg)
    cs, ss = M.mamba_cache_shape(cfg, batch)
    if fam == "ssm":
        out.update(
            conv=Spec((nst,) + cs,
                      ("layers", "batch", None, "inner"), init="zeros"),
            ssm=Spec((nst,) + ss,
                     ("layers", "batch", "ssm_heads", None, None),
                     init="zeros"))
        return out
    kv = Spec((nst, batch, max_seq, KV, hd),
              ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
              init="zeros")
    out.update(k=kv, v=kv)
    if fam == "hybrid":
        P = cfg.attn_period
        out.update(
            conv=Spec((nst, P - 1) + cs,
                      ("layers", None, "batch", None, "inner"), init="zeros"),
            ssm=Spec((nst, P - 1) + ss,
                     ("layers", None, "batch", "ssm_heads", None, None),
                     init="zeros"))
    return out


def cache_dtype(cfg: ModelConfig, name: str, dtype) -> torch.dtype:
    """The dtype of cache leaf ``name`` for activations in ``dtype``, as
    the JAX package's prefill produces them: lengths int32, the SSM
    state fp32 (a recurrence is never rounded to bf16), K/V and the conv
    state in the activation dtype, unless ``cfg.kv_cache_dtype`` names
    K/V's (``float8_e4m3fn``: an fp8 cache, which the decode-side kernels
    widen on load).  SSM and conv states are never quantised."""
    if name == "len":
        return torch.int32
    if name == "ssm":
        return torch.float32
    if name in ("k", "v") and cfg.kv_cache_dtype != "auto":
        if cfg.kv_cache_dtype not in _KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype={cfg.kv_cache_dtype!r}: "
                             f"'auto' or one of {sorted(_KV_CACHE_DTYPES)}")
        return _KV_CACHE_DTYPES[cfg.kv_cache_dtype]
    return dtype


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _take(tree, i: int):
    """Element ``i`` of every stacked leaf of ``tree`` (views; an int8
    leaf takes its scales along)."""
    return tree_map(lambda w: w[i], tree)


def _layer(params, i: int):
    """Layer (or superblock) ``i``'s weights: views into the stacked
    leaves (arctic's ``moe/dense`` sub-tree included)."""
    return _take(params["blocks"], i)


def _ffn(cfg: ModelConfig, lp, x: torch.Tensor, decode: bool = False):
    """The layer's FFN → ``(out, aux)``: the MoE block with its aux loss,
    or the dense MLP (``aux`` None)."""
    if "moe" in lp:
        return B.moe_apply(cfg, lp["moe"], x, decode)
    return B.mlp_apply(cfg, lp["mlp"], x, decode), None


def _slot_ffn(cfg: ModelConfig, bp, s: int, x: torch.Tensor,
              decode: bool = False):
    """Slot ``s``'s FFN in a hybrid superblock ``bp`` → ``(out, aux)``:
    the dense MLP on even slots (``aux`` None), MoE on odd ones."""
    if s % 2 == 0:
        return B.mlp_apply(cfg, _take(bp["ffn_dense"], s // 2), x,
                           decode), None
    return B.moe_apply(cfg, _take(bp["ffn_moe"], s // 2), x, decode)


def _remat(cfg: ModelConfig, params, x: torch.Tensor) -> str:
    """The pass's rematerialization: ``cfg.remat`` (``"block"``: each
    layer, or hybrid superblock, of :func:`_backbone` is recomputed in the
    backward; ``"slot"``: each slot of a hybrid superblock) where grad is
    enabled and the pass is differentiated (``x`` or a weight requires
    grad), else ``"none"``: serving passes and graph captures run as they
    did.  As ``repro.models.model``'s ``jax.checkpoint``s."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return "none"
    if x.requires_grad or any(isinstance(w, torch.Tensor) and w.requires_grad
                              for _, w in tree_items(params)):
        return cfg.remat
    return "none"


def _checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _superblock(cfg: ModelConfig, bp, x: torch.Tensor,
                positions: torch.Tensor, aux: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None, i: int = 0,
                seq_valid: Optional[torch.Tensor] = None,
                remat: str = "none"):
    """Hybrid superblock ``bp`` over full sequences → ``(x, aux)``: slot 0
    attention (flash), slots 1..P-1 mamba (the SSD scan), each followed
    by its FFN (:func:`_slot_ffn`), the MoE slots' aux losses added to
    ``aux``.  With ``cache`` (prefill), superblock ``i``'s K/V land at
    ``cache["k"/"v"][i, :, :S]`` and each mamba slot's final states at
    ``cache["conv"/"ssm"][i, s - 1]``, its mixer masked past
    ``seq_valid`` (:func:`_mamba_prefill`).  ``remat="slot"`` recomputes
    each slot in the backward (no cache)."""
    for s in range(cfg.attn_period):
        if cache is None and remat == "slot":
            x, aux = _checkpointed(_slot, cfg, bp, s, x, positions, aux)
            continue
        if cache is None:
            x, aux = _slot(cfg, bp, s, x, positions, aux)
            continue
        if s == 0:
            out, (k, v) = B.attn_apply(cfg, bp["attn"], x, positions,
                                       return_kv=True)
            x = x + out
            S = x.shape[1]
            cache["k"][i, :, :S] = L.to_cache(k, cache["k"].dtype)
            cache["v"][i, :, :S] = L.to_cache(v, cache["v"].dtype)
        else:
            x, cache["conv"][i, s - 1], cache["ssm"][i, s - 1] = \
                _mamba_prefill(cfg, _take(bp["mamba"], s - 1), x, seq_valid)
        x, aux = _slot_out(cfg, bp, s, x, aux)
    return x, aux


def _slot(cfg: ModelConfig, bp, s: int, x: torch.Tensor,
          positions: torch.Tensor, aux: torch.Tensor):
    """Slot ``s`` of hybrid superblock ``bp`` with no cache → ``(x,
    aux)``: its mixer (attention on slot 0, else mamba), then its FFN."""
    if s == 0:
        x = x + B.attn_apply(cfg, bp["attn"], x, positions)
    else:
        x = x + M.mamba_apply(cfg, _take(bp["mamba"], s - 1), x)
    return _slot_out(cfg, bp, s, x, aux)


def _slot_out(cfg: ModelConfig, bp, s: int, x: torch.Tensor,
              aux: torch.Tensor):
    """Slot ``s``'s FFN added to ``x`` and its aux loss to ``aux``."""
    out, a = _slot_ffn(cfg, bp, s, x)
    return x + out, aux if a is None else aux + a


def _embed_inputs(cfg: ModelConfig, params,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The first hidden states of a prefill-shaped pass: ``batch["embeds"]``
    ``(B, S, D)`` for ``input_mode == "embeddings"`` (musicgen's EnCodec
    frames, pixtral's patches; the frontends are stubs, as in the
    reference), else the embedded ``batch["tokens"]``."""
    if cfg.input_mode == "embeddings":
        return batch["embeds"]
    return L.embed(batch["tokens"], params["embed"])


def _positions(x: torch.Tensor) -> torch.Tensor:
    Bsz, S = x.shape[0], x.shape[1]
    return torch.arange(S, device=x.device).expand(Bsz, S)


def _unembed_table(cfg: ModelConfig, params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _decode_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and unembed of a decode or verify pass, through the
    row-invariant kernels (:func:`blocks.row_ops`) → fp32 logits."""
    norm, mm = B.row_ops(True)
    x = norm(x, params["final_norm"], cfg.norm_eps)
    return mm(x, _unembed_table(cfg, params).t()).float()


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


def _backbone(cfg: ModelConfig, params, x: torch.Tensor,
              positions: torch.Tensor, ks: Optional[torch.Tensor] = None,
              vs: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers over full sequences (causal: flash attention, or the
    SSD scan), then the final norm → ``(hidden, aux)``, ``aux`` the sum of
    the MoE layers' aux losses (a zero fp32 scalar for the other
    families), as the JAX scan carries it.  With ``ks``/``vs`` ``(layers,
    B, >= S, KV, hd)`` each layer's K/V land at ``[i, :, :S]``; without
    them nothing is kept.  The hybrid family runs its superblocks
    (:func:`_superblock`).  Where the pass is differentiated,
    ``cfg.remat`` applies (:func:`_remat`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = "none" if ks is not None else _remat(cfg, params, x)
    for i in range(n_stacks(cfg)):
        lp = _layer(params, i)
        if remat == "block":
            x, aux = _checkpointed(_block, cfg, lp, x, positions, aux)
        else:
            x, aux = _block(cfg, lp, x, positions, aux, ks, vs, i, remat)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _block(cfg: ModelConfig, lp, x: torch.Tensor, positions: torch.Tensor,
           aux: torch.Tensor, ks: Optional[torch.Tensor] = None,
           vs: Optional[torch.Tensor] = None, i: int = 0,
           remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer (or hybrid superblock) ``lp`` of :func:`_backbone` →
    ``(x, aux)``; with ``ks``/``vs`` its K/V land at ``[i, :, :S]``."""
    if _family(cfg) == "ssm":
        return x + M.mamba_apply(cfg, lp["mamba"], x), aux
    if _family(cfg) == "hybrid":
        return _superblock(cfg, lp, x, positions, aux, remat=remat)
    out, (k, v) = B.attn_apply(cfg, lp["attn"], x, positions, return_kv=True)
    x = x + out
    if ks is not None:
        S = x.shape[1]
        ks[i, :, :S] = L.to_cache(k, ks.dtype)
        vs[i, :, :S] = L.to_cache(v, vs.dtype)
    out, a = _ffn(cfg, lp, x)
    x = x + out
    return x, aux if a is None else aux + a


# ---------------------------------------------------------------------------
# Forward, prefill and encode
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forcing logits over the full sequence → ``(logits (B, S,
    vocab) fp32, aux)``, after ``repro.models.model.forward``: embed (or
    ``batch["embeds"]``), the layers, the final norm, the unembed.
    ``aux`` is the sum of the MoE layers' Switch losses (fp32; zero for
    the other families)."""
    x = _embed_inputs(cfg, params, batch)
    x, aux = _backbone(cfg, params, x, _positions(x))
    logits = L.unembed(x, _unembed_table(cfg, params))
    return logits, aux


def prefill(
    cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], max_seq: int,
    valid_len: Optional[torch.Tensor] = None, all_logits: bool = False,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Process right-padded prompts; return ``(cache, logits)``.

    Dense: ``cache["k"/"v"]`` are ``(layers, B, max_seq, KV, hd)`` with
    the prompt's K/V at ``[0, S)``; causality keeps padding out of every
    valid position.  SSM: ``cache["conv"/"ssm"]`` hold each layer's state
    after the row's last valid position (:func:`_mamba_prefill`;
    ``max_seq`` is not used).  Hybrid: both, K/V per superblock and the
    states per mamba slot (:func:`cache_specs`).  ``valid_len`` (B,) makes ragged rows exact
    and selects each row's last valid position for the logits;
    ``all_logits=True`` returns ``(B, S, vocab)`` instead.  The inputs are
    ``batch["tokens"]``, or ``batch["embeds"]`` ``(B, S, D)`` for an
    embedding-input config.
    """
    x = _embed_inputs(cfg, params, batch)
    Bsz, S = x.shape[0], x.shape[1]
    positions = _positions(x)
    if _family(cfg) == "ssm":
        cache, x = _mamba_layers(cfg, params, x, positions, valid_len)
    elif _family(cfg) == "hybrid":
        cache, x = _hybrid_layers(cfg, params, x, positions, max_seq,
                                  valid_len)
    else:
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        dt = cache_dtype(cfg, "k", x.dtype)
        shape = (cfg.n_layers, Bsz, max_seq, KV, hd)
        cache = {"k": torch.zeros(shape, dtype=dt, device=x.device),
                 "v": torch.zeros(shape, dtype=dt, device=x.device)}
        x, _ = _backbone(cfg, params, x, positions, cache["k"], cache["v"])
    if all_logits:
        logits = L.unembed(x, _unembed_table(cfg, params))
    else:
        logits = _last_logits(cfg, params, x, valid_len)
    cache["len"] = (torch.full((Bsz,), S, dtype=torch.int32, device=x.device)
                    if valid_len is None else valid_len.to(torch.int32))
    return cache, logits


def _mamba_layers(cfg: ModelConfig, params, x: torch.Tensor,
                  positions: torch.Tensor,
                  valid_len: Optional[torch.Tensor]):
    """The ssm family's prefill layers → ``({"conv", "ssm"}, final-norm
    hidden states)``; conv in the activation dtype, SSM state fp32."""
    seq_valid = (None if valid_len is None
                 else positions < valid_len.to(x.device)[:, None])
    Bsz = x.shape[0]
    cs, ss = M.mamba_cache_shape(cfg, Bsz)
    conv = torch.empty((cfg.n_layers,) + cs,
                       dtype=cache_dtype(cfg, "conv", x.dtype),
                       device=x.device)
    ssm = torch.empty((cfg.n_layers,) + ss,
                      dtype=cache_dtype(cfg, "ssm", x.dtype), device=x.device)
    for i in range(cfg.n_layers):
        x, conv[i], ssm[i] = _mamba_prefill(cfg, _layer(params, i)["mamba"],
                                            x, seq_valid)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return {"conv": conv, "ssm": ssm}, x


def _hybrid_layers(cfg: ModelConfig, params, x: torch.Tensor,
                   positions: torch.Tensor, max_seq: int,
                   valid_len: Optional[torch.Tensor]):
    """The hybrid family's prefill superblocks → ``(cache, final-norm
    hidden states)``: K/V zero past the prompt, as in :func:`prefill`,
    and each mamba slot's states after the row's last valid position."""
    seq_valid = (None if valid_len is None
                 else positions < valid_len.to(x.device)[:, None])
    Bsz = x.shape[0]
    cache = {}
    for name, spec in cache_specs(cfg, Bsz, max_seq).items():
        if name != "len":
            cache[name] = (torch.zeros if name in ("k", "v") else torch.empty)(
                spec.shape, dtype=cache_dtype(cfg, name, x.dtype),
                device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_stacks(cfg)):
        x, _ = _superblock(cfg, _layer(params, i), x, positions, aux, cache,
                           i, seq_valid)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cache, x


def _mamba_prefill(cfg: ModelConfig, p, x: torch.Tensor,
                   seq_valid: Optional[torch.Tensor] = None):
    """The mamba mixer over the full sequence AND the layer's final
    states.  ``seq_valid`` (B,S) masks right padding: the mixer output is
    zeroed past each row's valid prefix, and the state-only pass sees
    masked inputs, so the states stop exactly at ``valid_len``."""
    proj = M.in_proj(cfg, p, x)   # once, for the mixer and the states
    out = M.mamba_apply(cfg, p, x, proj=proj)
    if seq_valid is not None:
        out = out * seq_valid[..., None].to(out.dtype)
    conv_s, ssm_s = _mamba_final_state(cfg, p, x, seq_valid, proj=proj)
    return x + out, conv_s, ssm_s


def _mamba_final_state(cfg: ModelConfig, p, x: torch.Tensor,
                       seq_valid: Optional[torch.Tensor] = None,
                       proj: Optional[torch.Tensor] = None):
    """State-only SSD pass → ``(conv_state, ssm_state)`` after ``x``
    (``proj``, where the caller has it, is ``M.in_proj(cfg, p, x)``).

    The conv state is the last W-1 (masked) raw inputs of each row,
    sliced from ``clip(valid_len - (W-1), 0, S - (W-1))`` as the JAX
    package's ``dynamic_slice`` takes it: a row shorter than W-1 tokens
    keeps its tokens left-aligned (``[x0, 0, 0]``), a property of the
    reference that the port reproduces (ROADMAP.md §C).  The SSM state is
    one fp32 contraction over the whole sequence with ``dt`` masked."""
    Bsz, S, _ = x.shape
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    W = cfg.conv_width
    _, xi, b, c, dt = M._split_proj(
        cfg, M.in_proj(cfg, p, x) if proj is None else proj)
    xbc_raw = torch.cat([xi, b, c], dim=-1)
    if seq_valid is not None:
        xbc_raw = xbc_raw * seq_valid[..., None].to(xbc_raw.dtype)
    if seq_valid is None:
        conv_state = xbc_raw[:, -(W - 1):]
        if S < W - 1:
            conv_state = torch.nn.functional.pad(xbc_raw,
                                                 (0, 0, W - 1 - S, 0))
    else:
        valid_len = seq_valid.sum(dim=1)                      # (B,)
        start = torch.clamp(valid_len - (W - 1), 0, max(S - (W - 1), 0))
        rows = start[:, None] + torch.arange(W - 1, device=x.device)
        conv_state = torch.gather(
            xbc_raw, 1, rows[..., None].expand(-1, -1, xbc_raw.shape[-1]))
    xbc = M._causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xi2 = xbc[..., :DI].reshape(Bsz, S, H, P)
    b2 = xbc[..., DI:DI + N]
    dt_bias, A = M._ssm_params(p)
    dtp = torch.nn.functional.softplus(dt.float() + dt_bias)
    if seq_valid is not None:
        dtp = dtp * seq_valid[..., None].float()
    cum = torch.cumsum(dtp * A[None, None, :], dim=1)
    w_state = torch.exp(cum[:, -1:, :] - cum) * dtp          # (B,S,H)
    ssm_state = torch.einsum("bsn,bshp->bhnp", b2.float(),
                             xi2.float() * w_state[..., None])
    return conv_state, ssm_state


def encode(
    cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
    valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence embeddings: final-norm hidden states mean-pooled in fp32
    over each row's valid positions → ``(B, d_model)`` fp32.

    The same backbone as :func:`prefill` (so flash attention, or the SSD
    scan, on the card), but no cache is allocated and nothing is
    unembedded: the serving tier's embedding surface
    (``Engine.embed_rows``).  Both families are causal, so right-padding
    stays out of every position ``< valid_len``, and only those are
    pooled.
    """
    x = _embed_inputs(cfg, params, batch)
    positions = _positions(x)
    xf = _backbone(cfg, params, x, positions)[0].float()
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
    Either way ``len = prefix_len + valid_len``.  KV-only families only:
    an SSM state cannot be re-anchored mid-sequence (the engine gates the
    prefix cache off for them).
    """
    _require_kv(cfg, "chunked prefill")
    x = _embed_inputs(cfg, params, batch)
    Bsz, S = x.shape[0], x.shape[1]
    positions = (prefix_len.long()[:, None]
                 + torch.arange(S, device=x.device)[None])
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cache_dtype(cfg, "k", x.dtype)
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
        buf[:, :P] = L.to_cache(prefix, dt)
        buf[rows, positions] = L.to_cache(suffix, dt)
        dst.copy_(buf[:, :max_seq])

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        out, (k, v) = B.attn_apply_chunked(
            cfg, lp["attn"], x, positions, prefix_k[i], prefix_v[i],
            prefix_len)
        x = x + out
        if paged:
            ks[i] = L.to_cache(k, dt)
            vs[i] = L.to_cache(v, dt)
        else:
            place(ks[i], k, prefix_k[i])
            place(vs[i], v, prefix_v[i])
        x = x + _ffn(cfg, lp, x)[0]
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
    when its slot is refilled).  SSM cache: ``len`` and the states
    ``conv``/``ssm``, each layer's updated **in place**; as in the JAX
    package only ``len`` is frozen for inactive rows, whose states
    advance on their dummy tokens until the next insert overwrites them.
    Hybrid cache: the dense K/V of the attention slots and the states of
    the mamba slots, each updated in place.  Returns ``(cache',
    logits)``.
    """
    x = L.embed(tokens, params["embed"])
    cache_len = cache["len"]
    step = 1 if active is None else active.to(cache_len.dtype)
    if _family(cfg) == "ssm":
        conv, ssm = cache["conv"], cache["ssm"]
        for i in range(cfg.n_layers):
            out, conv_s, ssm_s = M.mamba_decode(
                cfg, _layer(params, i)["mamba"], x, conv[i], ssm[i])
            conv[i] = conv_s
            ssm[i] = ssm_s
            x = x + out
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(x, _unembed_table(cfg, params))[:, 0]
        return dict(cache, len=cache_len + step), logits
    k_all, v_all = cache["k"], cache["v"]
    if _family(cfg) == "hybrid":
        conv, ssm = cache["conv"], cache["ssm"]
        for i in range(n_stacks(cfg)):
            bp = _layer(params, i)
            for s in range(cfg.attn_period):
                if s == 0:
                    out, _, _ = B.attn_decode(cfg, bp["attn"], x, k_all[i],
                                              v_all[i], cache_len)
                else:
                    out, conv[i, s - 1], ssm[i, s - 1] = M.mamba_decode(
                        cfg, _take(bp["mamba"], s - 1), x, conv[i, s - 1],
                        ssm[i, s - 1])
                x = x + out
                x = x + _slot_ffn(cfg, bp, s, x, decode=True)[0]
        logits = _decode_logits(cfg, params, x)[:, 0]
        return dict(cache, len=cache_len + step), logits
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
        x = x + _ffn(cfg, lp, x, decode=True)[0]
    logits = _decode_logits(cfg, params, x)[:, 0]
    return dict(cache, len=cache_len + step), logits


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
    paged one) are not written, as the JAX package drops them
    (``mode="drop"``): the write keeps its fixed ``(B, K)`` shape, so the
    pass has no host sync and can be captured as a CUDA graph, and a
    dropped cell is sent to its row's position 0 with the value that cell
    already holds.  A row whose window passes the capacity has ``len >=
    1`` (for ``K`` up to the capacity), so no window write of the pass
    touches that cell, and it keeps every bit.

    ``cache["len"]`` is **not** advanced: the engine commits the accepted
    prefix on the host (``Engine.commit_spec``); the rejected tail stays
    as masked garbage that the next write at those positions overwrites.
    KV-only families only: an SSM state advances irreversibly per token
    and cannot roll back (the engine gates speculation off for them).
    """
    _require_kv(cfg, "speculative verification")
    x = L.embed(tokens, params["embed"])
    Bsz, K = tokens.shape
    cache_len = cache["len"]
    k_all, v_all = cache["k"], cache["v"]
    pos = cache_len.long()[:, None] + torch.arange(K, device=x.device)[None]
    paged = "pages" in cache
    if paged:
        page = k_all.shape[2]
        page_table = cache["pages"]
        keep = pos < page_table.shape[1] * page
        wpos = torch.where(keep, pos, 0)
        write_at = (torch.gather(page_table.long(), 1, wpos // page),
                    wpos % page)
    else:
        keep = pos < k_all.shape[2]
        wpos = torch.where(keep, pos, 0)
        write_at = (torch.arange(Bsz, device=x.device)[:, None].expand(-1, K),
                    wpos)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if paged:
            out, _, _ = B.attn_verify_paged(
                cfg, lp["attn"], x, k_all[i], v_all[i], page_table,
                cache_len, write_at, keep)
        else:
            out, _, _ = B.attn_verify(cfg, lp["attn"], x, k_all[i], v_all[i],
                                      cache_len, write_at, keep)
        x = x + out
        x = x + _ffn(cfg, lp, x, decode=True)[0]
    logits = _decode_logits(cfg, params, x)   # (B, K, vocab)
    return dict(cache), logits
