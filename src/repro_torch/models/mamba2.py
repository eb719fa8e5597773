"""The Mamba2 SSD layer in PyTorch, after ``repro.models.mamba2``.

Full sequences (prefill, scoring, encode) go through :func:`mamba_apply`,
whose chunked scan is the ``ssd_scan`` kernel wrapper of
:mod:`repro_torch.kernels.ops`: the CUDA kernel on the card, on the CPU
its plain version :func:`repro_torch.models.layers.ssd_chunk_scan` (the
port of ``mamba2._ssd_chunk_scan``).  Decode is one recurrence step in
plain PyTorch (:func:`mamba_decode`), as the JAX package has no kernel
there.  Projections are ``torch.matmul`` (after ``deq`` of an int8
weight, as the JAX package dequantizes there), except that a decode
step's int8 products go to the int8 decode GEMM, which reads the int8
weight as it is (:func:`_decode_mm`); the conv, gates and norms are
tensor ops in fp32, cast back to the activation dtype where the JAX
package casts.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.params import Spec
from repro_torch.models.quant import deq, is_quantized


def mamba_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    D = cfg.d_model
    DI = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    W = cfg.conv_width
    # in_proj emits [z (DI), x (DI), B (N), C (N), dt (H)]
    return {
        "norm": Spec((D,), ("embed",), init="ones"),
        "w_in": Spec((D, 2 * DI + 2 * N + H), ("embed", "inner")),
        "conv_w": Spec((W, DI + 2 * N), ("conv", "inner"), scale=0.5),
        "conv_b": Spec((DI + 2 * N,), ("inner",), init="zeros"),
        "a_log": Spec((H,), ("ssm_heads",), init="small_a"),
        "d_skip": Spec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": Spec((H,), ("ssm_heads",), init="zeros"),
        "gate_norm": Spec((DI,), ("inner",), init="ones"),
        "w_out": Spec((DI, D), ("inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    DI, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :DI]
    x = zxbcdt[..., DI:2 * DI]
    b = zxbcdt[..., 2 * DI:2 * DI + N]
    c = zxbcdt[..., 2 * DI + N:2 * DI + 2 * N]
    dt = zxbcdt[..., 2 * DI + 2 * N:]
    return z, x, b, c, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of width W, then SiLU.  xbc: (B,S,C);
    w: (W,C).  Taps summed in fp32 in order, cast to ``xbc.dtype``."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(W):   # W is tiny (4): unrolled taps
        out = out + pad[:, i:i + S].float() * w[i].float()
    return F.silu(out + bias.float()).to(xbc.dtype)


def _ssm_params(p) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dt_bias, A)`` in fp32: ``A = -exp(a_log)``."""
    return p["dt_bias"].float(), -torch.exp(p["a_log"].float())


def in_proj(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The layer's norm and in-projection, ``rms_norm(x) @ w_in``: the
    ``[z, x, B, C, dt]`` of every position.  x: (B,S,D)."""
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
    return xn @ deq(p["w_in"], xn.dtype)


def mamba_apply(cfg: ModelConfig, p, x: torch.Tensor, *, chunk: int = 0,
                proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence SSD mixer (prefill, scoring, encode).  x: (B,S,D);
    ``proj``, where the caller has it, is ``in_proj(cfg, p, x)``."""
    chunk = chunk or cfg.ssm_chunk
    B, S, _ = x.shape
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xi, b, c, dt = _split_proj(
        cfg, in_proj(cfg, p, x) if proj is None else proj)
    xbc = _causal_conv(torch.cat([xi, b, c], dim=-1), p["conv_w"],
                       p["conv_b"])
    xi = xbc[..., :DI].reshape(B, S, H, P).contiguous()
    b = xbc[..., DI:DI + N].contiguous()
    c = xbc[..., DI + N:].contiguous()
    dt_bias, A = _ssm_params(p)
    dt = F.softplus(dt.float() + dt_bias).contiguous()
    y = kops.ssd_scan(xi, dt, A, b, c, chunk=chunk)   # (B,S,H,P), x dtype
    y = y + xi * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, DI)
    y = y * F.silu(z.float()).to(x.dtype)
    y = L.rms_norm(y, p["gate_norm"], cfg.norm_eps)
    return y @ deq(p["w_out"], y.dtype)


# ---------------------------------------------------------------------------
# Decode path — O(1) state per layer
# ---------------------------------------------------------------------------


def mamba_cache_shape(cfg: ModelConfig, batch: int):
    """(conv_state, ssm_state) shapes for one layer."""
    DI, N, H, P, W = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_head_dim, cfg.conv_width)
    return (batch, W - 1, DI + 2 * N), (batch, H, N, P)


def _decode_mm(x: torch.Tensor, w) -> torch.Tensor:
    """A decode step's product: an int8 weight through the int8 decode
    GEMM (``x @ deq(w, x.dtype)`` without a dequantized copy), any other
    ``x @ w``."""
    return kops.decode_linear(x, w) if is_quantized(w) else x @ w


def mamba_decode(cfg: ModelConfig, p, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One-token SSD step.  x: (B,1,D) → ``(out (B,1,D), conv_state',
    ssm_state')``; the conv state keeps ``conv_state``'s dtype, the SSM
    state is fp32."""
    B = x.shape[0]
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xn = L.rms_norm(x[:, 0], p["norm"], cfg.norm_eps)          # (B,D)
    z, xi, b, c, dt = _split_proj(cfg, _decode_mm(xn, p["w_in"]))
    xbc_new = torch.cat([xi, b, c], dim=-1)                     # (B,DI+2N)
    window = torch.cat([conv_state, xbc_new[:, None].to(conv_state.dtype)],
                       dim=1)                                   # (B,W,·)
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)
    conv_state = window[:, 1:]
    xi = conv_out[:, :DI].reshape(B, H, P)
    b = conv_out[:, DI:DI + N]
    c = conv_out[:, DI + N:]
    dt_bias, A = _ssm_params(p)
    dt = F.softplus(dt.float() + dt_bias)                       # (B,H)
    decay = torch.exp(dt * A[None, :])
    upd = torch.einsum("bn,bhp->bhnp", b.float(), dt[..., None] * xi.float())
    ssm_state = ssm_state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c.float(), ssm_state)
    y = y.to(x.dtype) + xi * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(B, DI) * F.silu(z.float()).to(x.dtype)
    y = L.rms_norm(y, p["gate_norm"], cfg.norm_eps)
    return _decode_mm(y, p["w_out"])[:, None], conv_state, ssm_state
