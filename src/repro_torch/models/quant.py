"""Weight-only int8 residency (W8A16), after ``repro.models.quant``.

A model that does not fit a card in bf16 keeps its matmul weights as
int8 with one fp32 scale per output channel, and dequantizes at the use
site: ``deq(w, x.dtype)`` before a ``torch.matmul`` on the prefill,
scoring and encode passes, as the JAX package does before its einsums.
On the decode and verify passes an int8 weight goes to the decode GEMM
whole (``ops.decode_linear``), whose int8 variant dequantizes each tile
as it loads it, bit for bit as :func:`deq` does, so no pass reads a
dequantized copy of a weight there.

:class:`QuantizedTensor` is a leaf of the port's trees (``tree_map`` and
``tree_items`` visit it as one leaf), and ``leaf[i]`` takes layer ``i``
of ``q`` and of its scales together, so the layer loops keep working on
a quantized tree.  The scale layout is the reference's: every axis but
the last is reduced, except axis 0 of a stacked ``layers`` leaf, which
keeps a scale per layer.  A hybrid superblock stacks its slots (and an
MoE slot its experts) under that axis, so one scale per output channel
is shared by a superblock's slots and experts (ROADMAP.md §C).

The TP helpers of the reference (``serving_param_shardings``,
``abstract_quantized_params``, ``shard_residency_bytes``) wait for the
tensor-parallel port (ROADMAP.md queue A item 13).
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import torch

#: elements of one fp32 work chunk of :func:`quantize` (1 GiB in fp32)
_CHUNK = 2 ** 28


class QuantizedTensor:
    """An int8 payload ``q`` (the weight's shape) and its fp32 ``scale``
    (the weight's shape with every reduced axis 1).  A flattened matrix
    (:func:`as_matrix`) keeps the original last axis's scales as a 1-D
    ``scale`` that repeats along its columns."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    def __getitem__(self, i: int) -> "QuantizedTensor":
        """Slice ``i`` of axis 0 of ``q`` and of the scales; a scale axis
        of one (a superblock's slots, an MoE block's experts) is shared
        by every slice, as it broadcasts in the reference."""
        return QuantizedTensor(self.q[i],
                               self.scale[i if self.scale.shape[0] != 1
                                          else 0])

    def numel(self) -> int:
        return self.q.numel()

    def to(self, device) -> "QuantizedTensor":
        """``q`` and the scales on ``device`` (their dtypes stay; a dtype
        is refused)."""
        device = torch.device(device)
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    def __repr__(self) -> str:
        return (f"QuantizedTensor(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)}, device={self.q.device})")


def is_quantized(w: Any) -> bool:
    return isinstance(w, QuantizedTensor)


def column_scales(w: QuantizedTensor) -> torch.Tensor:
    """The scales of every column of ``q``'s last axis, broadcastable
    against ``q``: a flattened matrix's 1-D scales repeat along it."""
    s = w.scale
    if s.dim() == 1 and s.numel() != w.q.shape[-1]:
        s = s.repeat(w.q.shape[-1] // s.numel())
    return s


def deq(w, dtype=None):
    """Dequantize if quantized, else ``w`` (the model's one touch point).

    ``q.to(dtype) * scale.to(dtype)``, rounded once in ``dtype`` (the
    activation dtype of the consuming product: every call site passes
    it); with no ``dtype`` the scales' fp32.  One elementwise kernel: the
    int8 payload promotes to ``dtype`` exactly inside the product, so no
    widened copy of ``q`` is written and read back first (the same bits
    as the two-step form)."""
    if not isinstance(w, QuantizedTensor):
        return w
    if dtype is None:
        dtype = w.scale.dtype
    return w.q * column_scales(w).to(dtype)


def as_matrix(w, K: int):
    """``w`` as the ``(K, N)`` matrix of a product that contracts its
    leading axes (``wq (D, H, hd)`` as ``(D, H * hd)``, ``wo (H, hd, D)``
    as ``(H * hd, D)``); a quantized weight keeps its last axis's scales,
    which column ``n`` reads at ``n % len(scale)``."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(w.q.reshape(K, -1), w.scale.reshape(-1))
    return w.reshape(K, -1)


def _pieces(start: int, x: torch.Tensor, R: int,
            N: int) -> Iterator[Tuple[int, int, int, torch.Tensor]]:
    """The flat run ``x`` of a ``(lead, R, N)`` array, starting at flat
    index ``start``, cut into blocks of whole or partial rows: ``(lead
    index, first column, offset in x, block (rows, width))``."""
    pos, m = 0, x.numel()
    while pos < m:
        lead, rem = divmod(start + pos, R * N)
        row, col = divmod(rem, N)
        rows = 0 if col else min((m - pos) // N, R - row)
        width = N if rows else min(N - col, m - pos)
        rows = rows or 1
        yield lead, col, pos, x[pos:pos + rows * width].view(rows, width)
        pos += rows * width


class ChannelQuantizer:
    """Per-output-channel int8 quantization of one leaf, fed in flat runs
    (in order or not): :meth:`observe` every run, then :meth:`write`
    every run into :attr:`q`.  The runs are values in the leaf's dtype;
    each is widened to fp32 as ``quantize`` widens the whole leaf, so
    the result has ``quantize``'s bits whatever the runs' lengths."""

    def __init__(self, shape, keep_leading: bool, device):
        self.shape = tuple(shape)
        self.keep_leading = keep_leading
        self.lead = shape[0] if keep_leading else 1
        self.N = shape[-1]
        self.R = max(1, int(torch.Size(shape).numel()) // (self.lead * self.N))
        self.amax = torch.zeros((self.lead, self.N), dtype=torch.float32,
                                device=device)
        self.q = torch.empty(self.shape, dtype=torch.int8, device=device)
        self.scale: Optional[torch.Tensor] = None

    def observe(self, start: int, x: torch.Tensor) -> None:
        for lead, c0, _, blk in _pieces(start, x, self.R, self.N):
            a = blk.float().abs().amax(dim=0)
            row = self.amax[lead, c0:c0 + a.numel()]
            row.copy_(torch.maximum(row, a))

    def _scales(self) -> torch.Tensor:
        if self.scale is None:
            self.scale = torch.clamp(self.amax, min=1e-8) / 127.0
        return self.scale

    def write(self, start: int, x: torch.Tensor) -> None:
        scale, flat = self._scales(), self.q.view(-1)
        for lead, c0, pos, blk in _pieces(start, x, self.R, self.N):
            s = scale[lead, c0:c0 + blk.shape[1]]
            q = torch.clamp(torch.round(blk.float() / s), -127, 127)
            flat[start + pos:start + pos + blk.numel()] = q.view(-1).to(
                torch.int8)

    def result(self) -> QuantizedTensor:
        """The leaf's ``QuantizedTensor``, its scales in the reference's
        layout (every reduced axis 1)."""
        n = len(self.shape)
        lead = (self.shape[0],) if self.keep_leading else (1,)
        sshape = lead + (1,) * (n - 2) + (self.N,)
        return QuantizedTensor(self.q, self._scales().reshape(sshape))


def quantize(w: torch.Tensor, keep_leading: bool = False) -> QuantizedTensor:
    """Per-last-axis-channel symmetric int8, as ``repro.models.quant``:
    ``amax`` over every axis but the last (and axis 0 with
    ``keep_leading``), ``scale = max(amax, 1e-8) / 127``, ``q =
    clip(round(w / scale), -127, 127)`` in fp32, half to even.  The fp32
    work goes in runs of ``_CHUNK`` elements, so a large leaf is never
    widened whole."""
    qz = ChannelQuantizer(w.shape, keep_leading, w.device)
    flat = w.reshape(-1)
    for i in range(0, flat.numel(), _CHUNK):
        qz.observe(i, flat[i:i + _CHUNK])
    for i in range(0, flat.numel(), _CHUNK):
        qz.write(i, flat[i:i + _CHUNK])
    return qz.result()


def quantizable(spec) -> bool:
    """Matmul weights (>= 2-D, plain normal init, no std override) are
    quantized; embeddings and unembeddings, routers (scaled init), norms,
    biases and conv taps stay in the activation dtype."""
    return len(spec.shape) >= 2 and spec.init == "normal" and spec.scale is None


def keeps_leading(spec) -> bool:
    """A stacked ``layers`` leaf keeps a scale per layer (axis 0)."""
    return spec.axes[0] == "layers"


def quantize_params(params, specs) -> Any:
    """The tree with every quantizable leaf int8 (:func:`quantize`).

    Idempotent: a leaf already quantized passes through, and a tree with
    nothing left to quantize comes back as the same object, so a cluster
    can hand one int8 tree to several replicas that each ask for
    ``quant=True`` (they then share it by reference)."""
    if isinstance(params, dict):
        out = {k: quantize_params(v, specs[k]) for k, v in params.items()}
        return params if all(out[k] is params[k] for k in out) else out
    if quantizable(specs) and not isinstance(params, QuantizedTensor):
        return quantize(params, keep_leading=keeps_leading(specs))
    return params
