"""Parameter *specs*: shape + logical axes + initializer, as a tree of
nested dicts (the layout of ``repro.models.params``).

A model is a spec tree plus plain functions on tensors.  Layer stacks
keep the scan-stacked leading ``layers`` dimension of the JAX package
(``stack_specs``): block ``i``'s weights are the ``[i]`` views of the
stacked leaves.  Leaves are visited in sorted-key order, as JAX flattens
a dict, so leaf ``i`` here is leaf ``i`` there.

* :func:`init_params` — random tensors from an explicit ``torch.Generator``
  on an explicit device (the generator and the JAX key give different
  numbers for the same seed);
* :func:`from_numpy` — the weight bridge: the JAX ``init_params`` tree
  after ``jax.tree.map(np.asarray, …)`` becomes this package's tree, so
  both packages can run the same weights (a JAX ``QuantizedTensor`` leaf,
  its ``q`` and ``scale`` as numpy, becomes the port's; a bfloat16 leaf
  keeps its bits); :func:`train_state_from_numpy` does the same for a
  JAX ``TrainState``.

``init_params(..., quant=True)`` draws the int8 tree of
``quantize_params(init_params(...))`` leaf by leaf, never holding a
quantizable leaf whole in fp32 beyond its draw, nor more than one leaf in
the activation dtype beside the int8 already drawn (jamba-1.5-large-398b
at one superblock: 45 G parameters, which do not fit a card in bf16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.quant import (ChannelQuantizer, QuantizedTensor,
                                      keeps_leading, quantizable, quantize)


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | small_a
    scale: Optional[float] = None  # stddev override for normal init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec rank mismatch: {self.shape} vs {self.axes}")


SpecTree = Any  # nested dicts of Spec

#: a normal leaf of up to this many elements is drawn in one fp32 call
#: (every leaf of the dense and ssm families); a larger one in slices of
#: ``_DRAW_SLICE`` elements, in order
_DRAW_WHOLE = 2 ** 32
_DRAW_SLICE = 2 ** 28


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  Raises when CUDA is asked for and there is no card —
    the port never carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return device


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in sorted-key order (JAX's dict order);
    paths are ``/``-joined keys, e.g. ``blocks/attn/wq``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_from_items(items) -> Dict[str, Any]:
    """The nested dict of ``(path, leaf)`` pairs (:func:`tree_items`'s
    inverse)."""
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_specs(tree: SpecTree, n: int) -> SpecTree:
    """Prepend a scan-stacked ``layers`` dimension to every spec."""
    return tree_map(
        lambda s: Spec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        tree)


def _std(spec: Spec) -> float:
    """A normal leaf's std: ``spec.scale``, else 1/sqrt(fan-in), the
    reference's fan-in being ``shape[0]`` (the stacked ``layers`` axis of a
    stacked leaf: jamba at one superblock draws its blocks at std 1)."""
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    return spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)


def _draws(spec: Spec, generator: torch.Generator,
           device) -> Iterator[Tuple[int, torch.Tensor]]:
    """A normal leaf's draw in order, ``(flat offset, fp32 values)``: the
    whole leaf in one call up to ``_DRAW_WHOLE`` elements, else slices of
    ``_DRAW_SLICE`` (an expert stack: grok-1-314b at 4 layers is 24 GiB
    in fp32), so the fp32 draw never holds more than one."""
    std, n = _std(spec), math.prod(spec.shape)
    if n <= _DRAW_WHOLE:
        yield 0, torch.randn(spec.shape, generator=generator,
                             dtype=torch.float32, device=device).mul_(std)
        return
    for i in range(0, n, _DRAW_SLICE):
        m = min(_DRAW_SLICE, n - i)
        yield i, torch.randn(m, generator=generator, dtype=torch.float32,
                             device=device).mul_(std)


def _init_one(spec: Spec, generator: torch.Generator, dtype,
              device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "small_a":
        # mamba A_log init: log of Uniform[1, 16]
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=device) * 15.0 + 1.0
        return torch.log(u).to(dtype)
    if spec.init == "normal":
        if math.prod(spec.shape) <= _DRAW_WHOLE:
            (_, x), = _draws(spec, generator, device)
            return x.to(dtype)
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        flat = out.view(-1)
        for i, x in _draws(spec, generator, device):
            flat[i:i + x.numel()] = x
        return out
    raise ValueError(f"unknown init {spec.init}")


def _init_quantized(spec: Spec, generator: torch.Generator, dtype,
                    device) -> QuantizedTensor:
    """``quantize(_init_one(spec, ...))`` bit for bit.  A leaf drawn whole
    is drawn, cast to ``dtype`` and quantized in runs; a leaf drawn in
    slices is drawn twice, the generator's state put back between: the
    first pass takes each channel's amax over the slices (in ``dtype``),
    the second quantizes them, so neither the fp32 nor the ``dtype`` leaf
    is ever whole (jamba's ``ffn_moe.w_gate``: 12.9 G parameters)."""
    keep = keeps_leading(spec)
    if math.prod(spec.shape) <= _DRAW_WHOLE:
        w = _init_one(spec, generator, dtype, device)
        return quantize(w, keep_leading=keep)
    qz = ChannelQuantizer(spec.shape, keep, device)
    state = generator.get_state()
    for i, x in _draws(spec, generator, device):
        qz.observe(i, x.to(dtype))
    generator.set_state(state)
    for i, x in _draws(spec, generator, device):
        qz.write(i, x.to(dtype))
    return qz.result()


def init_params(tree: SpecTree, generator: torch.Generator,
                dtype=torch.float32, device="cuda",
                quant: bool = False) -> Dict[str, Any]:
    """Materialize random parameters on ``device``.

    ``generator`` must live on ``device`` (``torch.Generator(device)``);
    leaves draw from it in sorted-key order, so one seed gives one tree.
    Normal leaves are drawn in fp32 and cast to ``dtype``.  With
    ``quant`` every quantizable leaf comes out int8, exactly as
    ``quantize_params`` would make it of the ``dtype`` tree, drawn leaf by
    leaf (:func:`_init_quantized`).
    """
    device = resolve_device(device)
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device} cannot fill "
                         f"tensors on {device}")
    return tree_from_items(
        (path, (_init_quantized if quant and quantizable(spec)
                else _init_one)(spec, generator, dtype, device))
        for path, spec in tree_items(tree))


def from_numpy(tree: Any, device="cuda", dtype=None) -> Any:
    """Convert a tree of numpy arrays (the JAX parameter tree after
    ``jax.tree.map(np.asarray, …)``) into torch tensors on ``device``,
    optionally cast to ``dtype``.  Leaf names and shapes are kept; an
    int8 leaf keeps its int8 payload and fp32 scales."""
    device = resolve_device(device)

    def tensor(a, dtype=None):
        t = numpy_tensor(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    def conv(a):
        if hasattr(a, "q") and hasattr(a, "scale"):   # a QuantizedTensor
            return QuantizedTensor(tensor(a.q), tensor(a.scale))
        return tensor(a, dtype)

    return tree_map(conv, tree)


def numpy_tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of numpy array ``a``; a bfloat16 array
    (ml_dtypes', as JAX hands them out) keeps its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def train_state_from_numpy(state: Any, device="cuda", dtype=None):
    """The weight bridge for training: a JAX ``TrainState`` with numpy
    leaves (``jax.tree.map(np.asarray, state)``) becomes the port's
    :class:`repro_torch.train.TrainState`: the parameters and AdamW's m
    and v on ``device`` (parameters optionally cast to ``dtype``), the
    step and AdamW's count as host int32 scalars."""
    from repro_torch.train.train_step import TrainState

    def counter(a):
        return numpy_tensor(a).to(torch.int32)

    opt = state.opt
    return TrainState(
        params=from_numpy(state.params, device, dtype),
        opt={"m": from_numpy(opt["m"], device),
             "v": from_numpy(opt["v"], device),
             "count": counter(opt["count"])},
        step=counter(state.step))


def param_count(tree: SpecTree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in tree_items(tree))
