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
  both packages can run the same weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


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
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
        n = math.prod(spec.shape)
        if n <= _DRAW_WHOLE:
            x = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=device)
            return x.mul_(std).to(dtype)
        # an expert stack (grok-1-314b at 4 layers: 24 GiB in fp32) is
        # drawn in slices, so the fp32 draw never holds more than one
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        flat = out.view(-1)
        for i in range(0, n, _DRAW_SLICE):
            m = min(_DRAW_SLICE, n - i)
            flat[i:i + m] = torch.randn(m, generator=generator,
                                        dtype=torch.float32,
                                        device=device).mul_(std)
        return out
    raise ValueError(f"unknown init {spec.init}")


def init_params(tree: SpecTree, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Materialize random parameters on ``device``.

    ``generator`` must live on ``device`` (``torch.Generator(device)``);
    leaves draw from it in sorted-key order, so one seed gives one tree.
    Normal leaves are drawn in fp32 and cast to ``dtype``.
    """
    device = resolve_device(device)
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device} cannot fill "
                         f"tensors on {device}")
    out: Dict[str, Any] = {}
    for path, spec in tree_items(tree):
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = _init_one(spec, generator, dtype, device)
    return out


def from_numpy(tree: Any, device="cuda", dtype=None) -> Any:
    """Convert a tree of numpy arrays (the JAX parameter tree after
    ``jax.tree.map(np.asarray, …)``) into torch tensors on ``device``,
    optionally cast to ``dtype``.  Leaf names and shapes are kept."""
    device = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)

    return tree_map(conv, tree)


def param_count(tree: SpecTree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in tree_items(tree))
