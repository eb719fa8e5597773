"""What one eager pass does on the card, counted from its aten op stream:
the counterpart of ``repro.utils.hlo_analysis`` and of XLA's
``cost_analysis()`` and ``memory_analysis()``, which the JAX planner
reads from a compiled executable.

Eager PyTorch runs each aten op as its own kernel, so the op stream is
the pass: :class:`OpAnalysis`, a ``TorchDispatchMode``, sees every op of
the pass run under it (forward, autograd's backward, the optimizer) and
records

* **products**: the FLOPs of each product (mm, bmm, addmm, baddbmm, the
  bmm an einsum becomes; every op ``torch.utils.flop_counter`` has a
  formula for), by the dtype it runs in;
* **bytes**: the bytes each op reads and writes, each operand counted
  over its distinct elements (a broadcast dimension once).  Views move
  nothing and count zero; an op that touches only part of a tensor
  counts that part (``index_put_`` its values, ``index`` and ``gather``
  their outputs, ``copy_`` its source and destination, a fill its
  destination); 0-dim tensors (host scalars, a loss) count zero;
* **kernels**: each call of a :mod:`repro_torch.kernels.ops` wrapper by
  name, and on meta tensors each launch with its operations, bytes and
  rate (:mod:`repro_torch.utils.roofline`'s costs).  The ops inside a
  wrapper are not counted a second time: on the CPU they are the plain
  version's, on meta the wrapper's allocations.  On CPU tensors a call
  returns its result in the kernel's layout (contiguous), and a pass
  that differentiates flash attention or the SSD scan takes the card's
  route, the backward wrapper called from the backward (its plain
  version), so a pass counts the same ops and calls on both devices;
* **collectives**: the bytes of each ``_c10d_functional`` collective's
  operands, by the kinds of ``hlo_analysis.COLLECTIVE_OPS`` (zero on
  one card);
* **memory**: the live storage bytes of the pass's device over the pass
  and their peak, each storage rounded up to the 512-byte blocks of the
  CUDA caching allocator (``torch.cuda.max_memory_allocated`` counts
  blocks); the arguments (:meth:`OpAnalysis.arguments`) are live
  throughout.  A storage is freed when its last reference goes, the
  autograd graph's included.

On the meta device nothing is allocated and no kernel is built, so a
whole configuration is counted without a card
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops
from repro_torch.utils import roofline as R

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
#: ``_c10d_functional`` ops by the collective kind they are
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
#: the caching allocator's block granularity
BLOCK_BYTES = 512
#: ops that allocate without touching memory
_NO_TOUCH = {"empty", "empty_like", "new_empty", "empty_strided",
             "new_empty_strided"}
#: ops that write their destination without reading it
_WRITE_ONLY = {"fill_", "zero_", "zeros", "zeros_like", "ones", "ones_like",
               "full", "full_like", "new_zeros", "new_ones", "new_full",
               "arange", "scalar_tensor"}
#: ops that read as much of their source as they write (the output's
#: size), plus their index tensors
_GATHERS = {"index", "gather", "embedding", "index_select", "take"}
#: ops that write their values into part of their destination (in place)
_SCATTERS = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
             "index_add_", "index_copy_", "masked_scatter_"}
#: the kernels the card differentiates through, and their backwards
_BACKWARDS = {"flash_attention": "flash_attention_bwd",
              "ssd_scan": "ssd_scan_bwd"}


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (nested lists,
    tuples and dicts)."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _state_tensors(tree) -> list:
    """The tensors of a pass's inputs or outputs: nested dicts, lists,
    tuples and dataclasses (a ``TrainState``), int8 weights' payloads and
    scales."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif isinstance(tree, ops.QuantizedTensor):
        tree = [tree.q, tree.scale]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _state_tensors(x)]
    return []


def operand_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a dimension of stride 0 read
    once); a 0-dim tensor counts zero."""
    if t.dim() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _blocks(nbytes: int) -> int:
    return -(-nbytes // BLOCK_BYTES) * BLOCK_BYTES


class _KernelGrad(torch.autograd.Function):
    """A kernel's plain version on CPU tensors, differentiated as the card
    differentiates the kernel: the backward calls its backward wrapper
    (``backward(*saved, grad)``), so the pass counts that call."""

    @staticmethod
    def forward(ctx, call, backward, *inputs):
        with torch.no_grad():
            out = call(*inputs).contiguous()
        ctx.backward = backward
        ctx.save_for_backward(*inputs, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grads = ctx.backward(*ctx.saved_tensors, grad.contiguous())
        return (None, None, *grads)


class OpAnalysis(TorchDispatchMode):
    """Counts one pass run under it (``with OpAnalysis() as a:``); see
    the module's docstring.  ``memory`` off skips the live-storage
    bookkeeping (a pass counted for its costs only)."""

    def __init__(self, memory: bool = True):
        super().__init__()
        self.memory = memory
        #: product FLOPs by the rate's name (the operands' dtype)
        self.product_flops: Dict[str, float] = collections.Counter()
        #: bytes read and written by the ops outside the kernels
        self.op_bytes = 0
        #: ops run outside the kernels, by aten name
        self.op_counts: Dict[str, int] = collections.Counter()
        #: per kernel: calls, launches, operations by rate, plain
        #: operations, bytes
        self.kernels: Dict[str, Dict[str, Any]] = {}
        #: collective operand bytes by kind
        self.collectives: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
        self._depth = 0              # inside a wrapper call
        self._no_lse = torch.empty(0)   # the CPU backward ignores lse
        self._memo: Dict[Any, Any] = {}    # op signature -> its outputs
        self._live: Dict[int, int] = {}   # storage -> block bytes
        self._args: Dict[int, int] = {}   # argument storage -> bytes
        self._outs: Dict[int, int] = {}   # output storage -> bytes
        self._device: Optional[torch.device] = None
        self.live_bytes = 0
        self.peak_bytes = 0
        self._layers = []

    # -- the pass's inputs and outputs ---------------------------------------
    def arguments(self, *trees) -> "OpAnalysis":
        """Register the pass's inputs: their storages are live throughout
        and never counted as new; the first one's device is the pass's."""
        for t in _state_tensors(trees):
            if t.dim() == 0 and t.device.type == "cpu":
                continue
            if self._device is None:
                self._device = t.device
            key = _storage_key(t)
            if key not in self._args:
                self._args[key] = t.untyped_storage().nbytes()
                if key not in self._live:
                    self._live[key] = _blocks(self._args[key])
                    self.live_bytes += self._live[key]
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return self

    @property
    def argument_bytes(self) -> int:
        """Bytes of the inputs' storages."""
        return sum(self._args.values())

    @property
    def argument_blocks(self) -> int:
        """The same in the allocator's blocks."""
        return sum(_blocks(n) for n in self._args.values())

    def outputs(self, *trees) -> "OpAnalysis":
        """Register the pass's outputs: ``output_bytes`` the storages they
        hold, ``alias_bytes`` those that are also arguments (state updated
        in place)."""
        for t in _state_tensors(trees):
            if t.device == self._device:
                self._outs[_storage_key(t)] = t.untyped_storage().nbytes()
        return self

    def memory_analysis(self) -> Dict[str, int]:
        """The keys of the JAX planner's record, in bytes of the storages:
        ``alias_bytes`` the outputs that are inputs (updated in place),
        ``peak_device_bytes`` the live peak in the allocator's blocks and
        ``temp_bytes`` what it holds beyond the inputs and the new
        outputs (the blocks' rounding included)."""
        alias = sum(n for k, n in self._outs.items() if k in self._args)
        new_out = sum(_blocks(n) for k, n in self._outs.items()
                      if k not in self._args)
        return {
            "argument_bytes": self.argument_bytes,
            "output_bytes": sum(self._outs.values()),
            "temp_bytes": self.peak_bytes - self.argument_blocks - new_out,
            "alias_bytes": alias,
            "peak_device_bytes": self.peak_bytes,
        }

    # -- the wrappers (ops' observer) ----------------------------------------
    def _kernel(self, name: str) -> Dict[str, Any]:
        return self.kernels.setdefault(name, dict(
            calls=0, launches=0, flops=collections.Counter(), work=0,
            bytes=0))

    def kernel_call(self, kernel, method, args, kwargs):
        """One wrapper call: counted, its ops not (a nested call, such as
        ``decode_gemm`` calling its ``group``, is part of the outer)."""
        if self._depth:
            return method(kernel, *args, **kwargs)
        self._kernel(kernel.name)["calls"] += 1
        self._depth += 1
        try:
            bwd = _BACKWARDS.get(kernel.name)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            on_cpu = all(t.device.type == "cpu" for t in tensors)
            if (on_cpu and bwd is not None and torch.is_grad_enabled()
                    and any(t.requires_grad for t in tensors)):
                return self._card_route(kernel, method, args, kwargs, bwd)
            out = method(kernel, *args, **kwargs)
            return _contiguous(out) if on_cpu else out
        finally:
            self._depth -= 1

    def _card_route(self, kernel, method, args, kwargs, bwd_name):
        """A differentiated plain call on CPU tensors whose backward
        calls the backward wrapper, as ``ops._FlashFunction`` and
        ``ops._SsdScanFunction`` do on the card."""
        bwd = getattr(ops, bwd_name)

        def call(*inputs):
            return method(kernel, *inputs, **kwargs)

        if bwd_name == "flash_attention_bwd":
            def backward(q, k, v, out, dout):
                return bwd(q, k, v, out, dout, self._no_lse)
        else:
            def backward(x, dt, A, b, c, y, dy):
                return bwd(x, dt, A, b, c, dy, **kwargs)
        return _KernelGrad.apply(call, backward, *args)

    def kernel_launch(self, kernel, cost: R.KernelCost) -> None:
        k = self._kernel(kernel.name)
        k["launches"] += 1
        k["flops"][cost.rate] += cost.flops
        k["work"] += cost.ops
        k["bytes"] += cost.bytes

    # -- the op stream --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = self._run(func, args, kwargs, ins)
        outs = _tensors(out)
        in_keys = {_storage_key(t) for t in ins}
        if self.memory:
            reuse = self._accumulation(func, args, kwargs)
            for t in outs:
                self._allocated(t, in_keys, reuse)
                reuse = None
        if self._depth:
            return out
        name = func._overloadpacket.__name__
        self.op_counts[name] += 1
        kind = (_COLLECTIVE_KIND.get(name)
                if func.namespace == "_c10d_functional" else None)
        if kind is not None:
            self.collectives[kind] += sum(operand_bytes(t) for t in ins)
            return out
        formula = _flop_formula(func)
        if formula is not None and ins:
            rate = R.rate_name(ins[0].dtype)
            self.product_flops[rate] += formula(*args, **kwargs, out_val=out)
        self.op_bytes += self._bytes(func, name, ins, outs, in_keys)
        return out

    def _run(self, func, args, kwargs, ins):
        """``func(*args, **kwargs)``; on meta tensors an op seen before
        with the same signature (shapes, strides, dtypes, the other
        arguments) gives fresh outputs of the shapes, strides and dtypes
        it gave then, or its input back for an op in place: the meta
        kernels of many ops are Python functions (~0.3 ms a call), and a
        pass repeats its layers' ops, the optimizer its runs'."""
        if not ins or any(t.device.type != "meta" for t in ins):
            return func(*args, **kwargs)
        key = _signature(func, args, kwargs)
        spec = self._memo.get(key) if key is not None else None
        if spec is not None:
            if spec == "self":
                return args[0]
            made = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in spec[1]]
            return made[0] if spec[0] else tuple(made)
        out = func(*args, **kwargs)
        if key is not None:
            self._memo[key] = _out_spec(out, args, ins)
        return out

    @staticmethod
    def _bytes(func, name, ins, outs, in_keys) -> int:
        if name in _NO_TOUCH:
            return 0
        if name in _WRITE_ONLY:
            return sum(operand_bytes(t) for t in outs)
        if (not func._schema.is_mutable and outs
                and all(_storage_key(t) in in_keys for t in outs)):
            return 0   # a view
        if name == "copy_":
            return sum(operand_bytes(t) for t in ins[:2])
        if name in _GATHERS:   # the source is ins[0], the indices the rest
            return (2 * sum(operand_bytes(t) for t in outs)
                    + sum(operand_bytes(t) for t in ins[1:]))
        if name in _SCATTERS:
            src = ins[1:]   # indices and values; the destination is ins[0]
            vals = [t for t in src if t.is_floating_point()
                    or t.dtype == ins[0].dtype]
            return (sum(operand_bytes(t) for t in src)
                    + sum(operand_bytes(t) for t in vals))
        return (sum(operand_bytes(t) for t in ins)
                + sum(operand_bytes(t) for t in outs))

    def _accumulation(self, func, args, kwargs) -> Optional[int]:
        """The storage autograd's engine would sum a gradient into in
        place, where ``func`` is its sum of two contributions to one
        input's gradient (``old + new``): the engine adds in place into
        a buffer it holds alone, but under any dispatch mode (this one)
        it adds out of place (``isTensorSubclassLike``), which would hold
        one more gradient at the sum than the pass does.  None for any
        other op."""
        if (func is not torch.ops.aten.add.Tensor or kwargs or len(args) != 2
                or torch.is_grad_enabled() or not _from_engine()):
            return None
        a, b = args
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype):
            return None
        for t in (a, b):
            key = _storage_key(t)
            if (key in self._live and key not in self._args
                    and t.is_contiguous()):
                return key
        return None

    def _allocated(self, t: torch.Tensor, in_keys,
                   reuse: Optional[int] = None) -> None:
        """Count ``t``'s storage live if it is new; with ``reuse`` (the
        engine's sum in place, :meth:`_accumulation`) as taking that
        storage's place."""
        if self._device is None or t.device != self._device:
            return
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live or key in in_keys:
            return
        if reuse is not None:
            self.live_bytes -= self._live.pop(reuse, 0)
        nbytes = _blocks(storage.nbytes())
        self._live[key] = nbytes
        self.live_bytes += nbytes
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        weakref.finalize(storage, self._freed, key)

    def _freed(self, key: int) -> None:
        nbytes = self._live.pop(key, None)
        if nbytes is not None:
            self.live_bytes -= nbytes

    # -- entering and leaving -------------------------------------------------
    def __enter__(self):
        ops.drop_meta_scratch()
        observe = ops.observing(self)
        observe.__enter__()
        self._layers.append(observe)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._layers.pop().__exit__(*exc)
            ops.drop_meta_scratch()

    # -- results --------------------------------------------------------------
    def flops_by_rate(self) -> Dict[str, float]:
        """Product FLOPs and the kernels' operations, by rate name."""
        out = collections.Counter(self.product_flops)
        for k in self.kernels.values():
            out.update(k["flops"])
        return {r: float(f) for r, f in out.items() if f}

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_rate().values()))

    @property
    def bytes(self) -> float:
        return float(self.op_bytes + sum(k["bytes"]
                                         for k in self.kernels.values()))

    def collective_bytes(self) -> Dict[str, int]:
        """Operand bytes by collective kind, and their ``total``."""
        out = dict(self.collectives)
        out["total"] = sum(self.collectives.values())
        return out

    @property
    def work(self) -> float:
        """Plain operations: the products' FLOPs and the kernels' plain
        operations (3xTF32 and split operands counted once)."""
        return float(sum(self.product_flops.values())
                     + sum(k["work"] for k in self.kernels.values()))

    def costs(self) -> Dict[str, Any]:
        """``flops`` (in the rates' units, by rate and in all), ``work``
        (plain operations), ``bytes`` and ``coll``: what the JAX planner
        reads from one compiled probe."""
        by_rate = self.flops_by_rate()
        return {"flops": float(sum(by_rate.values())), "work": self.work,
                "flops_by_rate": by_rate, "bytes": self.bytes,
                "coll": {k: float(v)
                         for k, v in self.collective_bytes().items()}}

    def kernel_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per kernel: calls, launches, operations by rate, bytes, and
        the launches' summed bound (ms)."""
        out = {}
        for name, k in sorted(self.kernels.items()):
            flops = {r: float(f) for r, f in k["flops"].items() if f}
            out[name] = dict(
                calls=k["calls"], launches=k["launches"], flops=flops,
                work=float(k["work"]), bytes=float(k["bytes"]),
                bound_ms=max(k["bytes"] / R.HBM_BW,
                             R.compute_seconds(flops)) * 1e3)
        return out

    def count_ops(self, name: str) -> int:
        """Ops of the pass (outside the kernels) named ``name`` (``mm``,
        ``bmm``, ``index_put_``...), as ``hlo_analysis.count_ops`` counts
        an HLO op."""
        return self.op_counts.get(name, 0)


def _from_engine() -> bool:
    """True when the op running now was called by autograd's engine
    itself (the first Python frame outside the dispatch machinery is
    ``torch.autograd.graph._engine_run_backward``), not by Python code of
    a backward or of the pass."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_filename
        if not (name == __file__ or "torch/_dynamo" in name
                or name.endswith("torch/_compile.py")
                or name.endswith("torch/utils/_python_dispatch.py")):
            return frame.f_code.co_name == "_engine_run_backward"
        frame = frame.f_back
    return False


def _signature(func, args, kwargs):
    """A hashable key of a meta op's call: the op, each tensor's shape,
    strides and dtype, the other arguments; None where one is not
    hashable."""
    def sig(a):
        if isinstance(a, torch.Tensor):
            return ("T", tuple(a.shape), a.stride(), a.dtype)
        if isinstance(a, (list, tuple)):
            return tuple(sig(x) for x in a)
        return (type(a), a)
    try:
        key = (func, sig(args), tuple(sorted((k, sig(v))
                                             for k, v in kwargs.items())))
        hash(key)
    except TypeError:
        return None
    return key


def _out_spec(out, args, ins):
    """How to make ``out`` again from a call of the same signature:
    ``"self"`` for an op in place that returns its first argument, else
    ``(single, [(shape, stride, dtype)...])`` for fresh outputs; None
    where an output views an input (a view is made by the op itself)."""
    if args and out is args[0]:
        return "self"
    single = isinstance(out, torch.Tensor)
    outs = [out] if single else out
    if not isinstance(outs, (list, tuple)) or not all(
            isinstance(t, torch.Tensor) for t in outs):
        return None
    in_keys = {_storage_key(t) for t in ins}
    if any(_storage_key(t) in in_keys for t in outs):
        return None
    return single, [(tuple(t.shape), t.stride(), t.dtype) for t in outs]


def _contiguous(out):
    """A plain version's result in the kernel's layout (contiguous, as
    the CUDA branch allocates it), so the ops after a CPU call see the
    strides they see after a card's."""
    if isinstance(out, torch.Tensor):
        return out.contiguous()
    if isinstance(out, (tuple, list)):
        return type(out)(_contiguous(t) for t in out)
    return out


def _flop_formula(func):
    from torch.utils.flop_counter import flop_registry
    return flop_registry.get(func._overloadpacket)


def analyse(fn, *args, memory: bool = True, **kwargs):
    """``(fn(*args, **kwargs), its OpAnalysis)``, the positional
    arguments registered as the pass's inputs and the result as its
    outputs."""
    with OpAnalysis(memory=memory) as a:
        a.arguments(*args)
        out = fn(*args, **kwargs)
        a.outputs(out)
    return out, a


__all__ = ["COLLECTIVE_OPS", "OpAnalysis", "analyse", "operand_bytes"]
