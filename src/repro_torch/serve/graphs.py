"""CUDA graphs of the engine's decode and verify passes.

The port's counterpart of ``repro.serve.engine.Engine._mjit``: the JAX
engine never runs a pass op by op, it compiles each entry point once per
shape (``jax.jit``) and calls the compiled program.  Here a pass is
captured once per pass kind and shape as a ``torch.cuda.CUDAGraph`` and
replayed, so a granite decode pass costs the host one graph launch
instead of ~280 kernel wrapper calls and the elementwise ops between
them.

:class:`PassGraph` wraps one pass function ``fn(inputs) -> tensor``
(the pass's logits) with:

* **static inputs** ``inputs``, the device tensors every replay reads.
  Those named in ``staged`` (tokens, ``active``, lengths, the page table)
  are filled from host arrays before each call: written into a host
  buffer (pinned on CUDA) and copied to the device asynchronously,
  outside the graph.  The next call waits for that copy before it writes
  the host buffer again, so a caller may change its arrays as soon as
  the call returns.  The other inputs (the page pool, the dense cache
  rows) are the engine's persistent tensors, which the pass writes in
  place.
* **a warm-up**: the first call runs the pass eagerly, on a side stream
  on CUDA, and returns its result: it is the first real pass, and every
  piece of first-use work (kernel builds, ``ctypes`` bindings, the
  wrappers' and the kernels' plan caches) happens in it, never under
  capture.
* **a capture**: right after the warm-up the pass is captured (on CUDA
  recorded, not run) into a graph with its own memory pool.  Its time
  and the pool's memory are kept (``capture_s``, ``pool_bytes``).
* **replays**: every later call replays the graph and returns the
  graph's own output buffer, which the next replay overwrites; a value
  that must outlive it is copied out by the caller.
* **launch accounting**: a replay runs no Python, so the wrappers'
  counts (``launches`` and ``shapes`` of each kernel in ``ops.KERNELS``)
  would not move.  The counts the capture added are taken back and kept
  as the graph's ``delta``, and each replay adds it: the counts are
  those of the eager passes, the warm-up counted once as the pass it is.
* **scratch**: a wrapper that outgrows a persistent scratch buffer
  (``ops.scratch_buffers``) replaces it; the graph holds every buffer it
  was captured with, so memory it writes stays allocated while it lives.

A failed warm-up, capture or replay raises with the graph's label (the
pass kind and shape); nothing falls back to the eager pass.  How a graph
is warmed and captured is injectable (``capture``, an object with
``warm(fn)`` and ``capture(fn, template) -> (output, replay,
pool_bytes)``): :class:`CudaCapture` on the card; on the CPU, which has
no graphs, a stand-in whose replay calls the pass on the static inputs
runs the same staging and output plumbing.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops

Pass = Callable[[], torch.Tensor]


class CudaCapture:
    """Warm-up on a side stream, capture into a ``torch.cuda.CUDAGraph``
    with its own memory pool."""

    def warm(self, fn: Pass) -> torch.Tensor:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn()
        main = torch.cuda.current_stream()
        main.wait_stream(side)
        out.record_stream(main)   # freed later, after the main stream's use
        return out

    def capture(self, fn: Pass, template: torch.Tensor) -> tuple:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()   # the pool's growth alone is the delta
        before = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        return out, graph.replay, torch.cuda.memory_reserved() - before


def _counts() -> dict:
    return {k: (k.launches, collections.Counter(k.shapes))
            for k in ops.KERNELS}


class PassGraph:
    """One engine pass, captured at its first call and replayed after
    (module docstring)."""

    def __init__(self, label: str,
                 fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                 inputs: Dict[str, torch.Tensor], staged: Sequence[str] = (),
                 capture: Any = None):
        self.label = label
        self.fn = fn
        self.inputs = inputs
        self._capture = CudaCapture() if capture is None else capture
        self._host = {n: torch.empty(inputs[n].shape, dtype=inputs[n].dtype,
                                     pin_memory=inputs[n].is_cuda)
                      for n in staged}
        self._views = {n: t.numpy() for n, t in self._host.items()}
        self._copied = None      # event after the last staging copies
        self._replay = None
        self.outputs = None
        #: (kernel, launches, shapes) that each replay adds
        self.delta: list = []
        self._held: list = []
        self.warm_s = self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def _stage(self, **arrays: np.ndarray) -> None:
        """Copy host arrays into the staged inputs of the same names."""
        if self._copied is not None:
            self._copied.synchronize()
        for name, a in arrays.items():
            self._views[name][...] = a
            self.inputs[name].copy_(self._host[name], non_blocking=True)
        if arrays and self.inputs[next(iter(arrays))].is_cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()

    def __call__(self, **arrays: np.ndarray) -> torch.Tensor:
        """Stage ``arrays``, then run the pass: warm-up and capture at the
        first call, a replay after."""
        self._stage(**arrays)
        if self._replay is None:
            return self._first()
        return self.replay()

    def replay(self) -> torch.Tensor:
        """Replay the captured pass on the static inputs as they stand and
        add its launches to the wrappers' counts."""
        try:
            self._replay()
        except Exception as e:
            raise RuntimeError(f"CUDA graph of the {self.label}: replay "
                               f"failed ({e})") from e
        for kernel, n, shapes in self.delta:
            kernel.launches += n
            kernel.shapes.update(shapes)
        self.replays += 1
        return self.outputs

    def _first(self) -> torch.Tensor:
        run = lambda: self.fn(self.inputs)  # noqa: E731
        t = time.perf_counter()
        try:
            out = self._capture.warm(run)
        except Exception as e:
            raise RuntimeError(f"CUDA graph of the {self.label}: warm-up "
                               f"failed ({e})") from e
        self.warm_s = time.perf_counter() - t
        before = _counts()
        held = ops.scratch_buffers()
        t = time.perf_counter()
        try:
            self.outputs, replay, self.pool_bytes = self._capture.capture(
                run, out)
        except Exception as e:
            raise RuntimeError(f"CUDA graph of the {self.label}: capture "
                               f"failed ({e})") from e
        finally:
            self.delta = self._take_back(before)
        self.capture_s = time.perf_counter() - t
        self._held = held + ops.scratch_buffers()
        self._replay = replay
        return out

    @staticmethod
    def _take_back(before: dict) -> list:
        """Restore the counts of ``before`` and return what was added
        since, kernel by kernel."""
        delta = []
        for kernel, (n, shapes) in before.items():
            added = kernel.shapes - shapes
            if kernel.launches != n:
                delta.append((kernel, kernel.launches - n, added))
            kernel.launches = n
            kernel.shapes.clear()
            kernel.shapes.update(shapes)
        return delta
