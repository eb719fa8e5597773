"""Host-side data loading for the training substrate (a copy of
``repro.data.loader``; the host's index and count come from
``torch.distributed`` in place of ``jax``).

Design points for 1000+-node runs:

* **Deterministic sharding** — every host computes its slice of the global
  batch from ``(step, process_index)`` alone; no coordinator, no shuffle
  files to distribute.  Elastic restarts with a different host count re-key
  the same stream.
* **Prefetch** — a background thread keeps ``prefetch`` batches ready so
  host tokenization never blocks the device step (straggler mitigation at
  the input layer).
* **Packing** — documents are concatenated with EOS separators and cut into
  fixed ``seq_len`` windows (standard LM packing; no padding waste).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _process() -> Tuple[int, int]:
    """``(rank, world size)`` of ``torch.distributed`` where it is
    initialized, else ``(0, 1)``: the port's ``jax.process_index()`` and
    ``jax.process_count()``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_batch_slice(
    global_batch: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[int, int]:
    """[lo, hi) rows of the global batch owned by this host."""
    rank, world = _process()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by hosts {pc}")
    per = global_batch // pc
    return pi * per, (pi + 1) * per


def synthetic_lm_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[np.ndarray]:
    """Deterministic synthetic token stream: batch at step s is a pure
    function of (seed, s) — resume-safe and host-count-independent."""
    step = start_step
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        yield rng.integers(0, vocab_size, size=(batch, seq_len), dtype=np.int32)
        step += 1


def pack_documents(
    texts: Sequence[str],
    encode: Callable[[str], List[int]],
    seq_len: int,
    eos_id: int,
) -> np.ndarray:
    """Concatenate encoded docs with EOS separators; cut into windows."""
    stream: List[int] = []
    for t in texts:
        stream.extend(encode(t))
        stream.append(eos_id)
    n = len(stream) // seq_len
    if n == 0:
        raise ValueError(f"corpus too small for even one {seq_len}-token window")
    arr = np.asarray(stream[: n * seq_len], dtype=np.int32)
    return arr.reshape(n, seq_len)


def corpus_lm_batches(
    texts: Sequence[str],
    encode: Callable[[str], List[int]],
    batch: int,
    seq_len: int,
    eos_id: int,
    *,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[np.ndarray]:
    """Epoch-shuffled batches over a packed corpus; step-keyed determinism."""
    windows = pack_documents(texts, encode, seq_len, eos_id)
    step = start_step
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        idx = rng.integers(0, windows.shape[0], size=batch)
        yield windows[idx]
        step += 1


class Prefetcher:
    """Background-thread prefetch queue around any batch iterator."""

    def __init__(self, it: Iterator[np.ndarray], depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
