"""Checkpoints in the JAX package's format (``repro.checkpoint``), so a
checkpoint written by either package restores in the other.

Format: one ``shard_{process:05d}.npz`` per process plus ``manifest.json``
(``{"step", "leaves": {path: {"shape", "dtype"}}}``) under
``directory/step_{step}``.  Leaf paths are JAX's key paths: dict keys in
sorted order, sequence and dataclass fields by index, ``/``-joined
(a ``TrainState`` writes ``0/blocks/attn/wq``, ..., ``1/count``,
``1/m/...``, ``1/v/...``, ``2``).  bfloat16 leaves are stored as the JAX
package's ``np.savez`` stores ml_dtypes' bfloat16: 2-byte void words
(``|V2``), the manifest naming them ``bfloat16``.

Crash safety: a checkpoint directory is valid only once its ``COMMIT``
marker exists (written last); :func:`latest_step` ignores the others, so
a job killed mid-save resumes from the previous step.
:class:`AsyncCheckpointer` copies the tree to the host on the caller's
thread and writes it on a background thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
#: how the JAX package's ``np.savez`` stores a bfloat16 array
_BF16_WORD = np.dtype("V2")


def _children(node) -> Optional[list]:
    """``[(key, child)]`` of an inner node in JAX's flattening order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(i, getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def _leaf_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix[:-1], tree
        return
    for k, child in kids:
        yield from _leaf_paths(child, f"{prefix}{k}/")


def _rebuild(tree, fn: Callable[[str, Any], Any], prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix[:-1], tree)
    new = [_rebuild(c, fn, f"{prefix}{k}/") for k, c in kids]
    if isinstance(tree, dict):
        return {k: v for (k, _), v in zip(kids, new)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(new)
    return dataclasses.replace(tree, **{
        f.name: v for f, v in zip(dataclasses.fields(tree), new)})


class HostLeaf:
    """A leaf copied to the host as the checkpoint stores it: its numpy
    array and the manifest's dtype."""
    __slots__ = ("array", "dtype")

    def __init__(self, leaf):
        if isinstance(leaf, HostLeaf):
            self.array, self.dtype = leaf.array, leaf.dtype
            return
        if isinstance(leaf, torch.Tensor):
            # a copy even on the host: the optimizer updates in place
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                self.array = t.view(torch.int16).numpy().view(_BF16_WORD)
                self.dtype = "bfloat16"
                return
            self.array = t.numpy()
        else:
            self.array = np.asarray(leaf)
        self.dtype = str(self.array.dtype)


def host_tree(tree: Any) -> Any:
    """``tree`` with every leaf a :class:`HostLeaf`."""
    return _rebuild(tree, lambda _, leaf: HostLeaf(leaf))


def save(directory: str, step: int, tree: Any, *,
         process_index: int = 0) -> str:
    """Write ``tree`` under ``directory/step_{step}``; returns the path.
    Its leaves are tensors, arrays or host leaves (:class:`HostLeaf`)."""
    d = os.path.join(directory, f"step_{step}")
    os.makedirs(d, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "leaves": {}}
    for key, leaf in _leaf_paths(tree):
        host = HostLeaf(leaf)
        arrays[key] = host.array
        manifest["leaves"][key] = {"shape": list(host.array.shape),
                                   "dtype": host.dtype}
    np.savez(os.path.join(d, f"shard_{process_index:05d}.npz"), **arrays)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # commit marker LAST — readers ignore uncommitted checkpoints
    with open(os.path.join(d, "COMMIT"), "w") as f:
        f.write("ok")
    return d


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "COMMIT")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def restore(directory: str, target: Any, step: Optional[int] = None) -> Any:
    """Load into the structure of ``target``: each leaf a tensor of the
    target leaf's dtype on its device (where the target leaf is not a
    tensor, a host tensor of the stored dtype)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    data = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                data.update({k: z[k] for k in z.files})

    def load(key: str, leaf) -> torch.Tensor:
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = _from_numpy(data[key], dtypes[key])
        if isinstance(leaf, torch.Tensor):
            return t.to(device=leaf.device, dtype=leaf.dtype)
        return t

    return _rebuild(target, load)


class AsyncCheckpointer:
    """Serialize checkpoints on a background thread (overlap with
    compute); the tree is copied to the host on the caller's thread."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        snapshot = host_tree(tree)   # snapshot on caller

        def work():
            try:
                save(self.directory, step, snapshot)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
