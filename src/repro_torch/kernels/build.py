"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` (``<name>.cu``) compiles on its own into a
shared library with a plain C interface, ``build/kernels/<name>-<hash>.so``
under the repository root (``.gitignore`` lists ``build/``).  The hash
covers the source, the headers and the flags, so an edited kernel is
rebuilt and a stale library is never loaded.  Nothing here runs at import
time: :func:`build` compiles every library that is missing, all sources
in parallel (one ``nvcc`` each), and :func:`load` builds one on first use.

Only sources in this checkout are compiled; CUTLASS/CuTe headers under
``/usr/local/cutlass/include`` are on the include path as tools.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "chunked_prefill", "paged_decode_attention",
           "topk_sim", "spec_verify_attention", "decode_attention",
           "ssd_scan", "rmsnorm", "decode_gemm")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-lineinfo")
CUTLASS_INCLUDE = Path("/usr/local/cutlass/include")



class DeviceError(RuntimeError):
    """A kernel that does not build, load or launch, or a CUDA graph that
    does not warm up, capture or replay: a fault of the build or the
    device, which a retry of the same work does not cure (a serving
    executor raises it at once instead of backing off)."""


_LIBS: Dict[str, ctypes.CDLL] = {}
#: one build and load at a time: two threads' first launches of a kernel
#: (two cluster replicas) build and load its library once
_LOAD_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or
    the ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise DeviceError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _command(name: str, out: Path) -> list:
    cmd = [nvcc(), *ARCH_FLAGS, *FLAGS, "-I", str(CSRC)]
    if CUTLASS_INCLUDE.is_dir():
        cmd += ["-I", str(CUTLASS_INCLUDE)]
    return cmd + ["-o", str(out), str(CSRC / f"{name}.cu")]


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current
    sources and flags."""
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library of ``names``, all at once.

    Returns the seconds each compile took (0.0 for a library that was
    already built).  ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills per kernel) is kept beside each library as ``.log``.
    Raises with the compiler's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise DeviceError("CUDA kernel build failed\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (once, whichever threads ask at the same time)."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = library_path(name)
                if not path.is_file():
                    build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
