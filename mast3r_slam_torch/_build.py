"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` into its own shared library under ``_kernels_build/`` (listed
in ``.gitignore``), then loaded with ``ctypes``.  The library's file name
carries a hash of its source, so an edited kernel is never served stale.
Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.  The frontend and the backend thread launch the
same kernels, so the first load and the launch counts are taken under
locks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is, or will be, built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp path, final path) or
    None when the library is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names) -> dict[str, str]:
    """Compile the named sources in parallel (one nvcc each, all started
    together).  Returns each source's compiler output (with ``-Xptxas -v``
    its register and shared-memory report); raises if any build fails."""
    started = {n: _start(n) for n in names}
    logs = {}
    failed = []
    for n, job in started.items():
        if job is None:
            logs[n] = "(cached)"
            continue
        proc, tmp, out = job
        logs[n], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.  Two
    threads' first launches build it once: the second waits for the
    first's ``nvcc``, which would otherwise write the same temporary file."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(lib_path(name)))
                _loaded[name] = lib
    return lib


def count_launch(fn) -> None:
    """One more launch of ``fn``'s kernel: ``fn.launches += 1``, under a
    lock, since a read-modify-write from two threads can lose a count."""
    with _count_lock:
        fn.launches += 1


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
