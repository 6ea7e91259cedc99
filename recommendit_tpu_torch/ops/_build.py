"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/lib<name>-<hash>.so`` at first use, then loaded with
``ctypes``. The file name carries a hash of the source, of every
``csrc/*.cuh`` header (a source may include any of them) and of the flags,
so an edited kernel or header is rebuilt and a stale library is never
loaded; processes that start together build each library once, under a
file lock. Nothing is compiled when a module is imported: CPU-only
installs never reach this code.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_locks_guard = threading.Lock()
_locks: Dict[str, threading.Lock] = {}   # one per library: builds run in parallel
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
ptxas_logs: Dict[str, str] = {}   # ptxas -v's report of each loaded library


_count_lock = threading.Lock()


def count_launch(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]`` (a module's ``LAUNCHES``) under a lock:
    HTTP, batcher and calibration threads may launch at once, and ctypes
    releases the GIL during a launch."""
    with _count_lock:
        counts[name] += 1


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(str(Path(os.environ[env]) / "bin" / "nvcc"))
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cands.append(str(Path(CUDA_HOME) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_digest(name: str, csrc: Path = CSRC_DIR) -> str:
    """The build key of ``<csrc>/<name>.cu``: a hash of its bytes, of each
    ``*.cuh`` header beside it (by name, in name order) and of the nvcc
    flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(src: Path, out: Path) -> None:
    """nvcc ``src`` into ``out``, with ptxas's report beside it. It
    compiles to a private name, then renames: a concurrent process never
    loads a half-written library."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu`` as a ``ctypes.CDLL``, built on the
    first call in this process if no library for this source exists yet.
    The seconds spent building are kept in ``build_seconds[name]``, and
    ptxas's report (registers, shared memory, spills per kernel), saved
    beside the library when it was built, in ``ptxas_logs[name]``.
    Different libraries build concurrently when called from several
    threads."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}-{source_digest(name, CSRC_DIR)}.so"
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # one build of a library across processes (the ranks of a job
            # start together): the first to take the file lock builds, the
            # others wait for it and load its library
            with open(BUILD_DIR / f"lib{name}.lock", "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)
                if not out.exists():
                    _compile(src, out)
        build_seconds[name] = time.perf_counter() - t0
        report = out.with_suffix(".ptxas.txt")
        ptxas_logs[name] = report.read_text() if report.exists() else ""
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
