"""Build the repo's host C++ libraries (``native/*.cpp``) at first use.

The sources are the repo's own, unedited; ``native/Makefile``'s flags
(``g++ -O3 -Wall -fPIC -std=c++17 -shared``) build each into
``recommendit_tpu_torch/build/native/`` under a name that hashes the
source, so an edited source builds anew. Concurrent processes each build
into a temporary file and rename it into place. Where no compiler runs or
the build fails, :func:`load_native` returns ``None`` and the caller takes
its numpy path. This is host code, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parents[2]
SOURCES = ROOT / "native"
BUILD_DIR = ROOT / "recommendit_tpu_torch" / "build" / "native"
CXXFLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-shared")

_loaded: Dict[str, Optional[ctypes.CDLL]] = {}


def _build(source: Path, lib_name: str) -> Optional[Path]:
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXXFLAGS).encode())
    out = BUILD_DIR / f"{lib_name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        logger.warning("no C++ compiler found: %s not built", source.name)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXXFLAGS, str(source), "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", "") or exc
        logger.warning("building %s failed: %s", source.name, detail)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    logger.info("built %s → %s", source.name, out)
    return out


def load_native(source_name: str, lib_name: str) -> Optional[ctypes.CDLL]:
    """``native/<source_name>`` built and loaded (once a process), or
    ``None`` where it cannot be built or loaded."""
    if lib_name in _loaded:
        return _loaded[lib_name]
    lib = None
    source = SOURCES / source_name
    path = _build(source, lib_name) if source.exists() else None
    if path is not None:
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            logger.warning("loading %s failed: %s", path, exc)
    _loaded[lib_name] = lib
    return lib
