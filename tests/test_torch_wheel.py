"""The project's wheel carries the port's kernel sources.

``ops/_build.py`` compiles ``recommendit_tpu_torch/csrc/<name>.cu`` (with
every ``*.cuh`` beside it) at first use, from the installed package's own
directory, so an installed port can build its kernels only where the wheel
holds them. The wheel is built offline from a copy of the tree in
``tmp_path`` (``pip wheel . --no-deps --no-build-isolation --no-index``;
setuptools writes ``build/`` and ``*.egg-info`` beside the sources, so the
tree itself is not used). Where this machine cannot build a wheel offline,
the same file list is read from setuptools' own build of the package
(``build_py``), which is what the wheel packs.
"""
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "recommendit_tpu_torch" / "csrc"
PACKAGES = ("recommendit_tpu", "recommendit_tpu_torch")
BUILD_TIMEOUT_S = 240


def _copy_tree(dest: Path) -> None:
    dest.mkdir()
    shutil.copy2(ROOT / "pyproject.toml", dest)
    for pkg in PACKAGES:
        shutil.copytree(ROOT / pkg, dest / pkg, ignore=shutil.ignore_patterns(
            "build", "__pycache__", "*.pyc", "*.so"))


def _wheel_names(src: Path, out: Path, env: dict):
    """The wheel's file names, or None where pip could not build it offline."""
    cmd = [sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
           "--no-build-isolation", "--no-index", "--no-cache-dir", "-w", str(out)]
    try:
        proc = subprocess.run(cmd, cwd=src, env=env, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return None
    wheels = sorted(out.glob("*.whl")) if out.is_dir() else []
    if proc.returncode != 0 or len(wheels) != 1:
        return None
    with zipfile.ZipFile(wheels[0]) as zf:
        return zf.namelist()


def _build_py_names(src: Path, out: Path, env: dict):
    """The files setuptools' ``build_py`` lays out for the wheel."""
    subprocess.run([sys.executable, "-c", "from setuptools import setup; setup()",
                    "build_py", "--build-lib", str(out)], cwd=src, env=env,
                   check=True, capture_output=True, timeout=BUILD_TIMEOUT_S)
    return [p.relative_to(out).as_posix() for p in out.rglob("*") if p.is_file()]


def test_the_wheel_carries_every_kernel_source(tmp_path):
    src = tmp_path / "src"
    _copy_tree(src)
    env = dict(os.environ, TMPDIR=str(tmp_path), PIP_NO_INDEX="1",
               PIP_DISABLE_PIP_VERSION_CHECK="1")
    names = _wheel_names(src, tmp_path / "wheel", env)
    if names is None:
        names = _build_py_names(src, tmp_path / "lib", env)
    sources = sorted(f"recommendit_tpu_torch/csrc/{p.name}" for p in CSRC.iterdir()
                     if p.suffix in (".cu", ".cuh"))
    assert any(s.endswith(".cu") for s in sources) and any(
        s.endswith(".cuh") for s in sources), sources
    assert sorted(n for n in names if "/csrc/" in n) == sources
    assert "recommendit_tpu_torch/ops/_build.py" in names
