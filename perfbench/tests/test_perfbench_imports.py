"""Nothing of the benchmark loads JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
plain reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys
import types

from perfbench import run
from perfbench.tests.tiny import ROOT

PERFBENCH = ROOT / "perfbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in PERFBENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(run.BANNED), path


def test_reference_imports_nothing_of_the_port():
    for path in (PERFBENCH / "reference").rglob("*.py"):
        tops = set(_imports(path))
        assert tops <= {"__future__", "contextlib", "dataclasses", "math", "typing",
                        "numpy", "torch", "perfbench"}, (path, tops)
        assert "recommendit_tpu_torch" not in tops


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "recommendit_tpu_torch_fake", types.ModuleType("x"))
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.banned_modules() == ["jax"]


def test_a_run_loads_no_jax():
    code = ("import sys; import perfbench.run, perfbench.systems.serve, "
            "perfbench.systems.train, perfbench.control; "
            "import recommendit_tpu_torch.serving.recommender, "
            "recommendit_tpu_torch.parallel.train; "
            "from perfbench.run import banned_modules; print(banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "serve1m-b4096", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
