"""The port imports and runs with neither jax nor pandas installed.

Each check runs in a subprocess whose ``sys.modules`` maps ``jax``,
``pandas`` and ``pyarrow`` to None, so any import of them raises there, as
it would on a machine without them.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "recommendit_tpu_torch",
    "recommendit_tpu_torch.config",
    "recommendit_tpu_torch.utils",
    "recommendit_tpu_torch.utils.device",
    "recommendit_tpu_torch.utils.latency",
    "recommendit_tpu_torch.features.schema",
    "recommendit_tpu_torch.features.store",
    "recommendit_tpu_torch.ops.topk",
    "recommendit_tpu_torch.ops.seen",
    "recommendit_tpu_torch.ops._build",
    "recommendit_tpu_torch.ops.mips_window",
    "recommendit_tpu_torch.ops.quantize",
    "recommendit_tpu_torch.ops",
    "recommendit_tpu_torch.ops.gather",
    "recommendit_tpu_torch.ops.mips_fold",
    "recommendit_tpu_torch.scripts.kernel_probe",
    "recommendit_tpu_torch.models",
    "recommendit_tpu_torch.models.two_tower",
    "recommendit_tpu_torch.models.retrieval",
    "recommendit_tpu_torch.models.ranker",
    "recommendit_tpu_torch.models.gbdt",
    "recommendit_tpu_torch.serving.recommender",
    "recommendit_tpu_torch.serving",
    "recommendit_tpu_torch.serving.batcher",
    "recommendit_tpu_torch.serving.middleware",
    "recommendit_tpu_torch.serving.app",
    "recommendit_tpu_torch.serving.asgi",
    "recommendit_tpu_torch.serving.asgi_server",
    "recommendit_tpu_torch.scripts.serve_bench",
    "recommendit_tpu_torch.scripts.load_test",
    "recommendit_tpu_torch.ops.bpr",
    "recommendit_tpu_torch.data",
    "recommendit_tpu_torch.data.movielens",
    "recommendit_tpu_torch.data.synthetic",
    "recommendit_tpu_torch.training",
    "recommendit_tpu_torch.training.train_embeddings",
    "recommendit_tpu_torch.training.build_index",
    "recommendit_tpu_torch.training.train_ranker",
    "recommendit_tpu_torch.training.host_table",
    "recommendit_tpu_torch.training.host_train",
    "recommendit_tpu_torch.scripts.host_table_scale",
    "recommendit_tpu_torch.utils.checkpoint",
    "recommendit_tpu_torch.features.snapshot",
    "recommendit_tpu_torch.features.engineering",
    "recommendit_tpu_torch.evaluation",
    "recommendit_tpu_torch.evaluation.metrics",
    "recommendit_tpu_torch.pipelines",
    "recommendit_tpu_torch.pipelines.run_pipeline",
    "recommendit_tpu_torch.utils.logging",
    "recommendit_tpu_torch.data.ctr",
    "recommendit_tpu_torch.ops.sparse_embed",
    "recommendit_tpu_torch.models.ctr",
    "recommendit_tpu_torch.training.train_ctr",
    "recommendit_tpu_torch.scripts.ctr_train",
    "recommendit_tpu_torch.scripts.ctr_variance",
    "chip_smoke",
]
_BLOCK = ('import sys\nsys.modules["jax"] = None\nsys.modules["pandas"] = None\n'
          'sys.modules["pyarrow"] = None\n')
# what the port may load from the JAX package: nothing (it keeps copies of
# the framework-free modules it needs)
_ALLOWED_JAX_PKG = set()


def _run(code: str, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, "-c", _BLOCK + code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def import_report():
    code = f"""
import importlib, json, traceback
errors = {{}}
for m in {MODULES!r}:
    try:
        importlib.import_module(m)
        errors[m] = None
    except Exception:
        errors[m] = traceback.format_exc()
loaded = sorted(k for k in sys.modules if sys.modules[k] is not None)
print(json.dumps({{"errors": errors, "loaded": loaded}}))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax_or_pandas(import_report, module):
    assert import_report["errors"][module] is None, import_report["errors"][module]


def test_no_jax_pandas_or_other_jax_package_modules_loaded(import_report):
    loaded = import_report["loaded"]
    assert not [m for m in loaded
                if m.split(".")[0] in ("jax", "jaxlib", "pandas", "pyarrow")]
    jax_pkg = {m for m in loaded if m.split(".")[0] == "recommendit_tpu"}
    assert jax_pkg <= _ALLOWED_JAX_PKG, jax_pkg - _ALLOWED_JAX_PKG


def test_port_sources_never_import_jax():
    pkg = ROOT / "recommendit_tpu_torch"
    for path in pkg.rglob("*.py"):
        if "build" in path.relative_to(pkg).parts:   # build outputs
            continue
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), (
                f"{path}: {s}")


def test_port_sources_never_import_the_jax_package():
    paths = [ROOT / "chip_smoke.py",
             *(ROOT / "recommendit_tpu_torch").rglob("*.py")]
    for path in paths:
        if "build" in path.relative_to(ROOT).parts:   # build outputs
            continue
        for line in path.read_text().splitlines():
            s = line.strip()
            for prefix in ("import recommendit_tpu", "from recommendit_tpu"):
                if s.startswith(prefix):
                    rest = s[len(prefix):]
                    assert rest.startswith("_torch"), f"{path}: {s}"


def test_trains_without_jax_or_pandas(tmp_path):
    """The train and index phases at a small size on the CPU with both
    blocked."""
    code = f"""
from pathlib import Path
import torch
import chip_smoke
torch.set_num_threads(1)   # a small training loop; see test_torch_smoke.py
data, view = chip_smoke.make_train_data(0, 600, 400, 40_000)
model, rec = chip_smoke.train_phase(view, "cpu", 0, Path({str(tmp_path)!r}),
                                    epochs=4, dim=16, hidden=32, batch=256)
out = chip_smoke.index_phase(model, data, view, "cpu", 0, Path({str(tmp_path)!r}),
                             n_users=200)
print("trained", rec["steps"], out["users"])
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "trained" in proc.stdout


def test_serves_without_jax_or_pandas(tmp_path):
    """Small artifacts made and served on the CPU with both blocked."""
    code = f"""
from pathlib import Path
import chip_smoke
paths, data = chip_smoke.make_artifacts(
    Path({str(tmp_path)!r}), seed=1, device="cpu", n_users=120, n_items=3000,
    dim=16, hidden=16, n_ratings=4000, block_size=512, gbdt_trees=10)
out, _ = chip_smoke.serve_phase(paths, data, "cpu", n_batch_users=200,
                             batch=100, n_requests=3, k=5)
assert out["requests"] == 3, out
gbdt, _ = chip_smoke.gbdt_serve_phase(paths, data, "cpu", n_batch_users=100,
                                      batch=100, n_requests=3, k=5, workers=1)
assert gbdt["users_checked"] == 100, gbdt
print("served", out["batch_users"])
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "served 200" in proc.stdout


def test_pipeline_runs_without_jax_or_pandas(tmp_path):
    """chip_smoke's pipeline phase (the CLI's ``all``: every stage from the
    .dat files to the evaluate report, the ranker stage's two inner towers
    and ranker training included, then a resumed ``embeddings``) at a small
    size on the CPU with all three blocked."""
    code = f"""
from pathlib import Path
import torch
import chip_smoke
torch.set_num_threads(1)
data, _ = chip_smoke.make_train_data(0, 600, 400, 40_000)
rec = chip_smoke.pipeline_phase(data, "cpu", 0, Path({str(tmp_path)!r}), "cpu",
                                epochs=4, dim=16, hidden=32, batch=256,
                                ranker_cfg=dict(RANKER_EPOCHS=3,
                                                RANKER_HIDDEN_DIMS=(16, 8)))
print("pipeline", rec["eval_users"], rec["skew"]["max_kl"], sorted(rec["stage_s"]),
      len(rec["tower_steps"]), rec["ranker"]["best_iteration"] >= 1)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "pipeline" in proc.stdout and " 0.0 " in proc.stdout
    assert ("['data', 'embeddings', 'evaluate', 'features', 'index', 'load_features', "
            "'ranker', 'skew'] 3 True") in proc.stdout


def test_app_serves_metrics_without_prometheus_client():
    """The card's machine has no prometheus_client: the port's middleware
    takes the JAX module's no-op branch and ``/metrics`` still answers."""
    code = """
sys.modules["prometheus_client"] = None
from recommendit_tpu_torch.serving import middleware
from recommendit_tpu_torch.serving.app import RecommendItApp
assert not middleware.PROMETHEUS_AVAILABLE
app = RecommendItApp(pipeline=None)
print(app.handle("GET", "/health")[0], app.handle("GET", "/metrics"))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "200 (200, '# prometheus_client unavailable\\n', 'text/plain')" in proc.stdout
