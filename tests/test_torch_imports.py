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
    "recommendit_tpu_torch.parallel",
    "recommendit_tpu_torch.parallel.mesh",
    "recommendit_tpu_torch.parallel.embedding",
    "recommendit_tpu_torch.parallel.retrieval",
    "recommendit_tpu_torch.parallel.train",
    "recommendit_tpu_torch.parallel.serve",
    "recommendit_tpu_torch.parallel.ctr",
    "recommendit_tpu_torch.parallel.launch",
    "recommendit_tpu_torch.parallel.parity",
    "recommendit_tpu_torch.parallel.dryrun",
    "recommendit_tpu_torch.scripts.multiproc_smoke",
    "recommendit_tpu_torch.scripts.scale_smoke",
    "recommendit_tpu_torch.scripts.quality_at_scale",
    "recommendit_tpu_torch.scripts.seed_variance",
    "recommendit_tpu_torch.scripts.ranker_ab",
    "recommendit_tpu_torch.scripts.retrieval_common",
    "recommendit_tpu_torch.scripts.recall_10m",
    "recommendit_tpu_torch.scripts.capacity_30m",
    "recommendit_tpu_torch.scripts.recall_curve",
    "recommendit_tpu_torch.scripts.bound_turf",
    "recommendit_tpu_torch.scripts.mips_ab",
    "recommendit_tpu_torch.scripts.fused_decomp",
    "recommendit_tpu_torch.scripts.tail_probe",
    "recommendit_tpu_torch.scripts.tower_sweep",
    "recommendit_tpu_torch.scripts.blend_sweep",
    "recommendit_tpu_torch.scripts.ladder_sweep",
    "recommendit_tpu_torch.scripts.ranker_headroom",
    "recommendit_tpu_torch.scripts.real_data",
    "recommendit_tpu_torch.scripts.train_scope_bench",
    "recommendit_tpu_torch.utils.profiling",
    "recommendit_tpu_torch.utils.native_build",
    "recommendit_tpu_torch.data.native",
    "recommendit_tpu_torch.features",
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


def test_parallel_phase_runs_without_jax_or_pandas(tmp_path):
    """chip_smoke's parallel phase (the multi-device layer at world size 1:
    the sharded two-tower step against the single-device one, both merges,
    the sharded serve, a joint CTR step, the resume across a restart of the
    process group) at a small size on gloo, with all three blocked."""
    code = f"""
from pathlib import Path
import torch
import chip_smoke
torch.set_num_threads(1)
wd = Path({str(tmp_path)!r})
paths, _ = chip_smoke.make_artifacts(wd, seed=1, device="cpu", n_users=120,
    n_items=3000, dim=16, hidden=16, n_ratings=4000, block_size=512, gbdt_trees=10)
rec = chip_smoke.parallel_phase(
    paths, "cpu", 0, wd, "cpu", two_tower=(300, 200, 16, 32, 64), timed=2,
    merge_q=16, serve_users=32, adam_chunk=1000, timer=lambda fn, reps: 0.0,
    ctr=dict(n_users=300, n_items=100, batch=256, embed=8, retrieval=8, top=(32,)))
assert rec["backend"] == "gloo" and rec["serve"]["identical"], rec
assert rec["resume"]["resumed"] == rec["resume"]["straight"][2:], rec
assert all(rec["adamw_chunks"]["bit_equal"]) and rec["adamw_chunks"]["groups"] > 1, rec
print("parallel", rec["train"]["steps"])
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "parallel 3" in proc.stdout


def test_web100m_shard_phase_runs_without_jax_or_pandas():
    """chip_smoke's web100m_shard phase (one rank of a four-way table
    layout on a (1, 1) mesh, in a fresh gloo process) at ``ml1m``'s widths
    with the rows capped: the rank holds a quarter of each table, kernels
    5, 6 are their twins here (no launch), the losses finite, the twins'
    check run on the step's own (B, D); all three blocked."""
    code = """
import torch
import chip_smoke
torch.set_num_threads(1)
rec = chip_smoke.web100m_shard_phase("cpu", 0, "cpu", run=("ml1m", 4), full=False,
                                     row_cap=1000)
assert rec["launches"] == {"bpr_fwd": 0, "bpr_bwd": 0}, rec
assert rec["twins"]["loss_rel_err"] == 0.0 and rec["twins"]["fwd_ms"] is None, rec
assert rec["peak_bound_gib"]["bound"] > 0 and "peak_gib" not in rec, rec
print("shard", rec["users"], rec["user_rows"], rec["item_rows"], rec["of_shards"],
      rec["mesh"], len(rec["losses"]), (rec["twins"]["b"], rec["twins"]["d"]))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "shard 1003 251 251 4 {'data': 1, 'model': 1} 6 (512, 64)" in proc.stdout


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


def test_quality_phase_runs_without_jax_or_pandas(tmp_path):
    """chip_smoke's quality phase (the three quality scripts, then the
    chunked exact top-k check) at a small size on the CPU with all three
    blocked; ``Settings`` made small for ``seed_variance``, which takes
    the defaults. 500 items put both evaluate shapes on the kernel route
    (window 8), so the twin comparison runs (plain against plain here)."""
    code = f"""
import functools
from pathlib import Path
import torch
import recommendit_tpu_torch.config as config
config.Settings = functools.partial(config.Settings, SYNTH_USERS=200, SYNTH_ITEMS=160,
    SYNTH_RATINGS=8000, EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128,
    RANKER_HIDDEN_DIMS=(16, 8), RANKER_CAND_NEGS=20, TOP_K_CANDIDATES=60)
import chip_smoke
torch.set_num_threads(1)
small = ("--users", "300", "--items", "500", "--ratings", "6000", "--epochs", "1",
         "--eval-users", "50", "--nproc", "2", "--cfg", "LOSS_MODE=in_batch",
         "--cfg", "INDEX_MODE=fused", "--cfg", "INDEX_DTYPE=bfloat16",
         "--cfg", "RANKER_EPOCHS=2")
ab = ("--name", "smoke", "--betas", "1,2", "--eval-users", "50",
      "--cfg", "LOSS_MODE=in_batch", "--cfg", "TRAIN_EPOCHS=1", "--cfg", "RANKER_EPOCHS=2")
rec = chip_smoke.quality_phase("cpu", 0, Path({str(tmp_path)!r}), "cpu", qas_args=small,
                               ab_args=ab, seedvar_args=("--seeds", "2", "--epochs", "1"),
                               c58_shape=(40_000, 16, 8), timer=lambda fn, reps: 0.0)
q = rec["quality_at_scale"]
assert q["host_steps"] and len(q["tower_steps"]) == 2, q
assert rec["exact_topk"]["values_equal"] and rec["launches"]["window_mips"] == 0
twins = q["kernel_twins"]
assert [(t["shape"], t["route"], t["window"]) for t in twins] == [
    ("batch_recommend", "kernel", 8), ("retrieval_only", "kernel", 8)], twins
assert all(t["window_max_abs_err"] == 0.0 and t["id_overlap_vs_twin"] == 1.0
           for t in twins), twins
print("quality", q["eval_users"], sorted(q["window_by_call"].items()), sorted(rec))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert ("quality 50 [('_build_serve_fn', 0), ('batch_recommend', 0), ('batch_search', 0)] "
            "['exact_topk', 'launches', 'quality_at_scale', 'ranker_ab', "
            "'seed_variance']") in proc.stdout


def test_sweeps_phase_runs_without_jax_or_pandas(tmp_path):
    """chip_smoke's sweeps phase (the last six drivers) at a small size on
    the CPU with all three blocked: first a quality_at_scale-shaped
    work-dir (data, features, towers, a fused bf16 index, the ranker) for
    blend_sweep; ``Settings`` made small as in the quality phase's test."""
    code = f"""
import functools
from pathlib import Path
import torch
import recommendit_tpu_torch.config as config
config.Settings = functools.partial(config.Settings, SYNTH_USERS=200, SYNTH_ITEMS=160,
    SYNTH_RATINGS=8000, EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128,
    RANKER_HIDDEN_DIMS=(16, 8), RANKER_CAND_NEGS=20, TOP_K_CANDIDATES=60,
    TRAIN_EPOCHS=2, RANKER_EPOCHS=2)
import chip_smoke
from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
torch.set_num_threads(1)
wd = Path({str(tmp_path)!r})
qs = wd / "quality" / "qscale"
orch = PipelineOrchestrator(cfg=config.Settings(LOSS_MODE="in_batch", INDEX_MODE="fused",
                                                INDEX_DTYPE="bfloat16"),
                            data_dir=str(qs / "ml"), models_dir=str(qs / "models"),
                            features_dir=str(qs / "features"), synthetic=True, device="cpu")
for stage in ("data", "features", "embeddings", "index", "ranker"):
    orch.run_stage(stage)
w = chip_smoke.SWEEPS_WEIGHTS
small = {{
    "tower_sweep": ("--name", "smoke", "--seeds", "1", "--users", "200", "--items", "160",
                    "--ratings", "8000", "--eval-users", "50", "--cfg", "LOSS_MODE=in_batch",
                    "--cfg", "TRAIN_EPOCHS=40"),
    "blend_sweep": ("--betas", "0,1,2", "--eval-users", "50", "--users", "200",
                    "--items", "160"),
    "ladder_sweep": ("--name", "smoke", "--weights", w, "--epochs", "1",
                     "--eval-users", "50", "--cfg", "LOSS_MODE=in_batch"),
    "ranker_headroom": ("--weights", w, "--n-users", "200", "--n-items", "160",
                        "--n-ratings", "8000", "--eval-users", "50", "--candidates", "60"),
    "real_data": ("--cfg", "LOSS_MODE=in_batch", "--eval-users", "50"),
    "train_scope_bench": ("chunk", "2", "--cfg", "LOSS_MODE=in_batch"),
}}
rec = chip_smoke.sweeps_phase("cpu", 0, wd, "cpu", args=small,
                              scope_sizes=dict(n_users=60, n_items=40, n_ratings=1500))
assert rec["launches"] == {{"bpr_fwd": 0, "bpr_bwd": 0, "window_mips": 0}}, rec["launches"]
t = rec["tower_sweep"]
assert t["steps"] > 0 and t["row"]["popularity_ndcg@10"] == t["popularity_ndcg@10"], t
b = rec["blend_sweep"]
assert [r["beta"] for r in b["rows"]] == [0.0, 1.0, 2.0] and b["evaluate_calls"] == 3, b
assert rec["real_data"]["report"]["mode"] == "golden-fixture"
assert rec["ladder_sweep"]["dat_equal_to_cpu"] and len(rec["ranker_headroom"]["rows"]) == 6
print("sweeps", sorted(rec), rec["train_scope_bench"]["line"]["epochs"])
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert ("sweeps ['blend_sweep', 'ladder_sweep', 'launches', 'ranker_headroom', "
            "'real_data', 'seconds', 'tower_sweep', 'train_scope_bench'] 2") in proc.stdout


def test_store_and_package_import_without_redis_or_msgpack():
    """On a machine with neither ``redis`` nor ``msgpack`` (the card's has
    no ``redis``) the package imports, and the store takes the in-memory
    backend and writes JSON, as JAX's does there."""
    code = """
sys.modules["redis"] = None
sys.modules["msgpack"] = None
import json
import recommendit_tpu_torch
import chip_smoke
from recommendit_tpu_torch.features import RedisFeatureStore, store
assert not store.REDIS_AVAILABLE and not store.MSGPACK_AVAILABLE
fs = RedisFeatureStore("redis://localhost:6379")
fs.store_user_features(3, {"avg_rating": 4.0})
raw = fs._backend.read("user:feat:3")
print(fs.is_redis_available, fs.stats()["backend"], json.loads(raw), fs.get_user_features(3))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert ("False in-memory {'avg_rating': 4.0} {'avg_rating': 4.0}"
            in proc.stdout.splitlines()[-1])
