"""The port's ``real_data`` driver (``recommendit_tpu_torch/scripts/
real_data.py``) against JAX's (``scripts/real_data.py``) on its
golden-fixture branch, on the CPU.

Both drivers run with a ``--data-dir`` that holds no data set, so both
try the download, and both packages' ``MOVIELENS_1M_URL`` point at a
``file://`` path that does not exist: the download raises
``RuntimeError``, as a blocked one does, no socket is opened, and both
copy ``tests/fixtures/ml1m_golden`` (30 users x 21 movies, the real
files' quirks) and run every stage with JAX's shrunk settings. Held: the
report's keys are JAX's, ``mode`` is ``"golden-fixture"`` in both, the
port's ``blocked_syscall`` is its download's error, and every stage has
its seconds; JAX's ``features`` stage on the port's copy of the data
and JAX's ``evaluate`` over the port's models directory give the port's
evaluation within 1e-6 (its report rounds to 4 decimals, as JAX's does);
the port's default paths lie under the temp directory and its run with
them writes nothing in the repo.
"""
import json
import runpy
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from recommendit_tpu.config import Settings as JaxSettings
from recommendit_tpu_torch.scripts import real_data

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
ARGS = ["--eval-users", "50", "--cfg", "RANKER_QUERY_NORM=false"]
GOLDEN_CFG = dict(TRAIN_EPOCHS=2, TOP_K_CANDIDATES=10, RANKER_EPOCHS=4,
                  RANKER_LABEL_FRACTION=0.3, RANKER_CAND_FOLDS=1,
                  RANKER_QUERY_NORM=False)
ROWS = {"popularity": ("popularity_ndcg@10", "popularity_recall@20", "popularity_mrr"),
        "retrieval_only": ("retrieval_only_ndcg@10", "retrieval_only_recall@20",
                           "retrieval_only_mrr"),
        "full": ("ndcg@10", "recall@20", "mrr")}


def _repo_status():
    return subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"],
                          cwd=ROOT, capture_output=True, text=True).stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import recommendit_tpu.data.movielens as jml
    import recommendit_tpu.pipelines.run_pipeline as jrp
    import recommendit_tpu_torch.data.movielens as tml

    tmp = tmp_path_factory.mktemp("real")
    missing = (tmp / "no-such-ml-1m.zip").as_uri()
    before = _repo_status()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        # the port's defaults, under this test's temp directory
        mp.setattr(tempfile, "tempdir", str(tmp / "port_tmp"))
        mp.setattr(tml, "MOVIELENS_1M_URL", missing)
        (tmp / "port_tmp").mkdir()
        defaults = real_data.parse_args(ARGS + ["--device", "cpu"])
        report = real_data.run(defaults)
    torch.set_num_threads(n)

    jax_dir = tmp / "jax"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jml, "MOVIELENS_1M_URL", missing)
        mp.setattr(sys, "argv", ["real_data.py", *ARGS,
                                 "--data-dir", str(jax_dir / "ml-1m"),
                                 "--models-dir", str(jax_dir / "models"),
                                 "--features-dir", str(jax_dir / "features"),
                                 "--out", str(jax_dir / "REALDATA.json")])
        runpy.run_path(str(ROOT / "scripts" / "real_data.py"), run_name="__main__")
    jax_report = json.loads((jax_dir / "REALDATA.json").read_text())

    orch = jrp.PipelineOrchestrator(
        cfg=JaxSettings(**GOLDEN_CFG), data_dir=defaults.data_dir,
        models_dir=defaults.models_dir, features_dir=str(tmp / "jax_features"),
        synthetic=False, eval_users=50)
    orch.run_stage("features")
    jax_eval = orch.run_stage("evaluate")
    port_eval = json.loads((Path(defaults.models_dir) / "evaluation.json").read_text())
    return dict(report=report, jax_report=jax_report, jax_eval=jax_eval,
                port_eval=port_eval, defaults=defaults, tmp=tmp, missing=missing,
                repo_changed=_repo_status() != before)


def test_reports_have_jax_s_keys_and_mode(runs):
    got, want = runs["report"], runs["jax_report"]
    assert list(got) == list(want)
    assert got["mode"] == want["mode"] == "golden-fixture"
    assert got["comparable_to_reference"] is want["comparable_to_reference"] is False
    assert got["reference_targets_ndcg10_recall20_mrr"] == \
        want["reference_targets_ndcg10_recall20_mrr"]
    assert list(got["stage_seconds"]) == list(want["stage_seconds"]) == \
        ["features", "embeddings", "index", "ranker", "evaluate"]
    assert got["eval_users"] == want["eval_users"] > 0
    assert got["blocked_syscall"].startswith(
        "download_movielens: Cannot download MovieLens-1M")
    assert str(Path(runs["missing"][len("file://"):])) in got["blocked_syscall"]
    written = json.loads(Path(runs["defaults"].out).read_text())
    assert written == got


def test_jax_evaluate_on_the_port_s_models_gives_its_ladder(runs):
    port, jax = runs["port_eval"], runs["jax_eval"]
    ladder = runs["report"]["measured_ladder_ndcg10_recall20_mrr"]
    for row, keys in ROWS.items():
        for j, key in enumerate(keys):
            np.testing.assert_allclose(port[key], jax[key], rtol=0, atol=TOL, err_msg=key)
            assert ladder[row][j] == round(float(port[key]), 4), key


def test_golden_files_copied_and_nothing_written_in_the_repo(runs):
    data_dir = Path(runs["defaults"].data_dir)
    for name in real_data.DAT_FILES:
        assert (data_dir / name).read_bytes() == (real_data.GOLDEN / name).read_bytes()
    for path in (runs["defaults"].data_dir, runs["defaults"].models_dir,
                 runs["defaults"].features_dir, runs["defaults"].out):
        assert Path(path).resolve().is_relative_to(runs["tmp"].resolve()), path
    assert not runs["repo_changed"]


def test_default_paths_lie_under_the_temp_directory():
    args = real_data.parse_args([])
    tmp = Path(tempfile.gettempdir()).resolve()
    for path in (args.data_dir, args.models_dir, args.features_dir, args.out):
        assert Path(path).resolve().is_relative_to(tmp), path
        assert not Path(path).resolve().is_relative_to(ROOT), path
