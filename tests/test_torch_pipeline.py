"""The port's pipeline orchestrator (``pipelines/run_pipeline.py``) against
the JAX one.

The JAX orchestrator runs ``data → features → embeddings → index`` on a
small synthetic set; a ranker is written with JAX's ``LambdaRankScorer``
(initialised, not trained: ranker training is not ported yet). Then the JAX
and the port's ``evaluate`` and ``skew`` stages run over the same models
directory — the port from its own ``features`` stage, since the two
packages' feature files differ (parquet, ``.npz``). Tolerances: the ranked
lists of every report row identical; every metric within 1e-6; the skew
reports equal.
"""
import json

import numpy as np
import pytest

from recommendit_tpu.config import Settings as JaxSettings
from recommendit_tpu_torch.config import Settings
from recommendit_tpu_torch.models import MIPSIndex, TwoTower
from recommendit_tpu_torch.pipelines import run_pipeline
from recommendit_tpu_torch.pipelines.run_pipeline import STAGES, PipelineOrchestrator

CFG = dict(SYNTH_USERS=200, SYNTH_ITEMS=160, SYNTH_RATINGS=12_000,
           EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128, TRAIN_EPOCHS=2,
           USE_PALLAS=False, SEED=0, TOP_K_CANDIDATES=60, STAGE_RECAL_EVERY=0)
EVAL_USERS = 150


def _jax_ranker(path, seed=1):
    import jax

    from recommendit_tpu.features.schema import FEATURE_COLUMNS
    from recommendit_tpu.models.ranker import LambdaRankScorer, init_mlp

    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    rng = np.random.default_rng(seed)
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=(32, 16),
                              query_norm=False)
    ranker.params = init_mlp(jax.random.PRNGKey(seed), len(names), (32, 16))
    ranker.feat_mean = rng.normal(size=len(names)).astype(np.float32)
    ranker.feat_std = rng.uniform(0.5, 2.0, len(names)).astype(np.float32)
    ranker._trained = True
    ranker.save(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX stages, then the JAX and the port's evaluate and skew; the
    ranked lists each evaluate scores, captured from its evaluate_model."""
    import recommendit_tpu.pipelines.run_pipeline as jrp

    tmp = tmp_path_factory.mktemp("pipeline")
    common = dict(data_dir=str(tmp / "ml"), models_dir=str(tmp / "models"),
                  synthetic=True, eval_users=EVAL_USERS)
    jorch = jrp.PipelineOrchestrator(cfg=JaxSettings(**CFG),
                                     features_dir=str(tmp / "jax_features"), **common)
    for stage in ("data", "features", "embeddings", "index"):
        jorch.run_stage(stage)
    _jax_ranker(jorch.cfg.RANKER_MODEL_PATH)

    jax_lists = []
    real = jrp.evaluate_model

    def spy(recs, truth, **kw):
        jax_lists.append(recs)
        return real(recs, truth, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp, "evaluate_model", spy)
        jax_report = jorch.run_stage("evaluate")
    jax_skew = jorch.run_stage("skew")

    torch_orch = PipelineOrchestrator(cfg=Settings(**CFG),
                                      features_dir=str(tmp / "port_features"),
                                      device="cpu", **common)
    torch_orch.run_stage("features")
    report = torch_orch.run_stage("evaluate")
    written = json.loads((tmp / "models" / "evaluation.json").read_text())
    skew = torch_orch.run_stage("skew")
    return dict(jax_report=jax_report, jax_lists=jax_lists, jax_skew=jax_skew,
                report=report, written=written, skew=skew, orch=torch_orch,
                tmp=tmp)


def test_evaluate_lists_identical(runs):
    lists = runs["orch"].eval_lists
    full, pop, retr = runs["jax_lists"]
    assert lists["full"] == full
    assert lists["popularity"] == pop
    assert lists["retrieval_only"] == retr
    assert len(full) == EVAL_USERS


def test_evaluate_report_matches(runs):
    want, got = runs["jax_report"], runs["report"]
    assert list(got) == list(want)
    for key, v in want.items():
        if isinstance(v, list):
            assert got[key] == v
        else:
            np.testing.assert_allclose(got[key], v, atol=1e-6, rtol=0, err_msg=key)
    assert runs["written"] == json.loads(json.dumps(got, default=float))
    assert "paired_ndcg10_se" in got and "retrieval_only_recall@20" in got


def test_skew_report_matches(runs):
    assert runs["skew"] == runs["jax_skew"]
    assert runs["skew"]["max_kl"] == 0.0 and not runs["skew"]["skew_detected"]
    assert runs["skew"]["n_features_checked"] == 50


def test_skew_sample_is_pandas_sample():
    """``DataFrame.sample(n, random_state=s)`` takes the first n of a
    ``RandomState(s)`` permutation, in that order."""
    import pandas as pd

    frame = pd.DataFrame({"x": np.arange(5000)})
    want = frame.sample(n=4000, random_state=7)["x"].values
    np.testing.assert_array_equal(np.random.RandomState(7).permutation(5000)[:4000],
                                  want)


@pytest.fixture(scope="module")
def own_run(tmp_path_factory):
    """The port's own features → embeddings → index → evaluate → skew on
    the CPU (in-batch BPR, the kernels' plain twins), after its data stage."""
    from recommendit_tpu_torch.models import LambdaRankScorer
    from recommendit_tpu_torch.features.schema import FEATURE_COLUMNS
    import torch

    tmp = tmp_path_factory.mktemp("own")
    orch = PipelineOrchestrator(
        cfg=Settings(**CFG, LOSS_MODE="in_batch"), data_dir=str(tmp / "ml"),
        models_dir=str(tmp / "models"), features_dir=str(tmp / "features"),
        synthetic=True, eval_users=10_000, device="cpu")
    orch.run_stage("data")
    for stage in ("features", "embeddings", "index"):
        orch.run_stage(stage)
    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=(8,), device="cpu")
    g = torch.Generator().manual_seed(0)
    ranker.params = {"w0": torch.randn(len(names), 8, generator=g),
                     "b0": torch.zeros(8), "w1": torch.randn(8, 1, generator=g),
                     "b1": torch.zeros(1)}
    ranker.feat_mean = np.zeros(len(names), np.float32)
    ranker.feat_std = np.ones(len(names), np.float32)
    ranker.save(orch.cfg.RANKER_MODEL_PATH)
    report = orch.run_stage("evaluate")
    return orch, report, orch.run_stage("skew")


def test_own_pipeline_on_the_cpu(own_run):
    orch, report, skew = own_run
    assert set(orch.stage_times) == {"data", "features", "embeddings", "index",
                                     "evaluate", "skew"}
    data = orch._load_data()
    view = orch._train_view()
    seen = {}
    for u, i in zip(view.user_id.tolist(), view.item_id.tolist()):
        seen.setdefault(u, set()).add(i)
    for row, lists in orch.eval_lists.items():
        assert len(lists) == report["n_users"] > 50, row
        for u, items in lists.items():
            assert len(items) == len(set(items)), (row, u)
            assert not set(items) & seen.get(u, set()), (row, u)
            assert all(1 <= i <= data.n_items for i in items)
            if row != "retrieval_only":     # backfilled / the whole catalog
                assert len(items) == 20, (row, u)
    # retrieval-only: the first 20 unseen of the top TOP_K_CANDIDATES, so a
    # user who has seen most of them gets fewer, as in the reference
    model = TwoTower.load(orch.cfg.EMBEDDING_MODEL_PATH, device="cpu")
    index = MIPSIndex.load(orch.cfg.INDEX_PATH, device="cpu")
    users = list(orch.eval_lists["retrieval_only"])
    q = np.stack([model.get_user_embedding(u) for u in users])
    _, ids = index.batch_search(q, k=min(CFG["TOP_K_CANDIDATES"], index.n_total))
    short = 0
    for row, u in enumerate(users):
        unseen = [int(i) for i in ids[row] if i not in seen.get(u, set())]
        assert orch.eval_lists["retrieval_only"][u] == unseen[:20]
        short += len(unseen) < 20
    assert short < len(users) // 4
    for key, v in report.items():
        if not isinstance(v, list):
            assert np.isfinite(v), key
    assert skew["max_kl"] == 0.0 and skew["n_features_checked"] == 50


def test_cli_stage_list():
    assert STAGES == ["data", "features", "embeddings", "index", "evaluate", "skew"]
    with pytest.raises(SystemExit):
        run_pipeline.main(["--stage", "ranker", "--device", "cpu"])
    with pytest.raises(SystemExit):
        run_pipeline.main(["--stage", "all", "--device", "cpu"])
    orch = PipelineOrchestrator(cfg=Settings(), device="cpu")
    with pytest.raises(ValueError, match="Unknown stage"):
        orch.run_stage("load_features")


def test_cli_data_stage_writes_the_files(tmp_path):
    cfg_env = {"SYNTH_USERS": "40", "SYNTH_ITEMS": "30", "SYNTH_RATINGS": "500"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run_pipeline, "default_settings", Settings(**{
            k: int(v) for k, v in cfg_env.items()}))
        run_pipeline.main(["--stage", "data", "--synthetic", "--device", "cpu",
                           "--data-dir", str(tmp_path / "ml"),
                           "--models-dir", str(tmp_path / "models")])
    for f in ("ratings.dat", "users.dat", "movies.dat", "README"):
        assert (tmp_path / "ml" / f).exists()


def test_data_stage_without_synthetic_raises(tmp_path):
    orch = PipelineOrchestrator(cfg=Settings(), data_dir=str(tmp_path / "ml"),
                                models_dir=str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="by hand"):
        orch.run_stage("data")


def test_embeddings_stage_refuses_what_is_not_ported(tmp_path):
    orch = PipelineOrchestrator(cfg=Settings(HOST_TABLE=True), models_dir=str(tmp_path),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="HOST_TABLE"):
        orch.run_embeddings()
    (tmp_path / "two_tower_ckpt" / "best").mkdir(parents=True)
    orch = PipelineOrchestrator(cfg=Settings(), models_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        orch.run_embeddings()
