"""Three of the port's sweep drivers (``recommendit_tpu_torch/scripts/
tower_sweep.py``, ``ladder_sweep.py``, ``blend_sweep.py``) against the JAX
package's (``scripts/``) on the CPU, at a tiny size (150 users x 120 items
x 6,000 ratings, towers 16/32, 1 tower epoch, 3 ranker epochs).

* ``tower_sweep``, 2 seeds: JAX's own ``run_one`` on the port's work-dir,
  with its ``embeddings`` and ``index`` stages stubbed out, scores the
  port's towers and index with JAX's code. Each row's retrieval fields
  agree within 1e-6, the popularity row exactly, the keys are JAX's; the
  aggregate line is JAX's formula.
* ``ladder_sweep`` under ``--weights`` (a dict of ``SynthWeights``
  overrides), with ``RANKER_QUERY_NORM=false`` through ``--cfg`` (C.8:
  only without the query norm do the two packages rank one ranker's
  candidates alike): the ``.dat`` files are the generator's under those
  weights; JAX's ``features`` stage on the port's data and JAX's
  ``evaluate`` over the port's models directory give every ladder field
  within 1e-6; JAX's ``main``, fed the port's per-seed reports, writes the
  very lines the port's log holds.
* ``blend_sweep`` at β = 0, 1, 2 over a work-dir holding the ladder run's
  data, models and features: JAX's own driver on the same work-dir (its
  features read from JAX's ``features`` stage) gives the same keys and
  every row within 1e-6; the ``retrieval_only_*`` fields do not move with
  β.
"""
import importlib.util
import json
import os
import runpy
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from recommendit_tpu.config import Settings as JaxSettings
from recommendit_tpu_torch.scripts import blend_sweep, ladder_sweep, tower_sweep

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
SIZE = dict(SYNTH_USERS=150, SYNTH_ITEMS=120, SYNTH_RATINGS=6000)
TINY = dict(EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128, USE_PALLAS=False,
            TOP_K_CANDIDATES=60, RANKER_EPOCHS=3, RANKER_CAND_NEGS=20,
            RANKER_QUERY_NORM=False)
WEIGHTS = {"exposure_quality": 0.2, "latent": 1.1}
EVAL_USERS = 60


def _cfg_args(d):
    return [a for k, v in d.items() for a in ("--cfg", f"{k}={str(v).lower()}"
                                              if isinstance(v, bool) else f"{k}={v}")]


def _jax_script(name: str):
    """JAX's driver ``scripts/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ #
# tower_sweep                                                          #
# ------------------------------------------------------------------ #

TOWER_ARGS = ["--name", "tiny", "--seeds", "2", "--users", "150", "--items", "120",
              "--ratings", "6000", "--eval-users", str(EVAL_USERS),
              *_cfg_args(dict(TINY, TRAIN_EPOCHS=1))]


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    import recommendit_tpu.pipelines.run_pipeline as jrp

    tmp = tmp_path_factory.mktemp("tower")
    args = tower_sweep.parse_args(TOWER_ARGS + ["--work-dir", str(tmp / "work"),
                                                "--log", str(tmp / "log.jsonl"),
                                                "--device", "cpu"])
    lines = tower_sweep.run(args)
    real = jrp.PipelineOrchestrator.run_stage
    jax = _jax_script("tower_sweep")
    with pytest.MonkeyPatch.context() as mp:
        # the port's towers and index stand in for JAX's stages
        mp.setattr(jrp.PipelineOrchestrator, "run_stage",
                   lambda self, stage: None if stage in ("embeddings", "index")
                   else real(self, stage))
        jax_rows = [jax.run_one("tiny", s, Namespace(**vars(args))) for s in (0, 1)]
    return dict(lines=lines, jax_rows=jax_rows, log=tmp / "log.jsonl", args=args)


def test_tower_sweep_rows_equal_jax_s_scoring(tower):
    rows, jax_rows = tower["lines"][:2], tower["jax_rows"]
    for row, want in zip(rows, jax_rows):
        assert list(row) == list(want)
        assert row["popularity_ndcg@10"] == want["popularity_ndcg@10"]   # exact
        for key in ("retrieval_ndcg@10", "retrieval_recall@20", "retrieval_mrr",
                    "ret_over_pop"):
            np.testing.assert_allclose(row[key], want[key], rtol=0, atol=TOL, err_msg=key)
        assert row["cfg"] == want["cfg"] and row["seed"] in (0, 1)
        assert row["retrieval_ndcg@10"] > 0


def test_tower_sweep_aggregate_and_log(tower):
    rows, agg = tower["lines"][:2], tower["lines"][2]
    assert list(agg) == ["name", "agg", "n_seeds", "retrieval_ndcg@10", "std",
                         "popularity_ndcg@10", "ret_over_pop"]
    assert agg["retrieval_ndcg@10"] == float(np.mean([r["retrieval_ndcg@10"] for r in rows]))
    logged = [json.loads(x) for x in tower["log"].read_text().splitlines()]
    assert logged == json.loads(json.dumps(tower["lines"], default=float))
    # the shared data set was generated once, into the work-dir
    assert (Path(tower["args"].work_dir) / "data" / "ratings.dat").exists()


# ------------------------------------------------------------------ #
# ladder_sweep                                                         #
# ------------------------------------------------------------------ #

LADDER_ARGS = ["--name", "w", "--weights", json.dumps(WEIGHTS), "--epochs", "1",
               "--eval-users", str(EVAL_USERS), *_cfg_args(dict(SIZE, **TINY))]


def _jax_features_and_evaluate(data_dir, models_dir, features_dir, **cfg):
    import recommendit_tpu.pipelines.run_pipeline as jrp

    orch = jrp.PipelineOrchestrator(
        cfg=JaxSettings(**cfg), data_dir=str(data_dir), models_dir=str(models_dir),
        features_dir=str(features_dir), synthetic=False, eval_users=EVAL_USERS)
    if not (Path(features_dir) / "user_features.parquet").exists():
        orch.run_stage("features")
    return orch.run_stage("evaluate")


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ladder")
    work, log = tmp / "work", tmp / "log.jsonl"
    args = ladder_sweep.parse_args(LADDER_ARGS + ["--work-dir", str(work), "--log", str(log),
                                                  "--device", "cpu"])
    out = ladder_sweep.run(args)
    jax_eval = _jax_features_and_evaluate(work / "w_data", work / "w_s0" / "models",
                                          tmp / "jax_features", SEED=0, TRAIN_EPOCHS=1,
                                          **SIZE, **TINY)
    # JAX's main over the port's per-seed reports: JAX's lines and aggregate
    jax = _jax_script("ladder_sweep")
    jax_log = tmp / "jax_log.jsonl"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "run_one", lambda name, weights, seed, a: out["reports"][seed])
        mp.setattr(sys, "argv", ["ladder_sweep.py", *LADDER_ARGS, "--work-dir",
                                 str(tmp / "unused"), "--log", str(jax_log)])
        jax.main()
    return dict(out=out, jax_eval=jax_eval, log=log, jax_log=jax_log, work=work, tmp=tmp)


def test_ladder_data_is_the_generator_s_under_the_weights(ladder, tmp_path):
    from recommendit_tpu.data.movielens import save_movielens as jax_save
    from recommendit_tpu.data.synthetic import make_synthetic_movielens as jax_synth

    jax_save(jax_synth(n_users=150, n_items=120, n_ratings=6000, seed=0,
                       weights=WEIGHTS), str(tmp_path))
    for name in ("ratings.dat", "users.dat", "movies.dat"):
        assert (ladder["work"] / "w_data" / name).read_bytes() == \
            (tmp_path / name).read_bytes(), name


def test_jax_evaluate_reproduces_the_ladder(ladder):
    rep, want = ladder["out"]["reports"][0], ladder["jax_eval"]
    for key in ladder_sweep.KEYS + ["paired_ndcg10_full_minus_retrieval"]:
        np.testing.assert_allclose(rep[key], want[key], rtol=0, atol=TOL, err_msg=key)
    assert rep["holdout_n_queries"] > 0 and np.isfinite(rep["ndcg@10"])


def test_ladder_lines_are_jax_s(ladder):
    port = [json.loads(x) for x in ladder["log"].read_text().splitlines()]
    jax = [json.loads(x) for x in ladder["jax_log"].read_text().splitlines()]
    assert port == jax
    assert [list(x) for x in port] == [list(x) for x in jax]
    summary = port[-1]
    assert summary["agg"] and summary["weights"] == WEIGHTS
    assert summary == json.loads(json.dumps(ladder["out"]["summary"]))
    assert {"ret_over_pop", "full_over_ret", "std_ndcg@10"} <= set(summary)


# ------------------------------------------------------------------ #
# blend_sweep                                                          #
# ------------------------------------------------------------------ #

BLEND_ARGS = ["--betas", "0,1,2", "--eval-users", str(EVAL_USERS), "--users", "150",
              "--items", "120", "--cfg", "RANKER_QUERY_NORM=false",
              "--cfg", "USE_PALLAS=false"]


@pytest.fixture(scope="module")
def blend(ladder):
    import recommendit_tpu.pipelines.run_pipeline as jrp

    tmp = ladder["tmp"]
    work = tmp / "qscale"
    work.mkdir()
    # a quality_at_scale-shaped work-dir: the ladder run's data, models, features
    for link, target in (("ml", ladder["work"] / "w_data"),
                         ("models", ladder["work"] / "w_s0" / "models"),
                         ("features", ladder["work"] / "w_s0" / "features")):
        os.symlink(target, work / link)
    rows = blend_sweep.run(blend_sweep.parse_args(
        BLEND_ARGS + ["--work-dir", str(work), "--out", str(tmp / "blend.json"),
                      "--device", "cpu"]))
    real_init = jrp.PipelineOrchestrator.__init__

    def init(self, *a, **k):
        # JAX reads its own feature files (parquet), made by its features stage
        real_init(self, *a, **{**k, "features_dir": str(tmp / "jax_features")})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp.PipelineOrchestrator, "__init__", init)
        mp.setattr(sys, "argv", ["blend_sweep.py", *BLEND_ARGS, "--work-dir", str(work),
                                 "--out", str(tmp / "jax_blend.json")])
        runpy.run_path(str(ROOT / "scripts" / "blend_sweep.py"), run_name="__main__")
    return dict(rows=rows, jax_rows=json.loads((tmp / "jax_blend.json").read_text()),
                written=json.loads((tmp / "blend.json").read_text()))


def test_blend_rows_equal_jax_s_driver(blend):
    rows, jax_rows = blend["rows"], blend["jax_rows"]
    assert [r["beta"] for r in rows] == [r["beta"] for r in jax_rows] == [0.0, 1.0, 2.0]
    for row, want in zip(rows, jax_rows):
        assert list(row) == list(want)
        assert row["n_eval_users"] == want["n_eval_users"] > 0
        for key, v in want.items():
            if key not in ("beta", "n_eval_users"):
                np.testing.assert_allclose(row[key], v, rtol=0, atol=TOL,
                                           err_msg=f"beta {row['beta']} {key}")
    assert blend["written"] == json.loads(json.dumps(rows, default=float))


def test_blend_leaves_the_retrieval_rows_alone(blend):
    rows = blend["rows"]
    for key in ("retrieval_only_ndcg@10", "retrieval_only_recall@20"):
        assert len({r[key] for r in rows}) == 1, key
    assert all(np.isfinite(r["full_ndcg@10"]) for r in rows)


def test_cfg_overrides_are_jax_tower_sweep_s():
    """``--cfg`` as JAX's ``tower_sweep._apply_cfg`` applies it (bools,
    tuples of the first element's type, the field's type), which every
    port driver shares (``quality_at_scale.apply_overrides``)."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides

    pairs = ["FILTER_SEEN=false", "RANKER_HIDDEN_DIMS=32,16", "TRAIN_EPOCHS=3",
             "LOSS_MODE=in_batch", "LEARNING_RATE=0.01", "USE_PALLAS=1"]
    want = _jax_script("tower_sweep")._apply_cfg(JaxSettings(), pairs)
    got = apply_overrides(Settings(), pairs)
    for kv in pairs:
        key = kv.split("=")[0]
        assert getattr(got, key) == getattr(want, key), key
        assert type(getattr(got, key)) is type(getattr(want, key)), key
    assert got.RANKER_HIDDEN_DIMS == (32, 16) and got.FILTER_SEEN is False
    assert apply_overrides(Settings(), []) == Settings()
