"""The port's ``scripts/seed_variance.py`` against the JAX package's, on the
CPU.

Both scripts build their settings with ``Settings(SEED=seed)``; here the
two ``config.Settings`` are swapped for a small configuration (200 users x
160 items x 8,000 ratings, towers 16/32, 2 ranker epochs) and each script
runs 2 seeds at 1 epoch into its own work-dir. Then: the generated
``.dat`` files are bit-equal, ``seed_variance.json`` has JAX's keys, the
popularity row (no training) is equal, and the port's reports equal a
direct loop of the port's orchestrator at those seeds (data and features
once, then embeddings, index, ranker, evaluate at each seed).
"""
import functools
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

import recommendit_tpu.config as jax_config
import recommendit_tpu_torch.config as port_config
from recommendit_tpu_torch.scripts import seed_variance

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(SYNTH_USERS=200, SYNTH_ITEMS=160, SYNTH_RATINGS=8_000,
             EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128, RANKER_EPOCHS=2,
             RANKER_HIDDEN_DIMS=(16, 8), RANKER_CAND_NEGS=20, TOP_K_CANDIDATES=60)
SEEDS, EPOCHS, EVAL_USERS = 2, 1, 40


def _args(work: Path):
    return ["--seeds", str(SEEDS), "--data-dir", str(work / "ml"), "--work-dir",
            str(work), "--epochs", str(EPOCHS), "--eval-users", str(EVAL_USERS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seedvar")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_config, "Settings",
                   functools.partial(port_config.Settings, **SMALL))
        mp.setattr(jax_config, "Settings",
                   functools.partial(jax_config.Settings, **SMALL))
        result = seed_variance.run(seed_variance.parse_args(
            _args(tmp / "port") + ["--device", "cpu"]))
        mp.setattr(sys, "argv", ["seed_variance.py", *_args(tmp / "jax")])
        runpy.run_path(str(ROOT / "scripts" / "seed_variance.py"), run_name="__main__")
    return dict(result=result, tmp=tmp,
                written=json.loads((tmp / "port" / "seed_variance.json").read_text()),
                jax=json.loads((tmp / "jax" / "seed_variance.json").read_text()))


@pytest.mark.parametrize("name", ["ratings.dat", "users.dat", "movies.dat", "README"])
def test_generated_files_are_bit_equal(runs, name):
    port = (runs["tmp"] / "port" / "ml" / name).read_bytes()
    assert port == (runs["tmp"] / "jax" / "ml" / name).read_bytes()


def test_json_keys_and_popularity_equal(runs):
    got, want = runs["written"], runs["jax"]
    assert list(got) == list(want) == ["n_seeds", "metrics", "reports"]
    assert got["n_seeds"] == want["n_seeds"] == SEEDS
    assert list(got["metrics"]) == list(want["metrics"]) == seed_variance.KEYS
    for g, w in zip(got["reports"], want["reports"]):
        assert list(g) == list(w)
    assert got["metrics"]["popularity_ndcg@10"] == want["metrics"]["popularity_ndcg@10"]
    assert got["metrics"]["popularity_ndcg@10"]["std"] == 0.0
    assert got == json.loads(json.dumps(runs["result"], default=float))


def test_reports_equal_a_direct_loop_of_the_orchestrator(runs, tmp_path):
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator

    data_dir = runs["tmp"] / "port" / "ml"     # the script's generated data
    reports = []
    for seed in range(SEEDS):
        orch = PipelineOrchestrator(
            cfg=port_config.Settings(SEED=seed, TRAIN_EPOCHS=EPOCHS, **SMALL),
            data_dir=str(data_dir), models_dir=str(tmp_path / f"m{seed}"),
            features_dir=str(tmp_path / "features"), synthetic=True,
            eval_users=EVAL_USERS, device="cpu")
        if seed == 0:
            orch.run_stage("features")
        for stage in ("embeddings", "index", "ranker"):
            orch.run_stage(stage)
        reports.append(orch.run_stage("evaluate"))
    for got, want in zip(runs["result"]["reports"], reports):
        assert list(got) == list(want)
        for key, v in want.items():
            np.testing.assert_array_equal(got[key], v, err_msg=key)
    for key in seed_variance.KEYS:
        vals = np.array([r[key] for r in reports])
        assert runs["result"]["metrics"][key] == {"mean": float(np.nanmean(vals)),
                                                  "std": float(np.nanstd(vals))}


def _jax_popularity_row(data_dir: Path, seed: int, eval_users: int) -> dict:
    """The JAX package's popularity row with no training: its ``data``
    stage, then the lines of its ``run_evaluate`` that make the row
    (pandas' timestamp sort, the 90/10 split, train-time items filtered)."""
    from recommendit_tpu.config import Settings
    from recommendit_tpu.evaluation.metrics import evaluate_model
    from recommendit_tpu.pipelines.run_pipeline import PipelineOrchestrator

    orch = PipelineOrchestrator(cfg=Settings(SEED=seed), data_dir=str(data_dir / "ml"),
                                models_dir=str(data_dir / "models"),
                                features_dir=str(data_dir / "features"), synthetic=True,
                                eval_users=eval_users)
    orch.run_stage("data")
    r = orch._load_data().ratings.sort_values("timestamp")
    cut = int(len(r) * 0.9)
    train_r, test_r = r.iloc[:cut], r.iloc[cut:]
    truth = test_r[test_r["rating"] >= 4].groupby("user_id")["item_id"].apply(list).to_dict()
    users = list(truth.keys())[:eval_users]
    seen = {u: set(g.values) for u, g in train_r.groupby("user_id")["item_id"]}
    pop_all = train_r.groupby("item_id").size().sort_values(ascending=False).index.tolist()
    recs = {u: [int(i) for i in pop_all if i not in seen.get(u, ())][:20] for u in users}
    rep = evaluate_model(recs, truth, k_values=[10, 20])
    return {"popularity_ndcg@10": rep["ndcg@10"],
            "popularity_recall@20": rep["recall@20"], "popularity_mrr": rep["mrr"]}


def test_popularity_row_at_the_defaults_matches_jax(tmp_path):
    """At ``seed_variance``'s defaults (1,500 x 1,200 x 150,000, seed 0,
    150 users) the popularity row of ``tools/popularity_row.py`` (the
    port's data stage and evaluate lines) equals the JAX package's, to the
    last bit, on the same host."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import popularity_row
    finally:
        sys.path.remove(str(ROOT / "tools"))
    got = popularity_row.popularity_row(str(tmp_path / "port"), 0, 150)
    want = _jax_popularity_row(tmp_path / "jax", 0, 150)
    assert got["n_users"] == 150
    assert {k: got[k] for k in want} == want
    for name in ("ratings.dat", "movies.dat", "users.dat"):
        assert ((tmp_path / "port" / "ml" / name).read_bytes()
                == (tmp_path / "jax" / "ml" / name).read_bytes())
