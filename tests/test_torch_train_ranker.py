"""The port's ranker trainer (``training/train_ranker.py``) against the JAX one.

Both trainers get the same inner towers: each package's ``EmbeddingTrainer``
is replaced by one that returns, for a fold, a tower made from JAX's
``init_params`` (seeded by the fold's history size, with a random item
bias so the index has its bias column) — the JAX model on the JAX side,
the same params carried across with ``from_jax_params`` on the port's.
Then on the same synthetic ratings, 2 folds:

* ``_build_candidate_frames``: ``query_id``, ``user_id``, ``item_id``,
  ``label`` and ``retrieval_rank`` equal, the 50 contract features bit
  for bit, ``retrieval_score`` within 1e-5 (exact f32 searches in two
  frameworks);
* ``_evaluate_holdout`` of one saved ranker on those frames: equal
  reports (the same ranked lists);
* ``run`` from one carried-over ranker init: the same holdout report and
  best epoch;
* the pair-mode fallback (``_mine_hard_negatives``, ``_add_retrieval_score``)
  from one saved tower file: equal items, scores within 1e-5, the same
  holdout report.

The seed meets no near-tie of candidate scores between the frameworks
(the ids and ranks are equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import recommendit_tpu.models.ranker as jr
import recommendit_tpu.training.train_embeddings as jte
from recommendit_tpu.config import Settings as JaxSettings
from recommendit_tpu.data.synthetic import make_synthetic_movielens as jax_synth
from recommendit_tpu.models.two_tower import TwoTowerModel
from recommendit_tpu.models.two_tower import init_params as jax_init
from recommendit_tpu.training.train_ranker import RankerTrainer as JaxRankerTrainer
from recommendit_tpu_torch.config import Settings
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.features.schema import FEATURE_COLUMNS
from recommendit_tpu_torch.models import LambdaRankScorer
from recommendit_tpu_torch.models import ranker as tr
from recommendit_tpu_torch.models.two_tower import from_jax_params
from recommendit_tpu_torch.training import RankerTrainer
from recommendit_tpu_torch.training import train_ranker as ttr

DATA = dict(n_users=120, n_items=90, n_ratings=4000, seed=1)
DIM, HIDDEN = 16, 32
CFG = dict(EMBEDDING_DIM=DIM, HIDDEN_DIM=HIDDEN, TOP_K_CANDIDATES=60,
           RANKER_CAND_NEGS=20, RANKER_MAX_QUERIES=40, RANKER_HIDDEN_DIMS=(16, 8),
           RANKER_EPOCHS=3, RANKER_GROUP_SIZE=16, RANKER_EARLY_STOP_ROUNDS=2, SEED=0)
RANKER_HIDDEN = (16, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return jax_synth(**DATA), make_synthetic_movielens(**DATA)


def _tower_params(n_users, n_items, n_ratings):
    params = {k: np.asarray(v) for k, v in jax_init(
        jax.random.PRNGKey(n_ratings % 1009), n_users, n_items, DIM, HIDDEN).items()}
    params["item_bias"] = (0.3 * np.random.default_rng(n_ratings).normal(
        size=n_items + 1)).astype(np.float32)
    return params


class _JaxInner:
    """Stands in for JAX's EmbeddingTrainer: the fold's fixed tower."""

    def __init__(self, data, cfg, model_output_path=None, **_):
        self.data, self.cfg = data, cfg

    def train(self, *a, **k):
        d = self.data
        p = _tower_params(d.n_users, d.n_items, len(d.ratings))
        return TwoTowerModel(d.n_users, d.n_items, DIM, HIDDEN, dropout=0.0,
                             params={k: jnp.asarray(v) for k, v in p.items()})


class _PortInner:
    """Stands in for the port's EmbeddingTrainer: the same tower, carried."""

    def __init__(self, data, cfg, model_output_path=None, device="cpu", **_):
        self.data = data

    def train(self, *a, **k):
        d = self.data
        return from_jax_params(_tower_params(d.n_users, d.n_items, len(d)),
                               dropout=0.0, device="cpu")


@pytest.fixture
def inner_towers(monkeypatch):
    monkeypatch.setattr(jte, "EmbeddingTrainer", _JaxInner)
    monkeypatch.setattr(ttr, "EmbeddingTrainer", _PortInner)


def _frames_equal(jdf: pd.DataFrame, got: dict, tol=1e-5):
    assert list(got) == list(jdf.columns)
    for c in ("query_id", "user_id", "item_id", "label", "retrieval_rank"):
        np.testing.assert_array_equal(got[c], jdf[c].values, err_msg=c)
        assert got[c].dtype == jdf[c].values.dtype, c
    for c in FEATURE_COLUMNS:
        np.testing.assert_array_equal(got[c], jdf[c].values, err_msg=c)
    np.testing.assert_allclose(got["retrieval_score"], jdf["retrieval_score"].values,
                               rtol=0, atol=tol)


@pytest.fixture
def candidate_frames(data, inner_towers):
    jt = JaxRankerTrainer(data[0], JaxSettings(**CFG))
    tt = RankerTrainer(data[1], Settings(**CFG), device="cpu")
    return jt, tt, jt._build_candidate_frames(), tt._build_candidate_frames()


def test_candidate_frames_match_jax(candidate_frames):
    _, _, (jtrain, jtest, jextra), (train, test, extra) = candidate_frames
    assert extra == jextra == ["retrieval_score", "retrieval_rank"]
    _frames_equal(jtrain, train)
    _frames_equal(jtest, test)
    # both folds, the query subsample, labels of both kinds, the 9/1 split
    assert set(np.unique(train["query_id"] // (DATA["n_users"] + 1))) == {0, 1}
    assert len(np.unique(train["query_id"])) <= 2 * CFG["RANKER_MAX_QUERIES"]
    assert 0 < train["label"].mean() < 0.5
    assert not set(test["user_id"]) & set(train["user_id"])


def test_holdout_report_matches_jax(candidate_frames, tmp_path):
    jt, tt, (_, jtest, extra), (_, test, _) = candidate_frames
    cols = FEATURE_COLUMNS + extra
    rng = np.random.default_rng(3)
    jranker = jr.LambdaRankScorer(feature_names=cols, hidden_dims=RANKER_HIDDEN)
    jranker.params = jr.init_mlp(jax.random.PRNGKey(4), len(cols), RANKER_HIDDEN)
    jranker.feat_mean = rng.normal(size=len(cols)).astype(np.float32)
    jranker.feat_std = rng.uniform(0.5, 2.0, len(cols)).astype(np.float32)
    jranker._trained = True
    jranker.save(str(tmp_path / "r.npz"))
    jtest = jtest.sort_values("query_id")
    test = ttr.take(test, ttr.pandas_order(test["query_id"]))
    want = jt._evaluate_holdout(jranker, jtest, cols)
    got = tt._evaluate_holdout(LambdaRankScorer.load(str(tmp_path / "r.npz"),
                                                     device="cpu"), test, cols)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert got["n_queries"] > 5 and "base_ndcg@10" in got


def _shifted_pqn(x, q):
    _, first = np.unique(q, return_index=True)
    return _ORIG_PQN(x - x[first][q], q)


_ORIG_PQN = jr.per_query_normalize


def _run_both(data, monkeypatch, tmp_path, n_feat, **cfg_kw):
    """Both trainers' ``run`` from one ranker init (JAX's ``init_mlp``
    carried across) and, on the JAX side, the first-row shift."""
    cfg = dict(CFG, **cfg_kw)
    p = {k: np.asarray(v) for k, v in jr.init_mlp(
        jax.random.PRNGKey(5), n_feat, RANKER_HIDDEN).items()}
    monkeypatch.setattr(jr, "init_mlp", lambda *a: {k: jnp.asarray(v) for k, v in p.items()})
    monkeypatch.setattr(jr, "per_query_normalize", _shifted_pqn)
    monkeypatch.setattr(tr, "init_mlp", lambda *a: tr.from_jax_params(p, "cpu"))
    jt = JaxRankerTrainer(data[0], JaxSettings(**cfg),
                          ranker_output_path=str(tmp_path / "jax.npz"))
    jranker = jt.run()
    tt = RankerTrainer(data[1], Settings(**cfg),
                       ranker_output_path=str(tmp_path / "port.npz"), device="cpu")
    ranker = tt.run()
    return jt, jranker, tt, ranker


def test_run_matches_jax(data, inner_towers, monkeypatch, tmp_path):
    jt, jranker, tt, ranker = _run_both(data, monkeypatch, tmp_path, 52)
    assert tt.holdout_metrics == pytest.approx(jt.holdout_metrics, rel=1e-9, abs=1e-12)
    assert ranker.best_iteration == jranker.best_iteration >= 1
    for key, want in jranker.evals_result.items():
        np.testing.assert_allclose(ranker.evals_result[key], want, rtol=1e-4)
    assert ranker.feature_names == jranker.feature_names == tt.feature_cols
    back = jr.LambdaRankScorer.load(str(tmp_path / "port.npz"))
    assert back.query_norm and back.feature_names == ranker.feature_names
    assert len(tt.test_feats["label"]) > 0


def test_pair_mode_fallback_matches_jax(data, monkeypatch, tmp_path):
    """RANKER_CAND_FOLDS x RANKER_LABEL_FRACTION > 0.5 raises inside the
    candidate build, and both trainers fall back to the training pairs,
    with hard negatives and retrieval scores from one saved tower."""
    p = _tower_params(data[1].n_users, data[1].n_items, 7)
    TwoTowerModel(data[1].n_users, data[1].n_items, DIM, HIDDEN,
                  params={k: jnp.asarray(v) for k, v in p.items()}).save(
        str(tmp_path / "tt.npz"))
    kw = dict(RANKER_CAND_FOLDS=6, EMBEDDING_MODEL_PATH=str(tmp_path / "tt.npz"),
              RANKER_HARD_NEG_POOL=40)
    with pytest.raises(RuntimeError, match="more than half"):
        RankerTrainer(data[1], Settings(**CFG, **kw), device="cpu")._build_candidate_frames()
    jt, jranker, tt, ranker = _run_both(data, monkeypatch, tmp_path, 51, **kw)
    assert tt.feature_cols == FEATURE_COLUMNS + ["retrieval_score"]
    assert tt.holdout_metrics == pytest.approx(jt.holdout_metrics, rel=1e-9, abs=1e-12)
    assert ranker.best_iteration == jranker.best_iteration


def test_hard_negatives_and_retrieval_score_match_jax(data, tmp_path):
    from recommendit_tpu.features.engineering import FeatureEngineer as JaxFE
    from recommendit_tpu_torch.features.engineering import FeatureEngineer

    p = _tower_params(data[1].n_users, data[1].n_items, 11)
    TwoTowerModel(data[1].n_users, data[1].n_items, DIM, HIDDEN,
                  params={k: jnp.asarray(v) for k, v in p.items()}).save(
        str(tmp_path / "tt.npz"))
    kw = dict(CFG, EMBEDDING_MODEL_PATH=str(tmp_path / "tt.npz"), RANKER_HARD_NEG_POOL=40)
    jfe, fe = JaxFE(seed=0), FeatureEngineer(seed=0)
    jfe.set_data(data[0])
    fe.set_data(data[1])
    jpairs, _ = jfe.build_training_pairs(n_negatives=4, seed=0)
    pairs, _ = fe.build_training_pairs(n_negatives=4, seed=0)
    jt = JaxRankerTrainer(data[0], JaxSettings(**kw))
    tt = RankerTrainer(data[1], Settings(**kw), device="cpu")
    jmined, mined = jt._mine_hard_negatives(jpairs), tt._mine_hard_negatives(pairs)
    np.testing.assert_array_equal(mined["item_id"], jmined["item_id"].values)
    assert (mined["item_id"] != pairs["item_id"]).sum() > 50
    jcols, cols = jt._add_retrieval_score(jmined), tt._add_retrieval_score(mined)
    assert cols == jcols == ["retrieval_score"]
    np.testing.assert_allclose(mined["retrieval_score"], jmined["retrieval_score"].values,
                               rtol=0, atol=1e-5)


def test_fold_cache_round_trip(data, inner_towers, tmp_path, monkeypatch):
    cfg = Settings(**CFG, RANKER_FOLD_CACHE_DIR=str(tmp_path / "cache"))
    first = RankerTrainer(data[1], cfg, device="cpu")._build_candidate_frames()
    assert len(list((tmp_path / "cache").glob("cand_fold*_*.npz"))) == 2

    class _Refuse:
        def __init__(self, *a, **k):
            raise AssertionError("a cached fold trained a tower")

    monkeypatch.setattr(ttr, "EmbeddingTrainer", _Refuse)
    again = RankerTrainer(data[1], cfg, device="cpu")._build_candidate_frames()
    for a, b in zip(first[:2], again[:2]):
        assert list(a) == list(b)
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])


GBDT_CFG = dict(CFG, RANKER_TYPE="gbdt", GBDT_N_ESTIMATORS=12, GBDT_MAX_DEPTH=3,
                GBDT_N_BINS=16)


def test_gbdt_run_matches_jax(data, inner_towers, tmp_path):
    """``RANKER_TYPE=gbdt``: both trainers boost on their (equal) candidate
    frames and give the same trees, best iteration and holdout report;
    leaf values within 1e-6 (the gradients are f32 in two frameworks)."""
    from recommendit_tpu.models.gbdt import HistGBDTRanker as JaxGBDT
    from recommendit_tpu_torch.models import HistGBDTRanker

    jt = JaxRankerTrainer(data[0], JaxSettings(**GBDT_CFG),
                          ranker_output_path=str(tmp_path / "jax.npz"))
    jranker = jt.run()
    tt = RankerTrainer(data[1], Settings(**GBDT_CFG),
                       ranker_output_path=str(tmp_path / "port.npz"), device="cpu")
    ranker = tt.run()
    assert isinstance(jranker, JaxGBDT) and isinstance(ranker, HistGBDTRanker)
    assert ranker.backend_used == "numpy"          # "auto" on the CPU
    assert tt.holdout_metrics == pytest.approx(jt.holdout_metrics, rel=1e-9, abs=1e-12)
    assert ranker.best_iteration == jranker.best_iteration >= 1
    assert ranker.early_stop_rounds == jranker.early_stop_rounds == 10
    assert len(ranker.trees) == len(jranker.trees) >= ranker.best_iteration
    for a, b in zip(jranker.trees, ranker.trees):
        for attr in ("feature", "bin_threshold", "left", "right"):
            np.testing.assert_array_equal(getattr(b, attr), getattr(a, attr))
        np.testing.assert_allclose(b.value, a.value, rtol=0, atol=1e-6)
    assert ranker.feature_names == jranker.feature_names == tt.feature_cols
    back = JaxGBDT.load(str(tmp_path / "port.npz"))
    x = np.stack([tt.test_feats[c] for c in tt.feature_cols], 1).astype(np.float32)
    np.testing.assert_array_equal(back.predict(x), ranker.predict(tt.test_feats))


def test_pandas_order_is_sort_values():
    rng = np.random.default_rng(2)
    v = rng.integers(0, 6, 500).astype(np.float32)
    frame = pd.DataFrame({"v": v, "i": np.arange(500)})
    for asc in (True, False):
        want = frame.sort_values("v", ascending=asc)["i"].values
        np.testing.assert_array_equal(ttr.pandas_order(v, ascending=asc), want)
