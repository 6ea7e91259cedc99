"""Models of the serve path: the torch port against the JAX package on the
same saved files.

Tolerances: towers 1e-5 (two f32 matmuls and a normalisation); ranker
scores 1e-4 (standardisation over the candidate axis amplifies f32
summation-order noise); exact-index ids identical after
``canonical_tie_order``; approx-index recall >= 0.95 against exact.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.models.ranker import LambdaRankScorer as JaxRanker, init_mlp
from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex
from recommendit_tpu.models.two_tower import TwoTowerModel
from recommendit_tpu.ops.topk import canonical_tie_order as jax_canonical
from recommendit_tpu_torch.models import (
    MIPSIndex,
    TwoTower,
    load_ranker,
)
from recommendit_tpu_torch.ops.topk import canonical_tie_order


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    path = tmp_path_factory.mktemp("towers") / "two_tower.npz"
    jm = TwoTowerModel(50, 300, 16, 32, seed=3)
    rng = np.random.default_rng(0)
    jm.params["item_bias"] = jnp.asarray(rng.normal(size=301), jnp.float32)
    jm.save(str(path))
    return jm, TwoTower.load(str(path), device="cpu"), path


def test_user_tower_matches(towers):
    jm, tm, _ = towers
    ids = np.arange(0, 51)
    want = np.asarray(jm._jit_user(jm.params, jnp.asarray(ids)))
    got = tm.user_tower(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_item_tower_matches(towers):
    jm, tm, _ = towers
    rng = np.random.default_rng(1)
    ids = np.arange(1, 301)
    genres = rng.integers(0, 2, (300, 18)).astype(np.float32)
    want = jm.get_item_embeddings(ids, genres)
    got = tm.get_item_embeddings(ids, genres, batch_size=128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.item_bias_np(ids), jm.item_bias_np(ids))


def test_tower_save_round_trips_through_jax(towers, tmp_path):
    jm, tm, _ = towers
    tm.save(str(tmp_path / "t.npz"))
    back = TwoTowerModel.load(str(tmp_path / "t.npz"))
    for name, v in jm.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[name]), np.asarray(v))
    meta = json.loads((tmp_path / "t.npz.meta.json").read_text())
    assert meta == {"n_users": 50, "n_items": 300, "embed_dim": 16,
                    "hidden_dim": 32, "dropout": 0.2}


def test_from_numpy_checks_shapes(towers):
    jm, _, _ = towers
    params = {k: np.asarray(v) for k, v in jm.params.items()}
    params["user_w1"] = params["user_w1"][:, :5]
    with pytest.raises(ValueError, match="user_w1"):
        TwoTower.from_numpy(params, 50, 300, 16, 32, device="cpu")


def test_missing_item_bias_loads_as_zeros(towers):
    jm, _, _ = towers
    params = {k: np.asarray(v) for k, v in jm.params.items() if k != "item_bias"}
    tm = TwoTower.from_numpy(params, 50, 300, 16, 32, device="cpu")
    assert not tm.item_bias.any()


@pytest.fixture(scope="module")
def rankers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rankers")
    rng = np.random.default_rng(2)
    out = {}
    for qn in (False, True):
        names = [f"f{i}" for i in range(52)]
        jr = JaxRanker(feature_names=names, hidden_dims=(128, 64), query_norm=qn)
        jr.params = init_mlp(jax.random.PRNGKey(4), 52, (128, 64))
        jr.feat_mean = rng.normal(size=52).astype(np.float32)
        jr.feat_std = rng.uniform(0.5, 2.0, 52).astype(np.float32)
        jr._trained = True
        path = tmp / f"ranker_{qn}.npz"
        jr.save(str(path))
        out[qn] = (jr, load_ranker(str(path), device="cpu"), path)
    return out


@pytest.mark.parametrize("query_norm", [False, True])
def test_ranker_scores_match(rankers, query_norm):
    """Features that vary over the candidates: the port's first-row shift
    is exact arithmetic, so both formulas agree within f32 noise."""
    jr, tr, _ = rankers[query_norm]
    x = np.random.default_rng(5).normal(size=(3, 500, 52)).astype(np.float32)
    want = np.asarray(jr.make_device_scorer()(jnp.asarray(x)))
    got = tr.make_device_scorer()(torch.as_tensor(x)).numpy()
    assert got.shape == (3, 500)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_query_norm_zeroes_constant_columns(rankers):
    """A feature constant over the candidate set carries no relative
    standing; the port standardises it to exactly 0, so its value cannot
    move any score."""
    _, tr, _ = rankers[True]
    x = np.random.default_rng(6).normal(size=(500, 52)).astype(np.float32)
    x[:, :24] = x[0, :24]
    score = tr.make_device_scorer()
    a = score(torch.as_tensor(x))
    x2 = x.copy()
    x2[:, :24] = 3.7
    b = score(torch.as_tensor(x2))
    assert torch.equal(a, b)


def test_ranker_round_trip(rankers, tmp_path):
    jr, tr, path = rankers[True]
    tr.save(str(tmp_path / "r.npz"))
    back = JaxRanker.load(str(tmp_path / "r.npz"))
    assert back.feature_names == jr.feature_names and back.query_norm
    for k, v in jr.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[k]), np.asarray(v))
    assert json.loads((tmp_path / "r.npz.meta.json").read_text()) == \
        json.loads(open(str(path) + ".meta.json").read())


def test_load_ranker_serves_a_jax_gbdt(tmp_path):
    """A GBDT the JAX package trained and saved: ``load_ranker`` dispatches
    on ``n_trees`` and returns the port's booster, whose host predict is
    JAX's bit for bit."""
    from recommendit_tpu.models.gbdt import HistGBDTRanker as JaxGBDT
    from recommendit_tpu_torch.models import HistGBDTRanker
    from tests.test_ranker import FEATURES, make_ranker_data

    df = make_ranker_data(n_queries=20, group=25)
    jr = JaxGBDT(n_estimators=8, max_depth=3, n_bins=16, seed=1)
    jr.train(df, FEATURES)
    jr.save(str(tmp_path / "gbdt.npz"))
    got = load_ranker(str(tmp_path / "gbdt.npz"), device="cpu")
    assert isinstance(got, HistGBDTRanker) and got.device.type == "cpu"
    assert len(got.trees) == 8 and got.feature_names == FEATURES
    x = df[FEATURES].values.astype(np.float32)
    np.testing.assert_array_equal(got.predict(x), jr.predict(x))
    with pytest.raises(FileNotFoundError, match="meta"):
        load_ranker(str(tmp_path / "absent.npz"), device="cpu")


def _catalog(n=3000, d=16, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            np.arange(1, n + 1), (0.05 * rng.normal(size=n)).astype(np.float32),
            rng.normal(size=(40, d)).astype(np.float32))


@pytest.mark.parametrize("mode", ["exact", "fused"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_index_matches_jax(tmp_path, mode, with_bias):
    embs, ids, bias, queries = _catalog()
    ji = JaxIndex(16, block_size=1024, mode=mode)
    ji.build(embs, ids, bias=bias if with_bias else None)
    ji.save(str(tmp_path / "i.npz"))
    ti = MIPSIndex.load(str(tmp_path / "i.npz"), device="cpu")
    assert ti.n_total == 3000 and ti.has_bias == with_bias
    assert ti._embs.shape == ((3072 if mode == "fused" else 3000),
                              24 if with_bias else 16)
    jv, jid = ji.batch_search(queries, 200)
    tv, tid = ti.batch_search(queries, 200)
    jv, jid = (np.asarray(a) for a in jax_canonical(jnp.asarray(jv), jnp.asarray(jid)))
    tv, tid = (a.numpy() for a in canonical_tie_order(torch.as_tensor(tv),
                                                      torch.as_tensor(tid)))
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)


def test_approx_index_recall(tmp_path):
    embs, ids, bias, queries = _catalog(20_000, 32, seed=8)
    queries = np.random.default_rng(9).normal(size=(40, 32)).astype(np.float32)
    exact = MIPSIndex(32, mode="exact", device="cpu")
    approx = MIPSIndex(32, mode="approx", dtype="bfloat16", device="cpu")
    for idx in (exact, approx):
        idx.build(embs, ids, bias=bias)
    _, e = exact.batch_search(queries, 300)
    _, a = approx.batch_search(queries, 300)
    recall = np.mean([len(set(x) & set(y)) / 300 for x, y in zip(a.tolist(), e.tolist())])
    assert recall >= 0.95


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_npz_round_trip(tmp_path, dtype):
    embs, ids, bias, _ = _catalog()
    ti = MIPSIndex(16, block_size=1024, mode="fused", dtype=dtype, device="cpu")
    ti.build(embs, ids, bias=bias)
    ti.save(str(tmp_path / "i.npz"))
    back = JaxIndex.load(str(tmp_path / "i.npz"))
    assert back.dtype == dtype and back.mode == "fused"
    with np.load(tmp_path / "i.npz") as data:
        assert data["embeddings"].shape == (3000, 16)
        np.testing.assert_array_equal(data["item_ids"], ids)
        np.testing.assert_array_equal(data["bias"], bias)
    # the file holds normalised rows; load normalises again (as JAX does),
    # which moves f32 rows by rounding only and bf16 rows by at most 1 ulp
    again = MIPSIndex.load(str(tmp_path / "i.npz"), device="cpu")
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    torch.testing.assert_close(again._embs.float(), ti._embs.float(),
                               atol=tol, rtol=0)


def test_search_single_query(tmp_path):
    embs, ids, bias, queries = _catalog()
    ti = MIPSIndex(16, mode="exact", device="cpu")
    ti.build(embs, ids, bias=bias)
    s, i = ti.search(queries[0], 10)
    bs, bi = ti.batch_search(queries[:1], 10)
    np.testing.assert_array_equal(i, bi[0])
    assert ti._embs.shape[1] == 24


@pytest.mark.parametrize("kwargs", [dict(dtype="bfloat16", mode="verified"),
                                    dict(mode="verified")])
def test_unported_index_options_raise(kwargs):
    """The verified mode is ported: it builds and returns exact mode's
    values (its engines against JAX's: ``tests/test_torch_topk_verified.py``);
    over int8 it raises ``ValueError``, as in JAX."""
    embs, ids, bias, queries = _catalog()
    out = []
    for mode in (kwargs["mode"], "exact"):
        index = MIPSIndex(16, **{**kwargs, "mode": mode}, device="cpu")
        index.build(embs, ids, bias=bias)
        out.append(index.batch_search(queries, 20)[0])
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="int8"):
        MIPSIndex(16, mode="verified", dtype="int8", device="cpu")


def test_index_rejects_bad_shapes():
    ti = MIPSIndex(16, device="cpu")
    with pytest.raises(ValueError, match="embeddings must be"):
        ti.build(np.zeros((4, 8), np.float32), np.arange(4))
    with pytest.raises(RuntimeError, match="not built"):
        ti.batch_search(np.zeros((1, 16), np.float32))
