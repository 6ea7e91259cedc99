"""The port's feature engineering (``features/engineering.py``), the
packing and assembly views of ``features/schema.py``, the ``.dat`` files of
``data/movielens.py`` and the recompute branch of the serving ``load``,
against the JAX package on the same seeded data.

Tolerance: bit-equal everywhere — values and dtypes. Every sum the port
computes runs in the JAX order (or is exact: integer ratings, 0/1/2 genre
weights), so no column needs C.22's bound.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from recommendit_tpu.data import movielens as jml
from recommendit_tpu.data.synthetic import make_synthetic_movielens as jax_synth
from recommendit_tpu.features import schema as js
from recommendit_tpu.features.engineering import FeatureEngineer as JaxFE
from recommendit_tpu.pipelines.run_pipeline import PipelineOrchestrator as JaxOrch
from recommendit_tpu.config import Settings
from recommendit_tpu_torch.data import movielens as tml
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.features import engineering, schema as ts
from recommendit_tpu_torch.features.engineering import FeatureEngineer

SIZES = [dict(n_users=300, n_items=200, n_ratings=20_000, seed=0),
         dict(n_users=150, n_items=500, n_ratings=6_000, seed=3)]


def _jax_view(jd, fraction=0.9):
    orch = JaxOrch(cfg=Settings(TRAIN_SPLIT_FRACTION=fraction),
                   data_dir="unused", models_dir="unused")
    orch._data = jd
    return orch._train_view()


@pytest.fixture(scope="module", params=SIZES, ids=["dense", "sparse"])
def built(request):
    """JAX and port features of the 0.9 train view of the same data."""
    jd = _jax_view(jax_synth(**request.param))
    td = make_synthetic_movielens(**request.param).train_view(0.9)
    jfe, tfe = JaxFE(seed=1), FeatureEngineer(seed=1)
    jfe.set_data(jd)
    tfe.set_data(td)
    jfe.build_user_features()
    jfe.build_item_features()
    tfe.build_user_features()
    tfe.build_item_features()
    return jd, td, jfe, tfe


def assert_table_equal(frame: pd.DataFrame, cols: dict, vec: str):
    assert list(frame.columns) == list(cols)
    for c in frame.columns:
        if c == vec:
            np.testing.assert_array_equal(cols[c], np.stack(frame[c].values))
            assert cols[c].dtype == np.float32
        elif c == "title":
            assert cols[c].tolist() == frame[c].fillna("").tolist()
        else:
            np.testing.assert_array_equal(cols[c], frame[c].values, err_msg=c)
            assert cols[c].dtype == frame[c].dtype, c


def assert_frames_equal(frame: pd.DataFrame, cols: dict):
    assert list(frame.columns) == list(cols)
    for c in frame.columns:
        np.testing.assert_array_equal(cols[c], frame[c].values, err_msg=c)
        assert cols[c].dtype == frame[c].dtype, c


def test_user_features_equal(built):
    _, _, jfe, tfe = built
    assert_table_equal(jfe.user_features, tfe.user_features, "genre_pref")


def test_item_features_equal(built):
    _, _, jfe, tfe = built
    assert_table_equal(jfe.item_features, tfe.item_features, "genre_vector")
    # items with a single rating: pandas' ddof-1 std is NaN, then 0.0
    one = tfe.item_features["rating_count"] == 1
    assert (tfe.item_features["rating_stddev"][one] == 0.0).all()


def test_packed_tables_equal(built):
    jd, td, jfe, tfe = built
    for n_extra in (0, 7):       # tables larger than the id range too
        np.testing.assert_array_equal(
            ts.pack_user_features(tfe.user_features, td.n_users + n_extra),
            js.pack_user_features(jfe.user_features, jd.n_users + n_extra))
        np.testing.assert_array_equal(
            ts.pack_item_features(tfe.item_features, td.n_items + n_extra),
            js.pack_item_features(jfe.item_features, jd.n_items + n_extra))


def test_group_std_is_pandas_welford():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 40, 3000)
    vals = rng.integers(1, 6, 3000)
    want = pd.Series(vals).groupby(codes).std().values
    np.testing.assert_array_equal(engineering.group_std(codes, vals, 40), want)
    # numpy's two-pass std is not pandas' in the last bit
    two_pass = np.array([np.std(vals[codes == g], ddof=1) for g in range(40)])
    assert (two_pass != want).any()


@pytest.mark.parametrize("n_negatives,seed", [(2, 0), (4, 7)])
def test_training_pairs_equal(built, n_negatives, seed):
    _, _, jfe, tfe = built
    j_train, j_test = jfe.build_training_pairs(n_negatives=n_negatives, seed=seed)
    t_train, t_test = tfe.build_training_pairs(n_negatives=n_negatives, seed=seed)
    assert_frames_equal(j_train.reset_index(drop=True), t_train)
    assert_frames_equal(j_test.reset_index(drop=True), t_test)
    assert len(np.intersect1d(t_train["query_id"], t_test["query_id"])) == 0


class _ShuffleSpy:
    """A numpy Generator that counts its ``shuffle`` calls."""

    def __init__(self, rng):
        self._rng, self.shuffles = rng, 0

    def shuffle(self, x):
        self.shuffles += 1
        return self._rng.shuffle(x)

    def __getattr__(self, name):
        return getattr(self._rng, name)


def test_negative_fallback_equal(monkeypatch):
    """A user who rated all but ten of 200 items needs all ten as
    negatives: the rejection rounds leave slots open and the exact
    fallback (a shuffled list of a set difference) fills them."""
    rng = np.random.default_rng(2)
    n_items = 200
    users = [np.full(190, 1), rng.integers(2, 30, 3000)]
    items = [rng.permutation(np.arange(1, n_items + 1))[:190],
             rng.integers(1, n_items + 1, 3000)]
    uid, iid = np.concatenate(users), np.concatenate(items)
    key = np.unique(uid * 1000 + iid, return_index=True)[1]
    uid, iid = uid[np.sort(key)], iid[np.sort(key)]
    rating = rng.integers(1, 6, len(uid))
    rating[:5] = 5
    ts = 956_000_000 + rng.integers(0, 10**7, len(uid))
    frame = pd.DataFrame({"user_id": uid, "item_id": iid, "rating": rating,
                          "timestamp": pd.to_datetime(ts, unit="s")})
    j_train, j_test = JaxFE().build_training_pairs(frame, n_negatives=4, seed=3)

    spy = {}
    real = np.random.default_rng

    def spied(seed):
        spy["rng"] = _ShuffleSpy(real(seed))
        return spy["rng"]

    arrays = tml.MovieLensData(
        user_id=uid, item_id=iid, rating=rating, timestamp=ts,
        user_ids=np.unique(uid), item_ids=np.arange(1, n_items + 1),
        genres=np.zeros((n_items, 18), np.float32),
        gender=np.full(29, "M"), age=np.ones(29, np.int64),
        occupation=np.ones(29, np.int64), zip_code=np.full(29, "00000"),
        titles=np.full(n_items, "x"), genre_strs=np.full(n_items, ""))
    fe = FeatureEngineer()
    fe.set_data(arrays)
    with monkeypatch.context() as mp:
        mp.setattr(np.random, "default_rng", spied)
        t_train, t_test = fe.build_training_pairs(n_negatives=4, seed=3)
    assert spy["rng"].shuffles >= 2          # the fallback, then the query split
    assert_frames_equal(j_train.reset_index(drop=True), t_train)
    assert_frames_equal(j_test.reset_index(drop=True), t_test)
    negs = np.concatenate([t_train["item_id"][(t_train["user_id"] == 1)
                                              & (t_train["label"] == 0)],
                           t_test["item_id"][(t_test["user_id"] == 1)
                                             & (t_test["label"] == 0)]])
    assert sorted(negs.tolist()) == sorted(set(range(1, n_items + 1))
                                           - set(iid[uid == 1].tolist()))


def _drop_some(jfe, tfe):
    """Feature tables without every seventh user and item (left-join
    misses), on both sides."""
    ju, ji = jfe.user_features, jfe.item_features
    keep_u = (ju["user_id"].values % 7) != 0
    keep_i = (ji["item_id"].values % 7) != 0
    tu = {c: a[keep_u] for c, a in tfe.user_features.items()}
    ti = {c: a[keep_i] for c, a in tfe.item_features.items()}
    return (ju[keep_u].reset_index(drop=True), ji[keep_i].reset_index(drop=True),
            tu, ti)


@pytest.mark.parametrize("missing", [False, True], ids=["all_known", "left_join_misses"])
def test_assemble_frame_equal(built, missing):
    _, _, jfe, tfe = built
    j_pairs, _ = jfe.build_training_pairs(n_negatives=2, seed=0)
    t_pairs, _ = tfe.build_training_pairs(n_negatives=2, seed=0)
    j_sample = j_pairs.sample(n=min(1500, len(j_pairs)), random_state=0)
    take = np.random.RandomState(0).permutation(len(t_pairs["label"]))[:len(j_sample)]
    t_sample = {c: a[take] for c, a in t_pairs.items()}
    np.testing.assert_array_equal(t_sample["user_id"], j_sample["user_id"].values)
    ju, ji, tu, ti = ((jfe.user_features, jfe.item_features,
                       tfe.user_features, tfe.item_features)
                      if not missing else _drop_some(jfe, tfe))
    want = js.assemble_frame(j_sample, ju, ji)
    got = ts.assemble_frame(t_sample, tu, ti)
    assert_frames_equal(want, got)
    mat = np.stack([got[c] for c in ts.FEATURE_COLUMNS], axis=1)
    np.testing.assert_array_equal(mat, want[js.FEATURE_COLUMNS].values)


def test_assemble_online_and_packed_equal(built):
    _, _, jfe, tfe = built
    rng = np.random.default_rng(4)
    uf = {c: float(v) for c, v in zip(ts.USER_SCALAR_COLS, rng.normal(size=6))}
    uf["genre_pref"] = rng.normal(size=18).astype(np.float32)
    partial = {"avg_rating": 4.25}
    items = {1: {"avg_rating": 3.0, "genre_vector": np.eye(18)[3]},
             2: None, 5: {"popularity_score": 0.5, "year_normalized": 0.25}}
    cands = [1, 2, 5, 9]
    for user in (uf, partial, None):
        want = js.assemble_online(user, items, cands)
        got = ts.assemble_online(user, items, cands)
        assert_frames_equal(want, got)
    np.testing.assert_array_equal(ts.user_dict_to_packed(uf), js.user_dict_to_packed(uf))
    np.testing.assert_array_equal(ts.item_dict_to_packed(items[5]),
                                  js.item_dict_to_packed(items[5]))
    table = ts.pack_item_features(tfe.item_features, 40)
    u_vec = ts.pack_user_features(tfe.user_features, 40)[3]
    np.testing.assert_array_equal(ts.assemble_packed_np(u_vec, table[[1, 4, 9]]),
                                  js.assemble_packed_np(u_vec, table[[1, 4, 9]]))
    assert (ts.USER_DEFAULTS, ts.ITEM_DEFAULTS, ts.GENRE_TO_IDX) == (
        js.USER_DEFAULTS, js.ITEM_DEFAULTS, js.GENRE_TO_IDX)


def test_genre_encoding_unknown_and_empty():
    strs = ["Action|Comedy", "Action|NotAGenre", "", "Western", "Sci-Fi|Film-Noir|War",
            "Comedy|Comedy", "children's", "Children's"]
    want = js.encode_genres_matrix(strs)
    got = ts.encode_genres_matrix(strs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and not got[2].any() and got[1].sum() == 1
    for s in strs:
        np.testing.assert_array_equal(ts.encode_genres(s), js.encode_genres(s))


def test_title_without_a_year():
    kw = dict(n_users=80, n_items=60, n_ratings=2000, seed=4)
    jd, td = jax_synth(**kw), make_synthetic_movielens(**kw)
    odd = ["No Year Here", "Bad (19x5)", "Trailing (1999) ", "Two (1950) (2001)"]
    for k, t in enumerate(odd):
        jd.movies.loc[k, "title"] = t
        td.titles[k] = t
    jfe, tfe = JaxFE(), FeatureEngineer()
    jfe.set_data(jd)
    tfe.set_data(td)
    assert_table_equal(jfe.build_item_features(), tfe.build_item_features(),
                       "genre_vector")
    rows = np.searchsorted(tfe.item_features["item_id"], [1, 2, 3])
    assert (tfe.item_features["year_normalized"][rows] == np.float32(0.5)).all()


def _assert_data_equal(td, jd):
    """A port container equals a JAX one (timestamps in seconds)."""
    r, u, m = jd.ratings, jd.users, jd.movies
    np.testing.assert_array_equal(td.user_id, r["user_id"].values)
    np.testing.assert_array_equal(td.item_id, r["item_id"].values)
    np.testing.assert_array_equal(td.rating, r["rating"].values)
    np.testing.assert_array_equal(
        td.timestamp, r["timestamp"].values.astype("datetime64[s]").astype(np.int64))
    np.testing.assert_array_equal(td.user_ids, u["user_id"].values)
    assert td.gender.tolist() == u["gender"].tolist()
    np.testing.assert_array_equal(td.age, u["age"].values)
    np.testing.assert_array_equal(td.occupation, u["occupation"].values)
    assert td.zip_code.tolist() == u["zip_code"].tolist()
    np.testing.assert_array_equal(td.item_ids, m["item_id"].values)
    assert td.titles.tolist() == m["title"].tolist()
    assert td.genre_strs.tolist() == m["genres"].tolist()
    np.testing.assert_array_equal(td.genres, js.encode_genres_matrix(m["genres"].values))
    for a in (td.user_id, td.item_id, td.rating, td.timestamp, td.user_ids,
              td.age, td.occupation, td.item_ids):
        assert a.dtype == np.int64


def test_dat_files_jax_to_port(tmp_path):
    """The JAX writer's files, read by the port: the ratings in file order."""
    jd = jax_synth(n_users=90, n_items=70, n_ratings=3000, seed=6)
    # a shuffled ratings table, so file order is not time order
    jd.ratings = jd.ratings.sample(frac=1.0, random_state=1).reset_index(drop=True)
    jd.movies.loc[3, "title"] = "Amélie (2001)"          # latin-1
    jml.save_movielens(jd, str(tmp_path))
    assert tml.verify_dataset(tmp_path) and not tml.verify_dataset(tmp_path / "x")
    got = tml.load_movielens(str(tmp_path))
    _assert_data_equal(got, jml.load_movielens(str(tmp_path)))
    _assert_data_equal(got, jd)


def test_dat_files_port_to_jax(tmp_path):
    td = make_synthetic_movielens(n_users=90, n_items=70, n_ratings=3000, seed=6)
    td.titles[5] = "Café (1990)"
    tml.save_movielens(td, str(tmp_path))
    _assert_data_equal(td, jml.load_movielens(str(tmp_path)))
    again = tml.load_movielens(str(tmp_path))
    for f in ("user_id", "item_id", "rating", "timestamp", "age", "titles",
              "genre_strs", "gender", "zip_code", "genres"):
        np.testing.assert_array_equal(getattr(again, f), getattr(td, f))
    assert (tmp_path / "README").exists()


def test_dat_reader_rejects_a_bad_line(tmp_path):
    td = make_synthetic_movielens(n_users=20, n_items=10, n_ratings=100, seed=0)
    tml.save_movielens(td, str(tmp_path))
    with open(tmp_path / "ratings.dat", "a") as f:
        f.write("1::2::3\n")
    with pytest.raises(ValueError, match="four"):
        tml.load_movielens(str(tmp_path))


def test_save_and_load_features_round_trip(built, tmp_path):
    _, td, _, tfe = built
    tfe.save_features(str(tmp_path))
    again = FeatureEngineer()
    again.load_features(str(tmp_path))
    for table, got, vec in ((tfe.user_features, again.user_features, "genre_pref"),
                            (tfe.item_features, again.item_features, "genre_vector")):
        # the genre matrix comes back last, as the JAX load_features puts it
        assert list(got) == [c for c in table if c != vec] + [vec]
        for c in table:
            np.testing.assert_array_equal(got[c], table[c])
            assert got[c].dtype == table[c].dtype
    with np.load(tmp_path / "user_features.npz") as z:
        assert "genre_pref_17" in z.files and "genre_pref" not in z.files
    with np.load(tmp_path / "item_features.npz") as z:
        assert "genre_vec_0" in z.files
    np.testing.assert_array_equal(
        np.load(tmp_path / "user_packed.npy"),
        ts.pack_user_features(tfe.user_features, td.n_users))


# --- the recompute branch of RecommendationPipeline.load ---------------------- #

N_U, N_I = 120, 90


@pytest.fixture(scope="module")
def serve_files(tmp_path_factory):
    """A small random two-tower, exact index and ranker, and the data."""
    from recommendit_tpu_torch.models import LambdaRankScorer, MIPSIndex, TwoTower
    from recommendit_tpu_torch.models.two_tower import init_params

    tmp = tmp_path_factory.mktemp("recompute")
    params = init_params(torch.Generator().manual_seed(0), N_U, N_I, 8, 8, device="cpu")
    model = TwoTower.from_numpy({k: v.numpy() for k, v in params.items()},
                                N_U, N_I, 8, 8, device="cpu")
    model.save(str(tmp / "tt.npz"))
    index = MIPSIndex(8, device="cpu")
    item_ids = np.arange(1, N_I + 1)
    index.build(model.get_item_embeddings(item_ids, np.zeros((N_I, 18), np.float32)),
                item_ids)
    index.save(str(tmp / "index.npz"))
    names = ts.FEATURE_COLUMNS
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=(4,), device="cpu")
    ranker.params = {"w0": torch.zeros(len(names), 4), "b0": torch.zeros(4),
                     "w1": torch.zeros(4, 1), "b1": torch.zeros(1)}
    ranker.feat_mean = np.zeros(len(names), np.float32)
    ranker.feat_std = np.ones(len(names), np.float32)
    ranker.save(str(tmp / "ranker.npz"))
    kw = dict(n_users=N_U, n_items=N_I, n_ratings=4000, seed=8)
    return tmp, make_synthetic_movielens(**kw), jax_synth(**kw)


def _pipeline(tmp, features_dir):
    from recommendit_tpu_torch.config import Settings as TorchSettings
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    return RecommendationPipeline(
        model_path=str(tmp / "tt.npz"), index_path=str(tmp / "index.npz"),
        ranker_path=str(tmp / "ranker.npz"), features_dir=features_dir,
        cfg=TorchSettings(STAGE_RECAL_EVERY=0), device="cpu")


def _jax_tables(jd):
    jfe = JaxFE()
    jfe.set_data(jd)
    return (js.pack_user_features(jfe.build_user_features(), jd.n_users),
            js.pack_item_features(jfe.build_item_features(), jd.n_items))


@pytest.mark.parametrize("features_dir", [False, True], ids=["no_dir", "empty_dir"])
def test_load_recomputes_the_packed_tables(serve_files, features_dir):
    tmp, td, jd = serve_files
    fdir = tmp / f"feats_{features_dir}"
    p = _pipeline(tmp, str(fdir) if features_dir else None)
    p.load(td)
    want_u, want_i = _jax_tables(jd)
    np.testing.assert_array_equal(p._user_packed.numpy(), want_u)
    np.testing.assert_array_equal(p._item_packed.numpy(), ts.pad_packed_width(want_i))
    if features_dir:      # the snapshots were written for the next load
        np.testing.assert_array_equal(np.load(fdir / "user_packed.npy"), want_u)
        np.testing.assert_array_equal(np.load(fdir / "item_packed.npy"), want_i)
    else:
        assert not fdir.exists()


def test_load_uses_a_fresh_snapshot_and_not_a_stale_one(serve_files):
    import os

    tmp, td, jd = serve_files
    fdir = tmp / "feats_stale"
    fe = FeatureEngineer()
    fe.set_data(td)
    fe.build_user_features()
    fe.build_item_features()
    fe.save_features(str(fdir))
    marked = np.load(fdir / "user_packed.npy")
    marked[1, 0] = 123.0                      # a mark only the snapshot has
    np.save(fdir / "user_packed.npy", marked)
    p = _pipeline(tmp, str(fdir))
    p.load(td)
    assert p._user_packed[1, 0].item() == 123.0
    # the features file newer than the snapshot: recomputed from the tables
    t = os.stat(fdir / "user_packed.npy").st_mtime
    os.utime(fdir / "user_features.npz", (t + 10, t + 10))
    p = _pipeline(tmp, str(fdir))
    p.load(td)
    want_u, _ = _jax_tables(jd)
    np.testing.assert_array_equal(p._user_packed.numpy(), want_u)
    np.testing.assert_array_equal(np.load(fdir / "user_packed.npy"), want_u)


def test_load_from_serve_data_needs_a_snapshot(serve_files):
    from recommendit_tpu_torch.serving.recommender import ServeData

    tmp, td, _ = serve_files
    p = _pipeline(tmp, str(tmp / "nothing_here"))
    with pytest.raises(ValueError, match="MovieLensData"):
        p.load(ServeData(user_id=td.user_id, item_id=td.item_id))
