"""The port's synthetic generator and temporal view against the JAX ones.

Everything here is exact: the port draws the same numpy stream, so ids,
ratings, timestamps (and their order, ties included) and the genre matrix
must be equal, not close.
"""
import numpy as np
import pytest

from recommendit_tpu.config import Settings
from recommendit_tpu.data.synthetic import make_synthetic_movielens as jax_synth
from recommendit_tpu.features.schema import GENRES as JAX_GENRES
from recommendit_tpu.features.schema import encode_genres_matrix
from recommendit_tpu.pipelines.run_pipeline import PipelineOrchestrator
from recommendit_tpu_torch.data.movielens import timestamp_order
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.features.schema import GENRES, N_GENRES

# the second size has ~60 tied timestamps, so the sort order of ties counts
SIZES = [dict(n_users=120, n_items=90, n_ratings=4000, seed=1),
         dict(n_users=600, n_items=400, n_ratings=200_000, seed=0)]


@pytest.fixture(scope="module", params=SIZES, ids=["small", "ties"])
def pair(request):
    return jax_synth(**request.param), make_synthetic_movielens(**request.param)


def _seconds(ts):
    return ts.values.astype("datetime64[s]").astype(np.int64)


def test_ratings_equal(pair):
    jd, td = pair
    r = jd.ratings
    np.testing.assert_array_equal(td.user_id, r["user_id"].values)
    np.testing.assert_array_equal(td.item_id, r["item_id"].values)
    np.testing.assert_array_equal(td.rating, r["rating"].values)
    np.testing.assert_array_equal(td.timestamp, _seconds(r["timestamp"]))
    assert td.timestamp.dtype == np.int64 and td.rating.dtype == np.int64


def test_catalog_and_sizes_equal(pair):
    jd, td = pair
    np.testing.assert_array_equal(td.item_ids, jd.movies["item_id"].values)
    np.testing.assert_array_equal(td.user_ids, jd.users["user_id"].values)
    np.testing.assert_array_equal(
        td.genres, encode_genres_matrix(jd.movies["genres"].values))
    assert td.genres.dtype == np.float32
    assert (td.n_users, td.n_items) == (jd.n_users, jd.n_items)


def test_titles_genre_strings_and_demographics_equal(pair):
    jd, td = pair
    m, u = jd.movies, jd.users
    assert td.titles.tolist() == m["title"].tolist()
    assert td.genre_strs.tolist() == m["genres"].tolist()
    assert td.gender.tolist() == u["gender"].tolist()
    np.testing.assert_array_equal(td.age, u["age"].values)
    np.testing.assert_array_equal(td.occupation, u["occupation"].values)
    assert td.zip_code.tolist() == u["zip_code"].tolist()
    assert td.age.dtype == td.occupation.dtype == np.int64


@pytest.mark.parametrize("fraction", [0.9, 0.5, 1.0])
def test_train_view_equals_the_pipeline_view(pair, fraction, tmp_path):
    jd, td = pair
    runner = PipelineOrchestrator(cfg=Settings(TRAIN_SPLIT_FRACTION=fraction),
                                  data_dir=str(tmp_path),
                                  models_dir=str(tmp_path / "models"))
    runner._data = jd
    want = runner._train_view().ratings
    got = td.train_view(fraction)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.user_id, want["user_id"].values)
    np.testing.assert_array_equal(got.item_id, want["item_id"].values)
    np.testing.assert_array_equal(got.rating, want["rating"].values)
    np.testing.assert_array_equal(got.timestamp, _seconds(want["timestamp"]))
    assert got.item_ids is td.item_ids and got.genres is td.genres
    assert got.titles is td.titles and got.gender is td.gender


def test_timestamp_order_is_the_pandas_order():
    """pandas' unstable sort of a datetime column moves ties even in
    sorted input; an int64 argsort moves them differently."""
    import pandas as pd

    ts = np.random.default_rng(0).integers(0, 500, 5000)
    want = pd.DataFrame({"t": pd.to_datetime(ts, unit="s")}).sort_values("t").index
    np.testing.assert_array_equal(timestamp_order(ts), want.values)
    again = pd.DataFrame({"t": pd.to_datetime(ts[want], unit="s")}).sort_values("t")
    np.testing.assert_array_equal(timestamp_order(ts[want]), again.index.values)


def test_genres_copy_is_pinned():
    assert GENRES == JAX_GENRES and N_GENRES == len(JAX_GENRES) == 18
