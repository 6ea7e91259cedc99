"""The port's synthetic generator under JAX's full signature: weight
overrides, the latent width and the generative latents.

Everything here is exact (bit-equal): the port draws the same numpy stream
in the same order, so for the same arguments the ratings, the catalog, the
users and every latent array and score statistic must be equal, not close.
Cases: 2 seeds x {no weights, a dict of overrides, a ``SynthWeights``} x
``latent_dim`` in {4, 8}, at a tiny size.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from recommendit_tpu.data import synthetic as jax_syn
from recommendit_tpu_torch.data import synthetic as syn

SIZE = dict(n_users=90, n_items=70, n_ratings=2500)
OVERRIDES = {"exposure_quality": 0.2, "latent": 1.1}
WEIGHTS = {
    "none": (None, None),
    "dict": (OVERRIDES, OVERRIDES),
    "synthweights": (jax_syn.SynthWeights(quality=0.5, noise=0.9),
                     syn.SynthWeights(quality=0.5, noise=0.9)),
}
LATENT_KEYS = ["weights", "taste", "user_latent", "user_bias", "item_latent",
               "item_genre_unit", "item_quality", "item_pop", "activity",
               "rating_edges", "score_stats"]


def _seconds(ts):
    return ts.values.astype("datetime64[s]").astype(np.int64)


def _assert_data_equal(jd, td):
    r, m, u = jd.ratings, jd.movies, jd.users
    np.testing.assert_array_equal(td.user_id, r["user_id"].values)
    np.testing.assert_array_equal(td.item_id, r["item_id"].values)
    np.testing.assert_array_equal(td.rating, r["rating"].values)
    np.testing.assert_array_equal(td.timestamp, _seconds(r["timestamp"]))
    np.testing.assert_array_equal(td.item_ids, m["item_id"].values)
    assert td.titles.tolist() == m["title"].tolist()
    assert td.genre_strs.tolist() == m["genres"].tolist()
    assert td.gender.tolist() == u["gender"].tolist()
    np.testing.assert_array_equal(td.age, u["age"].values)
    np.testing.assert_array_equal(td.occupation, u["occupation"].values)
    assert td.zip_code.tolist() == u["zip_code"].tolist()


@pytest.mark.parametrize("latent_dim", [4, 8])
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("seed", [0, 3])
def test_data_and_latents_bit_equal(seed, weights, latent_dim):
    jw, tw = WEIGHTS[weights]
    kw = dict(SIZE, seed=seed, latent_dim=latent_dim, return_latents=True)
    jd, jl = jax_syn.make_synthetic_movielens(weights=jw, **kw)
    td, tl = syn.make_synthetic_movielens(weights=tw, **kw)
    _assert_data_equal(jd, td)
    assert list(tl) == list(jl) == LATENT_KEYS
    assert dataclasses.asdict(tl["weights"]) == dataclasses.asdict(jl["weights"])
    for key in LATENT_KEYS[1:-1]:
        assert tl[key].dtype == jl[key].dtype, key
        np.testing.assert_array_equal(tl[key], jl[key], err_msg=key)
    assert list(tl["score_stats"]) == list(jl["score_stats"])
    assert tl["score_stats"] == jl["score_stats"]          # floats, exactly
    assert tl["user_latent"].shape == (SIZE["n_users"], latent_dim)


def test_signature_is_jax_s():
    """Positional order, names and defaults of JAX's signature."""
    want = inspect.signature(jax_syn.make_synthetic_movielens).parameters
    got = inspect.signature(syn.make_synthetic_movielens).parameters
    assert list(got) == list(want)
    assert [p.default for p in got.values()] == [p.default for p in want.values()]
    assert ([f.name for f in dataclasses.fields(syn.SynthWeights)]
            == [f.name for f in dataclasses.fields(jax_syn.SynthWeights)])
    assert dataclasses.asdict(syn.SynthWeights()) == dataclasses.asdict(jax_syn.SynthWeights())


def test_replace_and_dict_overrides_agree():
    w = syn.SynthWeights().replace(**OVERRIDES)
    assert isinstance(w, syn.SynthWeights) and w.latent == 1.1
    assert syn.SynthWeights().latent == 0.65           # frozen: a new object
    a = syn.make_synthetic_movielens(**SIZE, weights=OVERRIDES)
    b = syn.make_synthetic_movielens(**SIZE, weights=w)
    np.testing.assert_array_equal(a.rating, b.rating)
    np.testing.assert_array_equal(a.item_id, b.item_id)


def test_default_call_is_unchanged():
    """The default call gives the data the generator gave before it took
    weights and latents: equal to the explicit defaults and to the data
    half of ``return_latents=True``, and JAX's default data."""
    plain = syn.make_synthetic_movielens(**SIZE)
    explicit = syn.make_synthetic_movielens(**SIZE, seed=0, latent_dim=8,
                                            weights=syn.SynthWeights())
    with_latents, _ = syn.make_synthetic_movielens(**SIZE, return_latents=True)
    for other in (explicit, with_latents):
        for f in ("user_id", "item_id", "rating", "timestamp", "genres"):
            np.testing.assert_array_equal(getattr(plain, f), getattr(other, f))
    _assert_data_equal(jax_syn.make_synthetic_movielens(**SIZE), plain)
