"""Synthetic MovieLens-format data — numpy only.

Counterpart of ``recommendit_tpu/data/synthetic.py::make_synthetic_movielens``:
the same rating model (bilinear latent taste, genre taste from demographic
groups, item quality, a genre-loyalty bonus, popularity-and-taste exposure,
ML-1M marginals) drawn from the same numpy stream in the same order, so one
seed gives the same ratings. It returns arrays (:class:`MovieLensData`)
instead of DataFrames: the ratings, the users table with its demographics
and zip codes, the catalog with its titles (``Synthetic Movie <id>
(<year>)``), genre strings and genre matrix. ``weights`` overrides the
rating model's weights and ``return_latents=True`` also returns the
generative internals, as in JAX. ``tests/test_torch_data.py`` and
``tests/test_torch_synthetic.py`` hold it to the JAX generator value for
value.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from recommendit_tpu_torch.data.movielens import MovieLensData, timestamp_order
from recommendit_tpu_torch.features.schema import GENRES

_OCCUPATIONS = 21
_AGES = np.array([1, 18, 25, 35, 45, 50, 56])

# Empirical ML-1M rating marginal (public dataset fact): shares of
# ratings 1..5. Relevance = rating >= 4 covers ~57.5% of interactions.
_ML1M_RATING_DIST = np.array([0.0561, 0.1075, 0.2611, 0.3489, 0.2264])
_T0 = 956_000_000  # ~2000-04, the ML-1M era


@dataclasses.dataclass(frozen=True)
class SynthWeights:
    """Rating-model weights (z-scored components), the JAX defaults
    (``recommendit_tpu.data.synthetic.SynthWeights``)."""

    latent: float = 0.65
    genre: float = 0.75
    quality: float = 1.10
    loyalty: float = 1.00
    loyalty_tau: float = 0.85
    user_bias: float = 0.40
    noise: float = 0.60
    exposure_gamma: float = 3.0
    exposure_latent: float = 2.2
    exposure_quality: float = 0.15

    def replace(self, **kw) -> "SynthWeights":
        return dataclasses.replace(self, **kw)


def make_synthetic_movielens(
    n_users: int = 600,
    n_items: int = 400,
    n_ratings: int = 40_000,
    seed: int = 0,
    latent_dim: int = 8,
    return_latents: bool = False,
    weights: "SynthWeights | dict | None" = None,
):
    """A MovieLens-format data set; ``n_ratings`` is an upper bound, since
    repeated (user, item) pairs are dropped. Ratings come sorted by
    timestamp as ``DataFrame.sort_values`` sorts them.

    ``weights`` overrides the rating model's weights (a
    :class:`SynthWeights` or a dict of its field overrides).
    ``return_latents=True`` returns ``(data, latents)``: the generative
    internals (tastes, latents, quality, popularity, activity, rating edges
    and the score statistics) that oracle-ceiling diagnostics such as
    ``scripts/ranker_headroom.py`` rebuild the true hit probability from."""
    if weights is None:
        w = SynthWeights()
    elif isinstance(weights, dict):
        w = SynthWeights().replace(**weights)
    else:
        w = weights
    rng = np.random.default_rng(seed)
    n_genres = len(GENRES)

    # items: 1-3 genres with co-occurrence structure, zipf popularity,
    # a release year and an intrinsic quality
    item_ids = np.arange(1, n_items + 1)
    genre_latent = rng.normal(size=(n_genres, latent_dim))
    genre_sim = genre_latent @ genre_latent.T
    np.fill_diagonal(genre_sim, -np.inf)
    item_n_genres = rng.integers(1, 4, size=n_items)
    first_genre = rng.integers(0, n_genres, size=n_items)
    item_genre_sets = []
    for k, g0 in zip(item_n_genres, first_genre):
        gs = [int(g0)]
        while len(gs) < k:
            logits = genre_sim[gs[-1]].copy()
            logits[gs] = -np.inf
            p = np.exp(logits - logits.max())
            p /= p.sum()
            gs.append(int(rng.choice(n_genres, p=p)))
        item_genre_sets.append(np.array(sorted(gs)))
    item_genre_mat = np.zeros((n_items, n_genres))
    for i, gs in enumerate(item_genre_sets):
        item_genre_mat[i, gs] = 1.0
    item_genre_unit = item_genre_mat / np.sqrt(
        item_genre_mat.sum(axis=1, keepdims=True))

    item_latent = item_genre_unit @ genre_latent + 0.3 * rng.normal(
        size=(n_items, latent_dim))
    item_quality = rng.normal(size=n_items)
    item_pop = rng.zipf(1.4, size=n_items).astype(np.float64)
    item_pop = np.log1p(item_pop)
    item_pop /= item_pop.max()
    years = rng.integers(1940, 2001, size=n_items)
    titles = np.array([f"Synthetic Movie {i} ({y})"
                       for i, y in zip(item_ids.tolist(), years.tolist())])
    genre_strs = np.array(["|".join(GENRES[g] for g in gs)
                           for gs in item_genre_sets])

    # users: demographic-group genre tastes + individual taste
    user_ids = np.arange(1, n_users + 1)
    genders = rng.choice(["M", "F"], size=n_users, p=[0.7, 0.3])
    ages = rng.choice(_AGES, size=n_users)
    occs = rng.integers(0, _OCCUPATIONS, size=n_users)
    g_gender = rng.normal(size=(2, n_genres))
    g_age = rng.normal(size=(len(_AGES), n_genres))
    g_occ = rng.normal(size=(_OCCUPATIONS, n_genres))
    gender_idx = (genders == "F").astype(np.int64)
    age_idx = np.searchsorted(_AGES, ages)
    taste = (
        0.6 * g_gender[gender_idx]
        + 0.6 * g_age[age_idx]
        + 0.6 * g_occ[occs]
        + 1.0 * rng.normal(size=(n_users, n_genres))
    )
    taste /= np.linalg.norm(taste, axis=1, keepdims=True) + 1e-9
    user_latent = rng.normal(size=(n_users, latent_dim))
    user_bias = rng.normal(size=n_users)
    zip_codes = np.array([f"{z:05d}" for z in
                          rng.integers(0, 99999, size=n_users).tolist()])

    # interactions: long-tail activity per user; items sampled by
    # popularity tilted toward each user's taste (exposure)
    activity = rng.lognormal(mean=0.0, sigma=0.9, size=n_users)
    activity = np.maximum(activity, 0.05)
    activity /= activity.sum()
    p_item = item_pop / item_pop.sum()

    want = n_ratings
    u_parts, i_parts = [], []
    for _ in range(6):  # rejection rounds until enough unique accepted pairs
        m = int(want * 2.2) + 1024
        u_idx = rng.choice(n_users, size=m, p=activity)
        i_idx = rng.choice(n_items, size=m, p=p_item)
        match = np.einsum("ng,ng->n", taste[u_idx], item_genre_unit[i_idx])
        lmatch = np.einsum("nd,nd->n", user_latent[u_idx], item_latent[i_idx])
        tilt = (
            w.exposure_gamma * match / (np.std(match) + 1e-9)
            + w.exposure_latent * lmatch / (np.std(lmatch) + 1e-9)
            + w.exposure_quality * item_quality[i_idx]
        )
        accept = rng.random(m) < 1.0 / (1.0 + np.exp(-tilt))
        u_parts.append(u_idx[accept])
        i_parts.append(i_idx[accept])
        got = sum(p.size for p in u_parts)
        if got >= n_ratings * 1.45:
            break
        want = n_ratings * 1.45 - got
    u_idx = np.concatenate(u_parts)
    i_idx = np.concatenate(i_parts)
    pair_key = u_idx.astype(np.int64) * n_items + i_idx
    _, first = np.unique(pair_key, return_index=True)
    keep = np.sort(first)[:n_ratings]
    u_idx, i_idx = u_idx[keep], i_idx[keep]

    # relevance: latent + genre + quality + loyalty + bias + noise
    def _z(x):
        return (x - np.mean(x)) / (np.std(x) + 1e-9)

    latent_term = _z(np.einsum("nd,nd->n", user_latent[u_idx], item_latent[i_idx]))
    genre_term = _z(np.einsum("ng,ng->n", taste[u_idx], item_genre_unit[i_idx]))
    score = (
        w.latent * latent_term
        + w.genre * genre_term
        + w.quality * item_quality[i_idx]
        + w.loyalty * (genre_term > w.loyalty_tau)
        + w.user_bias * user_bias[u_idx]
        + w.noise * rng.normal(size=u_idx.size)
    )

    # quantile-map the scores onto the ML-1M rating marginal
    edges = np.quantile(score, np.cumsum(_ML1M_RATING_DIST)[:-1])
    rating = (1 + np.searchsorted(edges, score, side="left")).astype(np.int64)
    timestamps = _T0 + rng.integers(0, 3 * 365 * 86400, size=u_idx.size)

    order = timestamp_order(timestamps)
    data = MovieLensData(
        user_id=user_ids[u_idx][order], item_id=item_ids[i_idx][order],
        rating=rating[order], timestamp=timestamps[order].astype(np.int64),
        user_ids=user_ids, item_ids=item_ids,
        genres=item_genre_mat.astype(np.float32),
        gender=genders, age=ages.astype(np.int64), occupation=occs.astype(np.int64),
        zip_code=zip_codes, titles=titles, genre_strs=genre_strs)
    if not return_latents:
        return data
    latent_raw = np.einsum("nd,nd->n", user_latent[u_idx], item_latent[i_idx])
    genre_raw = np.einsum("ng,ng->n", taste[u_idx], item_genre_unit[i_idx])
    return data, {
        "weights": w,
        "taste": taste,
        "user_latent": user_latent,
        "user_bias": user_bias,
        "item_latent": item_latent,
        "item_genre_unit": item_genre_unit,
        "item_quality": item_quality,
        "item_pop": item_pop,
        "activity": activity,
        "rating_edges": edges,
        "score_stats": {
            "latent_mu": float(np.mean(latent_raw)),
            "latent_sd": float(np.std(latent_raw)),
            "genre_mu": float(np.mean(genre_raw)),
            "genre_sd": float(np.std(genre_raw)),
            "match_sd_exposure": float(np.std(genre_raw)),
        },
    }
