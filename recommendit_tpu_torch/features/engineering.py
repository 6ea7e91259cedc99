"""Offline feature engineering — numpy, no pandas.

Counterpart of ``recommendit_tpu/features/engineering.py``: user features,
item features, training pairs and their interaction features, computed
from a :class:`~recommendit_tpu_torch.data.movielens.MovieLensData`. The
JAX module's DataFrames are column dicts of numpy arrays here (see
``features/schema.py``), and every column equals the JAX one bit for bit
(``tests/test_torch_features.py``). Where pandas fixes a result, the port
repeats what pandas computes:

* a group is a sorted unique key (``groupby``); a mean is the group's sum
  over its count, both exact for integer ratings;
* the item ``rating_stddev`` is pandas' ``std`` — ddof 1, by Welford's
  update in row order (:func:`group_std`) — so an item with one rating
  reads NaN and then 0.0;
* ``Series.unique()`` keeps first-appearance order, ``sort_values`` over
  two columns is a stable lexsort, ``duplicated(keep="first")`` marks all
  but the first occurrence, and ``astype("category").cat.codes`` takes the
  smallest integer type that holds the codes;
* the exact negative fallback shuffles a list made from Python sets built
  as the JAX module builds them, so their iteration order is the same.

Persistence is the port's own format: ``save_features`` writes
``user_features.npz`` and ``item_features.npz`` (the flattened columns,
with JAX's names ``genre_pref_<i>`` and ``genre_vec_<i>``) and the packed
``user_packed.npy`` / ``item_packed.npy`` snapshots the serve path loads.
The JAX package writes parquet, which needs pyarrow; the GPU machine has
neither pyarrow nor pandas, so neither package reads the other's feature
files (the model files are shared).
"""
from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from recommendit_tpu_torch.data.movielens import MovieLensData, load_movielens
from recommendit_tpu_torch.features import schema
from recommendit_tpu_torch.features.schema import (
    N_GENRES,
    Columns,
    left_join_rows,
    left_join_take,
    pack_item_features,
    pack_user_features,
)

logger = logging.getLogger(__name__)

USER_FILE, ITEM_FILE = "user_features.npz", "item_features.npz"
USER_SNAPSHOT, ITEM_SNAPSHOT = "user_packed.npy", "item_packed.npy"
_YEAR = re.compile(r"\((\d{4})\)$")
TEST_RATIO = 0.1       # the training pairs' share of test queries


def group_std(codes: np.ndarray, values: np.ndarray, n_groups: int) -> np.ndarray:
    """Per-group sample standard deviation (ddof 1) by Welford's update over
    each group's values in row order, as pandas' ``groupby().std()`` computes
    it: mean += (x − mean)/n, m2 += (x − mean_new)(x − mean_old), then
    sqrt(m2 / (n − 1)); NaN for a group of one. Step k updates every group's
    k-th value at once."""
    codes = np.asarray(codes, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)
    counts = np.bincount(codes, minlength=n_groups)
    grouped = np.argsort(codes, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(len(codes), np.int64)
    rank[grouped] = np.arange(len(codes)) - starts[codes[grouped]]
    by_rank = np.lexsort((codes, rank))
    bounds = np.searchsorted(rank[by_rank], np.arange(counts.max(initial=0) + 1))
    mean = np.zeros(n_groups)
    m2 = np.zeros(n_groups)
    nobs = np.zeros(n_groups, np.int64)
    for k in range(len(bounds) - 1):
        rows = by_rank[bounds[k]:bounds[k + 1]]
        g, x = codes[rows], values[rows]
        nobs[g] += 1
        old = mean[g]
        mean[g] = old + (x - old) / nobs[g]
        m2[g] += (x - mean[g]) * (x - old)
    out = np.full(n_groups, np.nan)
    many = nobs > 1
    out[many] = np.sqrt(m2[many] / (nobs[many] - 1))
    return out


def unique_in_order(a: np.ndarray) -> np.ndarray:
    """``Series.unique()``: the distinct values in first-appearance order."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def duplicated(a: np.ndarray) -> np.ndarray:
    """``Series.duplicated(keep="first")``: every occurrence but the first."""
    _, first = np.unique(a, return_index=True)
    dup = np.ones(len(a), dtype=bool)
    dup[first] = False
    return dup


def category_codes(a: np.ndarray) -> np.ndarray:
    """``astype("category").cat.codes``: the index of each value among the
    sorted distinct values, in the smallest signed type pandas picks."""
    uniq, codes = np.unique(a, return_inverse=True)
    for dtype in (np.int8, np.int16, np.int32):
        if len(uniq) < np.iinfo(dtype).max:
            return codes.astype(dtype)
    return codes.astype(np.int64)


class FeatureEngineer:
    """Builds user / item / interaction features for the two-stage pipeline."""

    def __init__(self, data_dir: str = "data/ml-1m", seed: int = 0):
        self.data_dir = Path(data_dir)
        self.seed = seed
        self.data: Optional[MovieLensData] = None
        self.user_features: Optional[Columns] = None
        self.item_features: Optional[Columns] = None

    def load_data(self) -> None:
        """The MovieLens ``.dat`` files in ``data_dir``."""
        self.set_data(load_movielens(str(self.data_dir)))

    def set_data(self, data: MovieLensData) -> None:
        """Use in-memory tables (synthetic data, a train view, tests)."""
        self.data = data

    # --- user features ------------------------------------------------------ #

    def build_user_features(self) -> Columns:
        """Per user with ratings, by user id: ``avg_rating`` (f64),
        ``rating_count``, ``recency_score`` (last rating's place in the range
        of last ratings), ``log_rating_count``, the demographics and
        ``genre_pref``: the L2-normalised mean over liked items (rating ≥ 4)
        of genre vector × (rating − 3)."""
        logger.info("Building user features...")
        d = self.data
        uids, inv = np.unique(d.user_id, return_inverse=True)
        count = np.bincount(inv, minlength=len(uids))
        avg = np.bincount(inv, weights=d.rating.astype(np.float64),
                          minlength=len(uids)) / count
        last = np.full(len(uids), np.iinfo(np.int64).min)
        np.maximum.at(last, inv, d.timestamp.astype(np.int64))
        ts_range = float(last.max() - last.min()) if len(last) else 0.0
        if ts_range > 0:
            recency = ((last - last.min()).astype(np.float64) / ts_range
                       ).astype(np.float32)
        else:
            recency = np.full(len(uids), 1.0, np.float32)

        # genre preference: the liked items' weighted genre vectors summed
        # per user (exact: the terms are 0, 1 or 2)
        rows = left_join_rows(d.item_ids, d.item_id)
        liked = (d.rating >= 4) & (rows >= 0)
        weights = (d.rating[liked] - 3).astype(np.float32)
        weighted = d.genres[rows[liked]] * weights[:, None]
        l_uids, l_inv = np.unique(d.user_id[liked], return_inverse=True)
        sums = np.zeros((len(l_uids), N_GENRES), dtype=np.float64)
        np.add.at(sums, l_inv, weighted)
        l_counts = np.bincount(l_inv, minlength=len(l_uids)).astype(np.float64)
        means = sums / l_counts[:, None]
        norms = np.linalg.norm(means, axis=1, keepdims=True)
        prefs = np.where(norms > 0, means / np.where(norms == 0, 1, norms), means)
        pref_rows = left_join_rows(l_uids, uids)
        genre_pref = left_join_take(prefs.astype(np.float32), pref_rows, 0.0)

        demo_rows = left_join_rows(d.user_ids, uids)
        gender = (d.gender == "F").astype(np.float32)
        age = (d.age / d.age.max()).astype(np.float32)
        occ = (d.occupation / max(d.occupation.max(), 1)).astype(np.float32)
        uf = {
            "user_id": uids.astype(np.int64), "avg_rating": avg,
            "rating_count": count.astype(np.int64), "recency_score": recency,
            "log_rating_count": np.log1p(count).astype(np.float32),
            "gender_encoded": left_join_take(gender, demo_rows, 0.0),
            "age_normalized": left_join_take(age, demo_rows, 0.0),
            "occupation_normalized": left_join_take(occ, demo_rows, 0.0),
            "genre_pref": genre_pref,
        }
        self.user_features = uf
        logger.info("Built user features for %d users", len(uids))
        return uf

    # --- item features ------------------------------------------------------ #

    def build_item_features(self) -> Columns:
        """Per item with ratings, by item id: ``avg_rating`` (f64),
        ``rating_count``, ``rating_stddev`` (ddof 1, 0.0 for one rating),
        ``log_rating_count``, ``popularity_score`` (log count over the
        largest), ``title``, ``genre_vector`` and ``year_normalized`` (the
        title's ``(YYYY)`` in the catalog's year range; 0.5 without one)."""
        logger.info("Building item features...")
        d = self.data
        iids, inv = np.unique(d.item_id, return_inverse=True)
        count = np.bincount(inv, minlength=len(iids))
        avg = np.bincount(inv, weights=d.rating.astype(np.float64),
                          minlength=len(iids)) / count
        std = np.nan_to_num(group_std(inv, d.rating, len(iids)), nan=0.0)
        log_count = np.log1p(count).astype(np.float32)
        popularity = (log_count / log_count.max()).astype(np.float32)

        years = np.array([float(m.group(1)) if (m := _YEAR.search(t)) else np.nan
                          for t in d.titles.tolist()])
        if np.isnan(years).all():
            year_norm = np.full(len(years), 0.5, np.float32)
        else:
            y_min, y_max = np.nanmin(years), np.nanmax(years)
            year_norm = ((years - y_min) / (y_max - y_min + 1e-8)).astype(np.float32)
            year_norm[np.isnan(year_norm)] = 0.5

        rows = left_join_rows(d.item_ids, iids)
        itf = {
            "item_id": iids.astype(np.int64), "avg_rating": avg,
            "rating_count": count.astype(np.int64), "rating_stddev": std,
            "log_rating_count": log_count, "popularity_score": popularity,
            "title": left_join_take(np.asarray(d.titles, dtype=str), rows, ""),
            "genre_vector": left_join_take(d.genres.astype(np.float32), rows, 0.0),
            "year_normalized": left_join_take(year_norm, rows, 0.5),
        }
        self.item_features = itf
        logger.info("Built item features for %d items", len(iids))
        return itf

    # --- training pairs ----------------------------------------------------- #

    def build_training_pairs(self, n_negatives: int = 4,
                             seed: Optional[int] = None) -> Tuple[Columns, Columns]:
        """Positives (rating ≥ 4) and sampled unrated negatives of the
        ratings set with :meth:`set_data`, with a query-level test split of
        :data:`TEST_RATIO`: (train, test) column dicts of ``user_id``,
        ``item_id``, ``label``, ``rating``, ``query_id``. The same numpy
        stream as the JAX module, draw for draw."""
        r = self.data
        rng = np.random.default_rng(self.seed if seed is None else seed)
        uid = np.asarray(r.user_id).astype(np.int64)
        iid = np.asarray(r.item_id).astype(np.int64)
        rating = np.asarray(r.rating).astype(np.int64)
        all_items = unique_in_order(iid)
        n_catalog = len(all_items)
        logger.info("Building training pairs (%d negatives/positive)...", n_negatives)

        # positives, by user then timestamp
        order = np.lexsort((np.asarray(r.timestamp), uid))
        pos = order[rating[order] >= 4]
        users, rated_per_user = np.unique(uid, return_counts=True)
        pos_users = np.unique(uid[pos])
        rated = rated_per_user[np.searchsorted(users, pos_users)]
        eligible = pos_users[(n_catalog - rated) >= n_negatives]
        pos = pos[np.isin(uid[pos], eligible)]

        # negatives: uniform catalog draws for every (user, slot); rated or
        # repeated draws are drawn again, for at most 20 rounds
        n_pos_users, n_pos_u = np.unique(uid[pos], return_counts=True)
        rated = rated_per_user[np.searchsorted(users, n_pos_users)]
        neg_users = np.repeat(n_pos_users, np.minimum(n_pos_u * n_negatives,
                                                      n_catalog - rated))
        n_neg_total = len(neg_users)
        mod = np.int64(max(iid.max(), all_items.max()) + 1)
        rated_key = np.sort(uid * mod + iid)
        neg_items = rng.choice(all_items, size=n_neg_total).astype(np.int64)
        bad = np.zeros(n_neg_total, bool)
        for _ in range(20):
            key = neg_users * mod + neg_items
            at = np.minimum(np.searchsorted(rated_key, key), len(rated_key) - 1)
            bad = rated_key[at] == key
            bad |= duplicated(key)
            n_bad = int(bad.sum())
            if n_bad == 0:
                break
            neg_items[bad] = rng.choice(all_items, size=n_bad)
        if bad.any():
            # exact fallback for users needing (nearly) all their unrated
            # items; the sets are built as the JAX module builds them, so
            # the shuffled lists come out in the same order
            item_set = set(all_items.tolist())
            for u in np.unique(neg_users[bad]):
                u_mask = neg_users == u
                u_bad = bad & u_mask
                taken = set(neg_items[u_mask & ~bad].tolist())
                avail = list(item_set - set(iid[uid == u].tolist()) - taken)
                rng.shuffle(avail)
                slots = np.nonzero(u_bad)[0]
                neg_items[slots] = avail[: len(slots)]

        user = np.concatenate([uid[pos], neg_users])
        label = np.concatenate([np.ones(len(pos), np.int64),
                                np.zeros(n_neg_total, np.int64)])
        order = np.lexsort((-label, user))          # user asc, label desc, stable
        pairs = {
            "user_id": user[order],
            "item_id": np.concatenate([iid[pos], neg_items])[order],
            "label": label[order],
            "rating": np.concatenate([rating[pos],
                                      np.zeros(n_neg_total, np.int64)])[order],
        }
        pairs["query_id"] = category_codes(pairs["user_id"])

        unique_q = unique_in_order(pairs["query_id"]).copy()
        rng.shuffle(unique_q)
        n_test = max(1, int(len(unique_q) * TEST_RATIO))
        is_test = np.isin(pairs["query_id"], unique_q[:n_test])
        train = {c: a[~is_test] for c, a in pairs.items()}
        test = {c: a[is_test] for c, a in pairs.items()}
        logger.info("Training pairs: %d train, %d test (%d/%d queries)",
                    len(train["label"]), len(test["label"]),
                    len(np.unique(train["query_id"])), len(np.unique(test["query_id"])))
        return train, test

    # --- interaction features ----------------------------------------------- #

    def build_interaction_features(self, pairs: Columns) -> Columns:
        """Join the user and item features onto ``pairs``
        (:func:`~recommendit_tpu_torch.features.schema.assemble_frame`)."""
        if self.user_features is None or self.item_features is None:
            raise RuntimeError(
                "Call build_user_features() and build_item_features() first.")
        return schema.assemble_frame(pairs, self.user_features, self.item_features)

    # --- persistence -------------------------------------------------------- #

    def save_features(self, output_dir: str = "data/features") -> None:
        """Write the feature tables as ``.npz`` (genre matrices flattened to
        ``genre_pref_<i>`` / ``genre_vec_<i>``), then the packed snapshots
        sized to the data set's id ranges."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        for table, name, vec, prefix in (
                (self.user_features, USER_FILE, "genre_pref", "genre_pref_"),
                (self.item_features, ITEM_FILE, "genre_vector", "genre_vec_")):
            if table is None:
                continue
            cols = {c: a for c, a in table.items() if c != vec}
            cols.update({f"{prefix}{i}": table[vec][:, i] for i in range(N_GENRES)})
            np.savez(out / name, **cols)
        if self.user_features is not None and self.item_features is not None:
            np.save(out / USER_SNAPSHOT,
                    pack_user_features(self.user_features, self.data.n_users))
            np.save(out / ITEM_SNAPSHOT,
                    pack_item_features(self.item_features, self.data.n_items))
        logger.info("Saved features to %s", out)

    def load_features(self, features_dir: str = "data/features") -> None:
        """Inverse of :meth:`save_features` (the tables; a missing file
        leaves its table as it was)."""
        d = Path(features_dir)
        for attr, name, vec, prefix in (
                ("user_features", USER_FILE, "genre_pref", "genre_pref_"),
                ("item_features", ITEM_FILE, "genre_vector", "genre_vec_")):
            if not (d / name).exists():
                continue
            with np.load(d / name) as z:
                cols = {c: z[c] for c in z.files}
            names = [f"{prefix}{i}" for i in range(N_GENRES)]
            if all(c in cols for c in names):
                cols[vec] = np.stack([cols.pop(c) for c in names], axis=1
                                     ).astype(np.float32)
            setattr(self, attr, cols)
        logger.info("Loaded features from %s", d)

    @staticmethod
    def get_feature_columns() -> List[str]:
        return schema.feature_columns()
