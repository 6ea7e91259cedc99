"""The ranking feature contract — torch view.

Counterpart of ``recommendit_tpu/features/schema.py``. The constants are
copied, not imported: the JAX package's ``features`` package imports pandas
when it is loaded, and the port must run where neither jax nor pandas is
installed. ``tests/test_torch_schema.py`` pins every constant to the JAX
values and :func:`assemble_packed` to ``assemble_packed_np``.

The JAX module's DataFrames are column dicts here: a dict of aligned numpy
arrays, one per column, in the frame's column order; a genre array column
(``genre_pref``, ``genre_vector``) is one (n, 18) float32 matrix. Three
views assemble the 50 columns: :func:`assemble_frame` (offline, for
training pairs), :func:`assemble_online` (from feature-store dicts) and
:func:`assemble_packed_np` / :func:`assemble_packed` (from the packed
tables, numpy and torch). ``tests/test_torch_features.py`` holds them to
the JAX views bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

Columns = Dict[str, np.ndarray]

# MovieLens-1M genre vocabulary, in dataset order
GENRES: List[str] = [
    "Action", "Adventure", "Animation", "Children's", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
    "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
    "Thriller", "War", "Western",
]
GENRE_TO_IDX = {g: i for i, g in enumerate(GENRES)}
N_GENRES = len(GENRES)

USER_SCALAR_COLS = [
    "avg_rating", "log_rating_count", "recency_score",
    "gender_encoded", "age_normalized", "occupation_normalized",
]
ITEM_SCALAR_COLS = [
    "item_avg_rating", "item_log_rating_count", "popularity_score",
    "rating_stddev", "year_normalized",
]
INTERACTION_COLS = ["rating_diff", "user_item_popularity_ratio", "genre_affinity"]
USER_GENRE_COLS = [f"user_genre_{i}" for i in range(N_GENRES)]
ITEM_GENRE_COLS = [f"item_genre_{i}" for i in range(N_GENRES)]

# serving-time defaults for missing features (reference recommender.py:229-240)
USER_DEFAULTS = {
    "avg_rating": 3.5, "log_rating_count": 0.0, "recency_score": 0.5,
    "gender_encoded": 0.0, "age_normalized": 0.3, "occupation_normalized": 0.3,
}
ITEM_DEFAULTS = {
    "item_avg_rating": 3.5, "item_log_rating_count": 0.0,
    "popularity_score": 0.0, "rating_stddev": 0.0, "year_normalized": 0.5,
}
# the item feature table's names of the ITEM_SCALAR_COLS, in that order
ITEM_SOURCE_COLS = ["avg_rating", "log_rating_count", "popularity_score",
                    "rating_stddev", "year_normalized"]

USER_PACKED_DIM = len(USER_SCALAR_COLS) + N_GENRES     # 24
ITEM_PACKED_DIM = len(ITEM_SCALAR_COLS) + N_GENRES     # 23
N_FEATURES = (
    len(USER_SCALAR_COLS) + len(ITEM_SCALAR_COLS) + len(INTERACTION_COLS)
    + 2 * N_GENRES
)  # 50

FEATURE_COLUMNS: List[str] = (
    USER_SCALAR_COLS + ITEM_SCALAR_COLS + INTERACTION_COLS
    + USER_GENRE_COLS + ITEM_GENRE_COLS
)
if len(FEATURE_COLUMNS) != N_FEATURES:
    raise RuntimeError("feature contract must have 50 columns")

GATHER_PAD_WIDTH = 64


def pad_packed_width(table, width: int = GATHER_PAD_WIDTH):
    """Zero-pad packed feature rows to ``width`` columns (numpy or torch).

    The JAX package pads item rows to 64 columns for TPU gathers; the port
    keeps the same table layout so both load the same snapshot.
    :func:`assemble_packed` ignores the trailing columns."""
    w = table.shape[-1]
    if w >= width:
        return table
    if isinstance(table, np.ndarray):
        pad = [(0, 0)] * (table.ndim - 1) + [(0, width - w)]
        return np.pad(table, pad)
    return torch.nn.functional.pad(table, (0, width - w))


def assemble_packed(user_vec: torch.Tensor, item_mat: torch.Tensor) -> torch.Tensor:
    """Device feature assembly in the 50-column order.

    ``user_vec`` (..., 24) and ``item_mat`` (..., C, >=23) → (..., C, 50):
    one request as (24,), (C, 23+) or a batch as (B, 24), (B, C, 23+).
    Item columns beyond the 23-column contract (gather padding) are
    ignored. Torch twin of ``assemble_packed_jnp``.
    """
    nu, ni = len(USER_SCALAR_COLS), len(ITEM_SCALAR_COLS)
    c = item_mat.shape[-2]
    u_scal = user_vec[..., :nu]
    u_genre = user_vec[..., nu:nu + N_GENRES]
    i_scal = item_mat[..., :ni]
    i_genre = item_mat[..., ni:ni + N_GENRES]
    rating_diff = u_scal[..., None, 0] - i_scal[..., 0]
    pop_ratio = u_scal[..., None, 1] / (i_scal[..., 1] + 1e-8)
    affinity = (i_genre @ u_genre[..., :, None])[..., 0]
    lead = item_mat.shape[:-2]
    return torch.cat(
        [
            u_scal[..., None, :].expand(*lead, c, nu),
            i_scal,
            torch.stack([rating_diff, pop_ratio, affinity], dim=-1),
            u_genre[..., None, :].expand(*lead, c, N_GENRES),
            i_genre,
        ],
        dim=-1,
    )


# ------------------------------------------------------------------ #
# Genre encoding                                                       #
# ------------------------------------------------------------------ #

def encode_genres(genre_str: str) -> np.ndarray:
    """Pipe-separated genre string → 18-dim multi-hot (unknown names are
    ignored)."""
    vec = np.zeros(N_GENRES, dtype=np.float32)
    for g in str(genre_str).split("|"):
        idx = GENRE_TO_IDX.get(g)
        if idx is not None:
            vec[idx] = 1.0
    return vec


def encode_genres_matrix(genre_strs: Sequence[str]) -> np.ndarray:
    """(n, 18) float32 multi-hot of a catalog's genre strings, as the JAX
    module's ``str.get_dummies(sep="|")`` gives it: a known name sets its
    column, an unknown one is ignored, an empty string is a zero row."""
    strs = np.asarray(genre_strs, dtype=str)
    if strs.size == 0:
        return np.zeros((0, N_GENRES), dtype=np.float32)
    uniq, inv = np.unique(strs, return_inverse=True)
    rows = np.stack([encode_genres(g) for g in uniq.tolist()])
    return rows[inv.reshape(-1)]


# ------------------------------------------------------------------ #
# Packed dense tables                                                  #
# ------------------------------------------------------------------ #

def _scalars(table: Columns, cols: List[str], ok: np.ndarray) -> np.ndarray:
    return np.stack([np.asarray(table[c])[ok] for c in cols],
                    axis=1).astype(np.float32)


def pack_user_features(user_features: Columns, n_users: int) -> np.ndarray:
    """Dense [n_users+1, 24] table indexed by user_id (row 0 and users
    without features hold :data:`USER_DEFAULTS` and a zero genre vector).
    ``user_features`` holds USER_SCALAR_COLS and ``genre_pref`` (the output
    of ``FeatureEngineer.build_user_features``)."""
    out = np.zeros((n_users + 1, USER_PACKED_DIM), dtype=np.float32)
    out[:, : len(USER_SCALAR_COLS)] = [USER_DEFAULTS[c] for c in USER_SCALAR_COLS]
    ids = np.asarray(user_features["user_id"]).astype(np.int64)
    ok = (ids >= 1) & (ids <= n_users)
    out[ids[ok], : len(USER_SCALAR_COLS)] = _scalars(user_features,
                                                     USER_SCALAR_COLS, ok)
    out[ids[ok], len(USER_SCALAR_COLS):] = np.asarray(
        user_features["genre_pref"])[ok].astype(np.float32)
    return out


def pack_item_features(item_features: Columns, n_items: int) -> np.ndarray:
    """Dense [n_items+1, 23] table indexed by item_id (row 0 and items
    without features hold :data:`ITEM_DEFAULTS`). ``item_features`` has the
    item table's names (:data:`ITEM_SOURCE_COLS` and ``genre_vector``)."""
    out = np.zeros((n_items + 1, ITEM_PACKED_DIM), dtype=np.float32)
    out[:, : len(ITEM_SCALAR_COLS)] = [ITEM_DEFAULTS[c] for c in ITEM_SCALAR_COLS]
    ids = np.asarray(item_features["item_id"]).astype(np.int64)
    ok = (ids >= 1) & (ids <= n_items)
    out[ids[ok], : len(ITEM_SCALAR_COLS)] = _scalars(item_features,
                                                     ITEM_SOURCE_COLS, ok)
    out[ids[ok], len(ITEM_SCALAR_COLS):] = np.asarray(
        item_features["genre_vector"])[ok].astype(np.float32)
    return out


def assemble_packed_np(user_vec: np.ndarray, item_mat: np.ndarray) -> np.ndarray:
    """numpy view of the packed assembly: (24,), (C, 23+) → (C, 50) float32,
    trailing gather-padding columns ignored; the JAX numpy twin's
    operations in its order."""
    nu, ni = len(USER_SCALAR_COLS), len(ITEM_SCALAR_COLS)
    c = item_mat.shape[0]
    u_scal, u_genre = user_vec[:nu], user_vec[nu:nu + N_GENRES]
    i_scal = item_mat[:, :ni]
    i_genre = item_mat[:, ni:ni + N_GENRES]
    rating_diff = u_scal[0] - i_scal[:, 0]
    pop_ratio = u_scal[1] / (i_scal[:, 1] + 1e-8)
    # multiply-then-sum (not a matvec), as the offline join sums
    affinity = np.sum(i_genre * u_genre, axis=1)
    return np.concatenate(
        [
            np.broadcast_to(u_scal, (c, nu)),
            i_scal,
            np.stack([rating_diff, pop_ratio, affinity], axis=1),
            np.broadcast_to(u_genre, (c, N_GENRES)),
            i_genre,
        ],
        axis=1,
    ).astype(np.float32)


# ------------------------------------------------------------------ #
# Online assembly from feature-store dicts                             #
# ------------------------------------------------------------------ #

def user_dict_to_packed(user_features: Optional[Dict[str, Any]]) -> np.ndarray:
    """Feature-store user dict → packed (24,) vector with serving defaults."""
    uf = user_features or {}
    vec = np.zeros(USER_PACKED_DIM, dtype=np.float32)
    for i, c in enumerate(USER_SCALAR_COLS):
        vec[i] = float(uf.get(c, USER_DEFAULTS[c]))
    pref = np.asarray(uf.get("genre_pref", np.zeros(N_GENRES)), dtype=np.float32)
    vec[len(USER_SCALAR_COLS): len(USER_SCALAR_COLS) + min(N_GENRES, pref.size)] = (
        pref[:N_GENRES]
    )
    return vec


def item_dict_to_packed(item_features: Optional[Dict[str, Any]]) -> np.ndarray:
    """Feature-store item dict → packed (23,) vector with serving defaults."""
    itf = item_features or {}
    vec = np.zeros(ITEM_PACKED_DIM, dtype=np.float32)
    for i, (c, dst) in enumerate(zip(ITEM_SOURCE_COLS, ITEM_SCALAR_COLS)):
        vec[i] = float(itf.get(c, ITEM_DEFAULTS[dst]))
    g = np.asarray(itf.get("genre_vector", np.zeros(N_GENRES)), dtype=np.float32)
    vec[len(ITEM_SCALAR_COLS): len(ITEM_SCALAR_COLS) + min(N_GENRES, g.size)] = (
        g[:N_GENRES]
    )
    return vec


def assemble_online(
    user_features: Optional[Dict[str, Any]],
    item_features_batch: Dict[int, Optional[Dict[str, Any]]],
    candidate_item_ids: Sequence[int],
) -> Columns:
    """Serving-path assembly from store dicts: ``item_id`` and the 50
    feature columns of each candidate, with the serving defaults."""
    u = user_dict_to_packed(user_features)
    items = np.stack(
        [item_dict_to_packed(item_features_batch.get(i)) for i in candidate_item_ids]
    ) if len(candidate_item_ids) else np.zeros((0, ITEM_PACKED_DIM), np.float32)
    mat = assemble_packed_np(u, items)
    out = {"item_id": np.asarray(list(candidate_item_ids), dtype=np.int64)}
    out.update({c: mat[:, j] for j, c in enumerate(FEATURE_COLUMNS)})
    return out


# ------------------------------------------------------------------ #
# Offline assembly (training joins)                                    #
# ------------------------------------------------------------------ #

def left_join_rows(keys: np.ndarray, wanted: np.ndarray) -> np.ndarray:
    """Row of each ``wanted`` key in ``keys`` (unique), -1 where absent: the
    rows a left join on that key takes."""
    keys = np.asarray(keys).astype(np.int64)
    wanted = np.asarray(wanted).astype(np.int64)
    if keys.size == 0:
        return np.full(wanted.shape, -1, np.int64)
    sorter = np.argsort(keys, kind="stable")
    pos = np.minimum(np.searchsorted(keys, wanted, sorter=sorter), keys.size - 1)
    rows = sorter[pos]
    return np.where(keys[rows] == wanted, rows, -1)


def left_join_take(col: np.ndarray, rows: np.ndarray, fill=np.nan) -> np.ndarray:
    """``col[rows]`` (rows of :func:`left_join_rows`) with ``fill`` where a
    row is -1 (a left join's miss)."""
    out = col[np.maximum(rows, 0)]
    out[rows < 0] = fill
    return out


def assemble_frame(pairs: Columns, user_features: Columns,
                   item_features: Columns) -> Columns:
    """Offline interaction-feature join for ranker training, as the JAX
    ``assemble_frame``: the pairs' ``user_id``, ``item_id`` (and ``label``,
    ``query_id`` where present), the user scalars, the item scalars
    (renamed ``item_*``), ``rating_diff`` and the popularity ratio, the
    2 x 18 genre columns and ``genre_affinity``; a user or item without
    features reads 0.0 (a left join, then NaN → 0)."""
    keep = [c for c in ("user_id", "item_id", "label", "query_id") if c in pairs]
    out: Columns = {c: np.asarray(pairs[c]) for c in keep}
    u_rows = left_join_rows(user_features["user_id"], pairs["user_id"])
    i_rows = left_join_rows(item_features["item_id"], pairs["item_id"])
    # scalars round through float32 before the derived arithmetic, so this
    # join equals the packed f32 views
    for c in USER_SCALAR_COLS:
        out[c] = left_join_take(np.asarray(user_features[c]).astype(np.float32), u_rows)
    for src, dst in zip(ITEM_SOURCE_COLS, ITEM_SCALAR_COLS):
        out[dst] = left_join_take(np.asarray(item_features[src]).astype(np.float32), i_rows)
    out["rating_diff"] = out["avg_rating"] - out["item_avg_rating"]
    out["user_item_popularity_ratio"] = (
        out["log_rating_count"]
        / (out["item_log_rating_count"] + np.float32(1e-8)))
    ugm = left_join_take(np.asarray(user_features["genre_pref"]).astype(np.float32), u_rows)
    igm = left_join_take(np.asarray(item_features["genre_vector"]).astype(np.float32), i_rows)
    ugm, igm = np.nan_to_num(ugm, nan=0.0), np.nan_to_num(igm, nan=0.0)
    out.update({c: ugm[:, j] for j, c in enumerate(USER_GENRE_COLS)})
    out.update({c: igm[:, j] for j, c in enumerate(ITEM_GENRE_COLS)})
    # column-major products, as pandas hands the genre blocks over: the sum
    # runs across the 18 columns in order
    out["genre_affinity"] = np.sum(np.asfortranarray(ugm) * np.asfortranarray(igm),
                                   axis=1)
    return {c: (np.where(np.isnan(v), v.dtype.type(0), v)
                if v.dtype.kind == "f" else v) for c, v in out.items()}
