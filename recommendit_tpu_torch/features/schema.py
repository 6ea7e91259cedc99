"""The ranking feature contract — torch view.

Counterpart of ``recommendit_tpu/features/schema.py``. The constants are
copied, not imported: the JAX package's ``features`` package imports pandas
when it is loaded, and the port must run where neither jax nor pandas is
installed. ``tests/test_torch_schema.py`` pins every constant to the JAX
values and :func:`assemble_packed` to ``assemble_packed_np``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

# MovieLens-1M genre vocabulary, in dataset order
GENRES: List[str] = [
    "Action", "Adventure", "Animation", "Children's", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
    "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
    "Thriller", "War", "Western",
]
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
