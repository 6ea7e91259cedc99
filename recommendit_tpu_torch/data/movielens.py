"""MovieLens-format data as arrays — the torch port's container.

Counterpart of ``recommendit_tpu/data/movielens.py::MovieLensData`` without
pandas: the ratings are four aligned arrays, the catalog is its ids and an
(n_items, 18) genre multi-hot matrix. Reading the ``.dat`` / parquet files
is not ported (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def timestamp_order(timestamps: np.ndarray) -> np.ndarray:
    """The permutation ``DataFrame.sort_values("timestamp")`` applies to a
    ``datetime64[s]`` column: numpy's default (introsort, not stable)
    argsort of the datetime values. Ties keep that sort's order, which is
    neither the input order nor what an int64 argsort gives, so rows with
    equal timestamps land where the JAX pipeline puts them."""
    ts = np.asarray(timestamps, dtype=np.int64).astype("datetime64[s]")
    return np.argsort(ts, kind="quicksort")


@dataclasses.dataclass
class MovieLensData:
    """Ratings (``user_id``, ``item_id``, ``rating``, ``timestamp`` in int64
    seconds, aligned), the users table's ids and the catalog (``item_ids``
    with one ``genres`` row each)."""

    user_id: np.ndarray
    item_id: np.ndarray
    rating: np.ndarray
    timestamp: np.ndarray
    user_ids: np.ndarray
    item_ids: np.ndarray
    genres: np.ndarray

    @property
    def n_users(self) -> int:
        """The largest user id in the ratings or the users table."""
        return int(max(self.user_id.max(), self.user_ids.max()))

    @property
    def n_items(self) -> int:
        """The largest item id in the ratings or the catalog."""
        return int(max(self.item_id.max(), self.item_ids.max()))

    def __len__(self) -> int:
        return len(self.user_id)

    def train_view(self, fraction: float) -> "MovieLensData":
        """The pipeline's temporal train split (``run_pipeline._train_view``):
        the ratings sorted by timestamp, the first ``int(len * fraction)``
        kept; the users table and the catalog stay whole. ``fraction >= 1``
        returns the data as it is."""
        if fraction >= 1.0:
            return self
        order = timestamp_order(self.timestamp)[: int(len(self) * fraction)]
        return dataclasses.replace(
            self, user_id=self.user_id[order], item_id=self.item_id[order],
            rating=self.rating[order], timestamp=self.timestamp[order])
