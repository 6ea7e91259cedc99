"""MovieLens-format data as arrays — the torch port's container and files.

Counterpart of ``recommendit_tpu/data/movielens.py`` without pandas: the
ratings are four aligned int64 arrays (timestamps in seconds), the users
table is its ids and demographics, the catalog is its ids, titles, genre
strings and an (n_items, 18) genre multi-hot matrix. :func:`load_movielens`
reads the ML-1M ``::``-separated ``.dat`` files (latin-1) from a local
directory and :func:`save_movielens` writes them. Nothing is downloaded:
the real ML-1M files are placed in the data directory by hand. The native
C++ parser of the JAX package is not ported (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np

from recommendit_tpu_torch.features.schema import encode_genres_matrix

logger = logging.getLogger(__name__)

EXPECTED_FILES = ("ratings.dat", "users.dat", "movies.dat", "README")
ENCODING = "latin-1"


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
    seconds, aligned), the users table (``user_ids`` with ``gender``,
    ``age``, ``occupation``, ``zip_code``) and the catalog (``item_ids``
    with ``titles``, ``genre_strs`` — the pipe-separated genre names — and
    their multi-hot ``genres`` rows)."""

    user_id: np.ndarray
    item_id: np.ndarray
    rating: np.ndarray
    timestamp: np.ndarray
    user_ids: np.ndarray
    item_ids: np.ndarray
    genres: np.ndarray
    gender: np.ndarray
    age: np.ndarray
    occupation: np.ndarray
    zip_code: np.ndarray
    titles: np.ndarray
    genre_strs: np.ndarray

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


def _read_fields(path: Path, n_fields: int):
    """The ``::``-separated fields of each non-empty line, as ``n_fields``
    lists of strings (columns)."""
    rows = [ln.split("::") for ln in
            path.read_text(encoding=ENCODING).splitlines() if ln]
    bad = next((i for i, r in enumerate(rows) if len(r) != n_fields), None)
    if bad is not None:
        raise ValueError(f"{path}: line {bad + 1} has {len(rows[bad])} "
                         f"fields, expected {n_fields}")
    return [list(col) for col in zip(*rows)] if rows else [[]] * n_fields


def _read_ratings(path: Path) -> np.ndarray:
    """(n, 4) int64 ratings in file order: one split of the whole text."""
    text = path.read_text(encoding=ENCODING)
    n_lines = sum(1 for ln in text.splitlines() if ln)
    values = np.array(text.replace("::", " ").split(), dtype=np.int64)
    if values.size != 4 * n_lines or text.count("::") != 3 * n_lines:
        raise ValueError(f"{path}: every line must hold four '::'-separated "
                         "integers")
    return values.reshape(n_lines, 4)


def load_movielens(data_dir: str = "data/ml-1m") -> MovieLensData:
    """The three MovieLens tables from ``data_dir`` (``ratings.dat``,
    ``users.dat``, ``movies.dat``), ratings in file order."""
    d = Path(data_dir)
    logger.info("Loading MovieLens data from %s", d)
    r = _read_ratings(d / "ratings.dat")
    uid, gender, age, occ, zips = _read_fields(d / "users.dat", 5)
    iid, titles, genre_strs = _read_fields(d / "movies.dat", 3)
    data = MovieLensData(
        user_id=r[:, 0].copy(), item_id=r[:, 1].copy(), rating=r[:, 2].copy(),
        timestamp=r[:, 3].copy(),
        user_ids=np.array(uid, dtype=np.int64), item_ids=np.array(iid, dtype=np.int64),
        genres=encode_genres_matrix(genre_strs),
        gender=np.array(gender, dtype=str), age=np.array(age, dtype=np.int64),
        occupation=np.array(occ, dtype=np.int64), zip_code=np.array(zips, dtype=str),
        titles=np.array(titles, dtype=str), genre_strs=np.array(genre_strs, dtype=str))
    logger.info("Loaded %d ratings, %d users, %d movies", len(data),
                len(data.user_ids), len(data.item_ids))
    return data


def verify_dataset(data_dir) -> bool:
    """Whether the four expected ML-1M files are in ``data_dir``."""
    missing = [f for f in EXPECTED_FILES if not (Path(data_dir) / f).exists()]
    if missing:
        logger.warning("Dataset incomplete, missing: %s", missing)
        return False
    return True


def _write_lines(path: Path, columns) -> None:
    lines = ["::".join(map(str, row)) for row in zip(*columns)]
    path.write_text("\n".join(lines) + "\n", encoding=ENCODING)


def save_movielens(data: MovieLensData, data_dir: str) -> Path:
    """Write the tables in the ``.dat`` format (and a ``README``), as the
    JAX package's ``save_movielens`` does."""
    d = Path(data_dir)
    d.mkdir(parents=True, exist_ok=True)
    _write_lines(d / "ratings.dat", [a.tolist() for a in (
        data.user_id, data.item_id, data.rating, data.timestamp)])
    _write_lines(d / "users.dat", [a.tolist() for a in (
        data.user_ids, data.gender, data.age, data.occupation, data.zip_code)])
    _write_lines(d / "movies.dat", [a.tolist() for a in (
        data.item_ids, data.titles, data.genre_strs)])
    (d / "README").write_text("synthetic movielens-format dataset\n")
    return d


def load_or_synthesize(data_dir: str, seed: int = 0) -> MovieLensData:
    """The data in ``data_dir`` if it is complete, otherwise the default
    synthetic set from ``seed``."""
    if verify_dataset(Path(data_dir)):
        return load_movielens(data_dir)
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens

    logger.warning("No dataset at %s — generating synthetic "
                   "MovieLens-format data", data_dir)
    return make_synthetic_movielens(seed=seed)
