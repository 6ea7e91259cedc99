"""Feature-table snapshot (writer + numpy reader) — torch port.

Counterpart of ``recommendit_tpu/features/snapshot.py``: the user and item
feature tables as sorted-id arrays and row-major float32 matrices in one
binary file, with the column names in a ``.meta.json`` sidecar. The file
is framework-free and its layout is the JAX module's, so a snapshot
written by either package opens in the other's reader:

    "FSNAP001" | int64 n_sections | n_sections x int64 (rows, cols,
    ids_offset, data_offset) | per section: int64 ids, float32 rows

Opening is one ``np.memmap``; a lookup is a binary search. The JAX
module's ctypes reader of ``native/libfeaturesnapshot.so`` is not ported
(ROADMAP.md, queue A, the native loaders); its numpy reader, ported here,
has the same semantics.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

MAGIC = b"FSNAP001"
USER_SECTION = 0
ITEM_SECTION = 1


def write_snapshot(path: str, user_ids: np.ndarray, user_matrix: np.ndarray,
                   item_ids: np.ndarray, item_matrix: np.ndarray,
                   user_cols: Sequence[str], item_cols: Sequence[str]) -> Path:
    """Write the binary snapshot and the column-name sidecar. Rows are
    sorted by id (the reader binary-searches); the genre blocks are named
    by the pseudo-columns ``genre_pref`` / ``genre_vector``, one per
    genre."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    sections = []
    for ids, mat in ((user_ids, user_matrix), (item_ids, item_matrix)):
        ids = np.asarray(ids, np.int64)
        mat = np.ascontiguousarray(mat, np.float32)
        if mat.ndim != 2 or len(ids) != len(mat):
            raise ValueError(f"matrix {mat.shape} does not match {len(ids)} ids")
        order = np.argsort(ids, kind="stable")
        sections.append((ids[order], mat[order]))

    offset = 16 + 32 * len(sections)
    spans = []
    for ids, mat in sections:
        spans.append((len(ids), mat.shape[1], offset, offset + ids.nbytes))
        offset += ids.nbytes + mat.nbytes
    with open(p, "wb") as f:
        f.write(MAGIC)
        f.write(np.int64(len(sections)).tobytes())
        for span in spans:
            f.write(np.asarray(span, np.int64).tobytes())
        for ids, mat in sections:
            f.write(ids.tobytes())
            f.write(mat.tobytes())
    Path(str(p) + ".meta.json").write_text(json.dumps({
        "user_cols": list(user_cols), "item_cols": list(item_cols)}))
    logger.info("Wrote feature snapshot %s (%d users, %d items, %.1f MB)",
                p, spans[0][0], spans[1][0], offset / 1e6)
    return p


class _NumpyBackend:
    """``np.memmap`` + ``searchsorted`` over the snapshot's sections."""

    def __init__(self, path: Path):
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        if bytes(raw[:8]) != MAGIC:
            raise ValueError(f"bad snapshot magic in {path}")
        n_sections = int(np.frombuffer(raw[8:16], np.int64)[0])
        self.sections = []
        for i in range(n_sections):
            hdr = np.frombuffer(raw[16 + 32 * i: 48 + 32 * i], np.int64)
            n_rows, n_cols, ids_off, data_off = (int(v) for v in hdr)
            ids = np.frombuffer(raw, np.int64, n_rows, ids_off)
            data = np.frombuffer(raw, np.float32, n_rows * n_cols,
                                 data_off).reshape(n_rows, n_cols)
            self.sections.append((ids, data))

    def rows(self, section: int) -> int:
        return len(self.sections[section][0])

    def cols(self, section: int) -> int:
        return self.sections[section][1].shape[1]

    def lookup(self, section: int, id_: int) -> Optional[np.ndarray]:
        ids, data = self.sections[section]
        pos = int(np.searchsorted(ids, id_))
        if pos >= len(ids) or ids[pos] != id_:
            return None
        return np.array(data[pos])

    def gather(self, section: int, ids, fill: float = 0.0):
        tbl_ids, data = self.sections[section]
        ids = np.asarray(ids, np.int64)
        pos = np.searchsorted(tbl_ids, ids)
        pos_c = np.minimum(pos, len(tbl_ids) - 1)
        found = (pos < len(tbl_ids)) & (tbl_ids[pos_c] == ids)
        out = np.where(found[:, None], data[pos_c], np.float32(fill)).astype(np.float32)
        return out, found


class FeatureSnapshot:
    """Read-only memory-mapped view of the user and item feature tables."""

    def __init__(self, path: str):
        self.path = Path(path)
        if not self.path.exists():
            raise FileNotFoundError(f"snapshot not found: {path}")
        meta = json.loads(Path(str(path) + ".meta.json").read_text())
        self.user_cols: List[str] = meta["user_cols"]
        self.item_cols: List[str] = meta["item_cols"]
        self.backend = _NumpyBackend(self.path)

    def n_users(self) -> int:
        return self.backend.rows(USER_SECTION)

    def n_items(self) -> int:
        return self.backend.rows(ITEM_SECTION)

    def user_row(self, user_id: int) -> Optional[np.ndarray]:
        return self.backend.lookup(USER_SECTION, user_id)

    def item_row(self, item_id: int) -> Optional[np.ndarray]:
        return self.backend.lookup(ITEM_SECTION, item_id)

    def gather_items(self, item_ids, fill: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Item rows → ((n, C) matrix, (n,) found mask)."""
        return self.backend.gather(ITEM_SECTION, item_ids, fill)

    @staticmethod
    def _row_to_dict(row: np.ndarray, cols: List[str], genre_key: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        genre_vals: List[float] = []
        for c, v in zip(cols, row.tolist()):
            if c == genre_key:
                genre_vals.append(float(v))
            else:
                out[c] = float(v)
        if genre_vals:
            out[genre_key] = genre_vals
        return out

    def user_dict(self, user_id: int) -> Optional[Dict[str, Any]]:
        """The user's features as the store holds them (floats, the genre
        block as a ``genre_pref`` list)."""
        row = self.user_row(user_id)
        return None if row is None else self._row_to_dict(row, self.user_cols, "genre_pref")

    def item_dict(self, item_id: int) -> Optional[Dict[str, Any]]:
        """The item's features as the store holds them, without the title."""
        row = self.item_row(item_id)
        return None if row is None else self._row_to_dict(row, self.item_cols, "genre_vector")


def write_snapshot_from_frames(path: str, user_features: Mapping[str, np.ndarray],
                               item_features: Mapping[str, np.ndarray]) -> Path:
    """A snapshot of the flattened feature columns (``genre_pref_<i>`` /
    ``genre_vec_<i>``, as ``features/engineering.py`` saves them; the
    inputs of ``FeatureStore.load_all_features``), in their column order."""
    ug = [c for c in user_features if c.startswith("genre_pref_")]
    u_scal = [c for c in user_features if c != "user_id" and c not in ug]
    ig = [c for c in item_features if c.startswith("genre_vec_")]
    i_scal = [c for c in item_features if c not in ("item_id", "title") and c not in ig]
    return write_snapshot(
        path,
        user_features["user_id"], _matrix(user_features, u_scal + ug),
        item_features["item_id"], _matrix(item_features, i_scal + ig),
        u_scal + ["genre_pref"] * len(ug), i_scal + ["genre_vector"] * len(ig))


def _matrix(frame: Mapping[str, np.ndarray], cols: Sequence[str]) -> np.ndarray:
    """The columns as one (n, C) float32 matrix (through float64, as a
    mixed-dtype DataFrame's ``.values`` goes)."""
    return np.stack([np.asarray(frame[c], np.float64) for c in cols], axis=1
                    ).astype(np.float32)
