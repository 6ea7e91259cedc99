"""(user, item) membership set — the seen filter, torch port.

Counterpart of ``recommendit_tpu/ops/seen.py``: the same numpy CSR set
(``indptr`` + per-row sorted ``cols``) answers host queries, and
:func:`seen_mask` runs the same static-step binary search over a user's
CSR row on the device, so a candidate batch is filtered without leaving it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SeenSet", "seen_mask"]


class SeenSet:
    """CSR membership set over (user, item) pairs; pairs are deduplicated."""

    def __init__(self, user_ids: np.ndarray, item_ids: np.ndarray, n_items: int):
        self.n_items = int(n_items)
        u = np.asarray(user_ids, dtype=np.int64)
        i = np.asarray(item_ids, dtype=np.int64)
        stride = np.int64(self.n_items + 1)
        keys = np.unique(u * stride + i)  # sorted by (user, item), deduped
        rows = (keys // stride).astype(np.int64)
        self.cols = (keys % stride).astype(np.int32)
        n_rows = int(rows.max()) + 1 if rows.size else 1
        counts = np.bincount(rows, minlength=n_rows + 1)
        self.indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(counts[:n_rows], out=self.indptr[1:])
        self._keys = keys
        self._stride = stride
        # static binary-search trip count = ceil(log2(max row length + 1))
        max_row = int(np.max(np.diff(self.indptr))) if self.cols.size else 0
        self.search_steps = max(1, int(np.ceil(np.log2(max_row + 1))))

    @property
    def nnz(self) -> int:
        return int(self.cols.size)

    def nbytes(self) -> int:
        """Bytes of the CSR arrays (``cols`` and ``indptr``)."""
        return int(self.cols.nbytes + self.indptr.nbytes)

    def contains(self, user_ids: np.ndarray, item_ids: np.ndarray) -> np.ndarray:
        """Vectorized host-side membership: bool array of the queries' shape."""
        q = (
            np.asarray(user_ids, dtype=np.int64) * self._stride
            + np.asarray(item_ids, dtype=np.int64)
        )
        if self._keys.size == 0:
            return np.zeros(q.shape, dtype=bool)
        pos = np.searchsorted(self._keys, q)
        pos = np.minimum(pos, self._keys.size - 1)
        return self._keys[pos] == q

    def device_arrays(self, device):
        """(indptr int64, cols int32) on ``device`` for :func:`seen_mask`."""
        return (torch.as_tensor(self.indptr, dtype=torch.int64, device=device),
                torch.as_tensor(self.cols, dtype=torch.int32, device=device))


def seen_mask(indptr: torch.Tensor, cols: torch.Tensor, search_steps: int,
              user_ids: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
    """Membership of broadcastable (user, item) id tensors on the device.

    ``search_steps`` >= ceil(log2(max row + 1)) fixes the trip count, as in
    ``seen_mask_jnp``; users past the last CSR row read the last row, as
    there."""
    u = user_ids.long().clamp(0, indptr.shape[0] - 2)
    item = item_ids.to(torch.int32)
    lo, hi, item = torch.broadcast_tensors(indptr[u], indptr[u + 1], item)
    if cols.shape[0] == 0:
        return torch.zeros(item.shape, dtype=torch.bool, device=item.device)
    last = cols.shape[0] - 1
    end = hi
    for _ in range(search_steps):
        mid = (lo + hi) // 2
        v = cols[mid.clamp(max=last)]
        open_ = lo < hi
        go_right = open_ & (v < item)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    return (lo < end) & (cols[lo.clamp(max=last)] == item)
