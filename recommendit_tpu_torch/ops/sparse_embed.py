"""Sparse embedding-table updates, the CTR training hot path — torch port.

Counterpart of ``recommendit_tpu/ops/sparse_embed.py``. The trainer
differentiates with respect to the GATHERED rows (B, F, D), so a dense
table-shaped gradient never exists, and updates the stacked table with
row-wise adagrad (one accumulator scalar per row), in place on ``table``
and ``accum`` (JAX donates both to its jitted step).

Duplicate-id semantics, as in JAX: the weight delta for a row hit k times
in one batch is ``-scale * (g_1 + ... + g_k)`` in both kinds of field.
The accumulator differs by kind:

* small fields (vocab <= ``small_threshold``) add ``mean((Σg)²)``, the
  summed-gradient form. JAX sums a field's grads by a one-hot product;
  here one ``index_add_`` sums them for all small fields at once (the same
  sums in another order), and the rows no id touches are left as they
  are, which is what JAX's zero rows of the product give them bit for bit;
* large fields add ``Σ mean(g_i²)`` with one ``index_add_`` (the
  per-example form), then take the scale from the FINAL accumulator
  gathered at each id and scatter-add ``-scale * g``.

Fields own disjoint row ranges of the stacked table, so updating all small
fields, then all large ones, in one pass each is JAX's field-by-field loop.

Ids must lie in their field's range (ROADMAP C.50): the CTR model checks
them on the host where they enter (``models/ctr.py::CTRModel.stack_ids``);
this op does not, since a check on the device would stop the step for a
host read. JAX drops an out-of-range update; ``index_add_`` raises on the
CPU and fails a device assertion on the card.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["field_split", "sparse_table_update", "sparse_adagrad_init"]

DEFAULT_SMALL_VOCAB = 4096


def field_split(
    vocab_sizes: Sequence[int], small_threshold: int = DEFAULT_SMALL_VOCAB
) -> Tuple[List[int], List[int]]:
    """Static (small_fields, large_fields) index lists."""
    small = [f for f, v in enumerate(vocab_sizes) if v <= small_threshold]
    large = [f for f, v in enumerate(vocab_sizes) if v > small_threshold]
    return small, large


def sparse_adagrad_init(n_rows: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(n_rows,) row-wise adagrad accumulator."""
    return torch.zeros((n_rows,), dtype=torch.float32, device=resolve_device(device))


@functools.lru_cache(maxsize=16)
def _plan(vocab_sizes: Tuple[int, ...], small_threshold: int, device: torch.device):
    """The index tensors of one table layout on ``device``, made once so
    that a step copies nothing from the host: the small and the large
    fields' numbers, the small fields' stacked-table rows concatenated,
    and for each small field the shift that maps its stacked ids to their
    places in that list."""
    small, large = field_split(vocab_sizes, small_threshold)
    offsets = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int64)
    rows = [np.arange(offsets[f], offsets[f] + vocab_sizes[f]) for f in small]
    starts = np.cumsum([0] + [vocab_sizes[f] for f in small])[:-1]

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return (put(small), put(large),
            put(np.concatenate(rows) if rows else np.zeros(0)),
            put(starts - offsets[small]))


@torch.no_grad()
def sparse_table_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    ids: torch.Tensor,
    row_grads: torch.Tensor,
    vocab_sizes: Sequence[int],
    lr: float = 0.05,
    small_threshold: int = DEFAULT_SMALL_VOCAB,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply row-wise adagrad to a stacked multi-field embedding table, in
    place.

    Args:
        table: (rows, D) f32 stacked table, updated in place.
        accum: (rows,) f32 adagrad accumulator, updated in place.
        ids: (B, F) globally-offset ids (the gather's indices).
        row_grads: (B, F, D) d(loss)/d(gathered rows).
        vocab_sizes: per-field vocabulary sizes (define the field offsets
            into the stacked table).
        lr / small_threshold / eps: optimizer knobs.

    Returns (table, accum), the tensors passed in.
    """
    d = table.shape[1]
    ids = ids.long()
    small, large, rows, shift = _plan(tuple(int(v) for v in vocab_sizes),
                                      int(small_threshold), table.device)

    if len(small):
        g = torch.zeros((len(rows), d), dtype=table.dtype, device=table.device)
        g.index_add_(0, (ids.index_select(1, small) + shift).reshape(-1),
                     row_grads.index_select(1, small).reshape(-1, d))
        a = accum[rows] + (g * g).mean(dim=1)
        accum[rows] = a
        table[rows] = table[rows] - (lr / (torch.sqrt(a) + eps))[:, None] * g

    if len(large):
        idx = ids.index_select(1, large).reshape(-1)
        g = row_grads.index_select(1, large).reshape(-1, d)
        accum.index_add_(0, idx, (g * g).mean(dim=1))
        scale = lr / (torch.sqrt(accum[idx]) + eps)
        table.index_add_(0, idx, -scale[:, None] * g)

    return table, accum
