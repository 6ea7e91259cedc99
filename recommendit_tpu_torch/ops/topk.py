"""MIPS top-k in plain PyTorch.

Counterpart of ``recommendit_tpu/ops/topk.py`` for the modes the serve path
uses. The JAX package chunks its exact reduce into 16k-wide pieces to dodge
a TPU PartialReduce cliff (``_chunked_exact_reduce``); ``torch.topk`` has no
such cliff, so each reduce here is one call.

Modes:

* ``exact`` — scores in true f32 (TF32 off, the counterpart of the JAX
  package's ``precision=HIGHEST``), exact top-k.
* ``approx`` — scores at the corpus dtype ("default" precision: the queries
  are rounded to the corpus dtype, products accumulate in f32), exact
  top-k over them. The JAX package selects with ``lax.approx_max_k`` at
  recall 0.95 here; ``torch.topk`` is exact, so the port's approx mode is
  at least as good on the same scores.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

PRECISIONS = ("default", "highest")


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matmuls in full f32 on the card (TF32 off) inside the
    block, restoring the caller's setting afterwards."""
    flag = torch.backends.cuda.matmul
    prev = flag.allow_tf32
    flag.allow_tf32 = False
    try:
        yield
    finally:
        flag.allow_tf32 = prev


def round_queries(queries: torch.Tensor, corpus_dtype: torch.dtype,
                  precision: str) -> torch.Tensor:
    """f32 queries for scoring a ``corpus_dtype`` corpus at ``precision``.

    "default": rounded to the corpus dtype first (the JAX ``_mm_operands``
    rule), so a bf16 corpus scores bf16 x bf16 products — exact in f32 —
    with f32 accumulation. "highest": the f32 queries as they are."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (default | highest)")
    if precision == "default":
        queries = queries.to(corpus_dtype)
    return queries.float()


def mm_operands(queries: torch.Tensor, items: torch.Tensor, precision: str):
    """f32 operands of a score matmul at ``precision``: the rounded queries
    and the f32-widened corpus."""
    return round_queries(queries, items.dtype, precision), items.float()


def score_matrix(queries: torch.Tensor, items: torch.Tensor,
                 precision: str = "highest") -> torch.Tensor:
    """(Q, D) x (N, D) → (Q, N) f32 scores, never rounded below f32."""
    q, it = mm_operands(queries, items, precision)
    with full_f32_matmul():
        return q @ it.T


def fast_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, sorted descending."""
    return torch.topk(scores, k, dim=-1, largest=True, sorted=True)


def canonical_tie_order(vals: torch.Tensor, idxs: torch.Tensor):
    """Reorder each row's top-k into (value desc, index asc) order, so that
    paths which return the same set in different tie orders compare equal
    (counterpart of ``canonical_tie_order``, ``ops/topk.py:139``)."""
    by_idx = torch.argsort(idxs, dim=-1, stable=True)
    vals = torch.gather(vals, -1, by_idx)
    idxs = torch.gather(idxs, -1, by_idx)
    by_val = torch.argsort(-vals, dim=-1, stable=True)
    return torch.gather(vals, -1, by_val), torch.gather(idxs, -1, by_val)


def mips_topk(
    queries: torch.Tensor,
    item_embs: torch.Tensor,
    k: int,
    mode: str = "exact",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the item corpus → (values (Q, k) f32, positions (Q, k)
    int64), sorted descending. ``n_valid``: real rows of a corpus padded
    with zero rows at its end (the padded rows are never returned)."""
    n = item_embs.shape[0]
    if n_valid is not None and not (0 < n_valid <= n):
        raise ValueError(f"n_valid={n_valid} out of range for N={n}")
    if n_valid is not None and n_valid < n:
        item_embs = item_embs[:n_valid]
    if k > item_embs.shape[0]:
        raise ValueError(f"k={k} exceeds corpus size {item_embs.shape[0]}")
    if mode == "exact":
        precision = "highest"
    elif mode == "approx":
        precision = "default"
    else:
        raise ValueError(f"unknown mips_topk mode {mode!r} (exact | approx)")
    return fast_topk(score_matrix(queries, item_embs, precision), k)
