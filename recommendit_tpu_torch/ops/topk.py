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

Over an int8 corpus (:func:`mips_topk_int8`) the queries are quantised per
row to int8 (:func:`quantize_queries`) and the score is the int8 · int8 dot
times the outer product of the two scale vectors. The dot is taken as an f32
product of the widened operands with TF32 off, which is exact: every partial
sum is an integer of magnitude ≤ 127² · 1024 < 2^24 for D ≤ 1024.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from recommendit_tpu_torch.ops.quantize import row_scales

PRECISIONS = ("default", "highest")
INT8_MAX_DIM = 1024               # f32 sums of int8 products stay exact
INT8_ROW_ALIGN = 16               # int8 row bytes the window kernel loads at once
_INT8_SCORE_BUDGET = 1 << 28      # score elements per chunk (1 GB of f32)


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


def quantize_queries(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric round-to-nearest int8 quantization → ((Q, D) int8,
    (Q,) f32 scales): ``_quantize_queries`` as XLA compiles it under jit,
    where the scale ``absmax / 127`` becomes ``absmax · float32(1/127)``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    q_scale = row_scales(queries)
    q_i8 = torch.round(queries / q_scale[:, None]).clamp_(-127.0, 127.0)
    return q_i8.to(torch.int8), q_scale


def int8_dot(q_i8: torch.Tensor, items_i8: torch.Tensor) -> torch.Tensor:
    """(Q, D) int8 · (N, D) int8 → (Q, N) f32 holding the exact int32 sums."""
    if q_i8.shape[-1] > INT8_MAX_DIM:
        raise ValueError(
            f"int8 feature dim {q_i8.shape[-1]} exceeds {INT8_MAX_DIM}")
    with full_f32_matmul():
        return q_i8.float() @ items_i8.float().T


def score_int8(q_i8: torch.Tensor, q_scale: torch.Tensor,
               items_i8: torch.Tensor, item_scales: torch.Tensor) -> torch.Tensor:
    """Dequantised scores (``_score_int8``): the int8 dot times the outer
    product of the scale vectors, taken in that order."""
    return int8_dot(q_i8, items_i8) * (q_scale[:, None] * item_scales[None, :])


def mips_topk_int8(
    queries: torch.Tensor,
    items_i8: torch.Tensor,
    item_scales: torch.Tensor,
    k: int,
    mode: str = "exact",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an int8 corpus with per-row scales → (values (Q, k) f32,
    positions (Q, k) int64), sorted descending. The queries are quantised
    on the fly. Both modes select the exact top-k of the int8 scores (JAX's
    ``approx`` uses ``approx_max_k`` at recall 0.95). The corpus is scored
    in row chunks that bound the live (Q, chunk) slab."""
    n = items_i8.shape[0]
    if n_valid is not None and not (0 < n_valid <= n):
        raise ValueError(f"n_valid={n_valid} out of range for N={n}")
    if k > (n if n_valid is None else n_valid):
        raise ValueError(f"k={k} exceeds corpus size {n_valid or n}")
    if mode not in ("exact", "approx"):
        raise ValueError(f"unknown mips_topk_int8 mode {mode!r} (exact | approx)")
    if n_valid is not None:
        items_i8, item_scales = items_i8[:n_valid], item_scales[:n_valid]
    q_i8, q_scale = quantize_queries(queries.float())
    chunk = max(k, _INT8_SCORE_BUDGET // max(1, queries.shape[0]))
    vals = idxs = None
    for s in range(0, items_i8.shape[0], chunk):
        scores = score_int8(q_i8, q_scale, items_i8[s:s + chunk],
                            item_scales[s:s + chunk])
        v, i = fast_topk(scores, min(k, scores.shape[1]))
        if vals is None:
            vals, idxs = v, i + s
            continue
        cand_v = torch.cat([vals, v], dim=1)
        cand_i = torch.cat([idxs, i + s], dim=1)
        vals, sel = fast_topk(cand_v, k)
        idxs = torch.gather(cand_i, 1, sel)
    return vals, idxs
