"""MIPS top-k in plain PyTorch.

Counterpart of ``recommendit_tpu/ops/topk.py`` for the modes the serve path
uses. The JAX package chunks its exact reduce into 16k-wide pieces to dodge
a TPU PartialReduce cliff (``_chunked_exact_reduce``); ``torch.topk`` has no
such cliff, so each reduce here is one call.

Modes:

* ``exact`` — scores in true f32 (TF32 off, the counterpart of the JAX
  package's ``precision=HIGHEST``), exact top-k, scored in column chunks
  of at most ``_SCORE_BUDGET`` entries (:func:`_exact_topk`), so any
  corpus size fits.
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

The certified-exact engines of the ``verified`` index mode follow, each
beside its JAX line and with JAX's structure (blocks, chunks, windows), so
the tests can hold every branch to JAX's: :func:`mips_topk_certified`
(``method="count"``: a prefilter of ``oversample · k`` candidates and a
count-above certificate, :func:`_verified_topk`; ``method="bound"``: one
pass over bf16-rounded inputs, an exact rescore of the candidates and a
rounding-error certificate, :func:`_bound_verified_topk`), escalating to the
windowed exact path (:func:`_exact_topk`) when a certificate fails. Every
pass of the count method scores in full f32. The JAX prefilter is
``approx_max_k`` at recall 0.95; here it is the exact ``torch.topk`` (C.4),
so the certificate holds unless two passes round one score differently.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from recommendit_tpu_torch.ops._build import count_launch

from recommendit_tpu_torch.ops.quantize import row_scales

PRECISIONS = ("default", "highest")
INT8_MAX_DIM = 1024               # f32 sums of int8 products stay exact
INT8_ROW_ALIGN = 16               # int8 row bytes the window kernel loads at once
_INT8_SCORE_BUDGET = 1 << 28      # score elements per chunk (1 GB of f32)


@contextlib.contextmanager
def _tf32(allow: bool):
    flag = torch.backends.cuda.matmul
    prev = flag.allow_tf32
    flag.allow_tf32 = allow
    try:
        yield
    finally:
        flag.allow_tf32 = prev


def full_f32_matmul():
    """Run float32 matmuls in full f32 on the card (TF32 off) inside the
    block, restoring the caller's setting afterwards."""
    return _tf32(False)


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


def fast_topk(scores: torch.Tensor, k: int, recall_target: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, sorted descending, with JAX's
    signature (``fast_topk``, ``ops/topk.py:51``). JAX selects with
    ``lax.approx_max_k`` below ``recall_target`` 1; ``torch.topk`` is exact
    at every target (C.4), so the target changes nothing here."""
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
    block_size: int = 4096,
    mode: str = "exact",
    canonical: bool = False,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the item corpus → (values (Q, k) f32, positions (Q, k)
    int64), sorted descending, with JAX's signature and dispatch
    (``mips_topk``, ``:550``).

    ``exact``: full-f32 scores through :func:`_exact_topk`, in column chunks
    of at most ``_SCORE_BUDGET`` entries, so exact at any corpus size; rows
    at or past ``n_valid`` are sliced off first; below ``_WINDOWED_MIN_Q``
    queries within one chunk, one product and one exact top-k instead (the
    same lists, faster there). ``approx``: scores at the
    corpus dtype, one score matrix while ``N <= max(block, k)`` or ``Q·N``
    is at most 512M entries (:func:`mips_topk_dense`), else streamed in
    blocks of ``block_size`` rows (:func:`_scan_topk`); rows at or past
    ``n_valid`` score -inf. ``canonical``: the exact lists in
    (value desc, index asc) order (:func:`canonical_tie_order`), as JAX
    applies it."""
    q = queries.shape[0]
    n = item_embs.shape[0]
    if n_valid is not None and not (0 < n_valid <= n):
        raise ValueError(f"n_valid={n_valid} out of range for N={n}")
    if k > (n if n_valid is None else n_valid):
        raise ValueError(f"k={k} exceeds corpus size {n_valid or n}")
    if mode == "exact":
        if n_valid is not None and n_valid < n:
            item_embs = item_embs[:n_valid]
        if q < _WINDOWED_MIN_Q and len(exact_score_blocks(q, item_embs.shape[0])) == 1:
            # few queries within one chunk: one product and one top-k; the
            # window-max pruning's extra launches cost more than they save
            # below 32 queries over 1M rows (tools/exact_topk_ab.py)
            vals, idx = fast_topk(score_matrix(queries.float(), item_embs, _EXACT), k)
        else:
            vals, idx = _exact_topk(queries, item_embs, k)
        return canonical_tie_order(vals, idx) if canonical else (vals, idx)
    if mode != "approx":
        raise ValueError(f"unknown mips_topk mode {mode!r} (exact | approx)")
    bs = min(block_size, n)
    if n <= max(bs, k) or q * n <= _APPROX_DENSE_LIMIT:
        return mips_topk_dense(queries, item_embs, k, 0.95, n_valid)
    return _scan_topk(queries, item_embs, k, bs, 0.95, "default", n_valid)


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


# --- the certified-exact engines (ops/topk.py:61-755) ----------------------- #

_EXACT = "highest"                 # JAX's precision=HIGHEST: full f32
_REDUCE_CHUNK = 16384              # JAX's exact-reduce chunk (:134)
_WINDOW = 64                       # items per window of the window-max scheme
_SCORE_BUDGET = 320 * 1024 * 1024  # max Q·N f32 score entries per column chunk
_WINDOWED_MIN_Q = 32               # exact mode's fewest queries for _exact_topk
_DENSE_LIMIT = 256 * 1024 * 1024   # _verified_topk scores densely up to Q·N (:325)
_APPROX_DENSE_LIMIT = 512 * 1024 * 1024  # mips_topk's approx mode streams past Q·N (:605)
# the error bound of the bound method's bf16-input pass (:348-354)
_BOUND_C = 1.25 * 2.0 ** -7

# Certificate failures that escalated to the exact path, by method.
ESCALATIONS = {"count": 0, "bound": 0}

_NEG_INF = float("-inf")


def _pad_cols_to(scores: torch.Tensor, width: int) -> torch.Tensor:
    """``scores`` with -inf columns appended up to ``width``."""
    pad = width - scores.shape[1]
    return F.pad(scores, (0, pad), value=_NEG_INF) if pad else scores


def _merge(vals, idxs, cand_v, cand_i, k: int, reduce=fast_topk):
    """The running top-k merged with a block's candidates."""
    v = torch.cat([vals, cand_v], dim=1)
    i = torch.cat([idxs, cand_i], dim=1)
    mv, sel = reduce(v, k)
    return mv, torch.gather(i, 1, sel)


def _init_topk(q: int, k: int, device):
    return (torch.full((q, k), _NEG_INF, device=device),
            torch.zeros((q, k), dtype=torch.int64, device=device))


def mips_topk_dense(queries: torch.Tensor, item_embs: torch.Tensor, k: int,
                    recall_target: float = 1.0, n_valid: Optional[int] = None):
    """One score matrix and one reduce (``mips_topk_dense``, ``:61``):
    full f32 and the chunked exact reduce at ``recall_target`` 1, else
    "default" precision (the exact top-k of those scores, C.4). ``n_valid``
    masks a padded tail."""
    exact = recall_target >= 1.0
    scores = score_matrix(queries, item_embs, _EXACT if exact else "default")
    if n_valid is not None and n_valid < scores.shape[1]:
        scores[:, n_valid:] = _NEG_INF
    if exact:
        return _chunked_exact_reduce(scores, k)
    return fast_topk(scores, k)


def _scan_topk(queries: torch.Tensor, item_embs: torch.Tensor, k: int,
               block_size: int, recall_target: float, precision: str = "default",
               n_valid: Optional[int] = None):
    """Blocked top-k (``_scan_topk``, ``:85``): each block's top
    ``min(k, block)`` merged into a running top-k, the (Q, N) scores never
    whole. Rows at or past ``n_valid`` score -inf. ``recall_target`` is
    JAX's prefilter knob; every reduce here is exact (C.4)."""
    n = item_embs.shape[0]
    n_valid = n if n_valid is None else n_valid
    bs = min(block_size, n)
    queries = queries.float()
    vals, idxs = _init_topk(queries.shape[0], k, queries.device)
    for start in range(0, n, bs):
        scores = _pad_cols_to(
            score_matrix(queries, item_embs[start:start + bs], precision), bs)
        scores[:, max(0, n_valid - start):] = _NEG_INF
        bv, bsel = fast_topk(scores, min(k, bs))
        vals, idxs = _merge(vals, idxs, bv, bsel + start, k)
    return vals, idxs


def _chunked_exact_reduce(scores: torch.Tensor, k: int):
    """Exact top-k along the last axis in ≤ 16k-wide chunks, the chunk
    winners merged recursively (``_chunked_exact_reduce``, ``:159``). The
    TPU needs the chunks; ``torch.topk`` does not, but the structure is
    kept so each branch is JAX's (ties compare through
    ``canonical_tie_order``, C.6)."""
    q, w = scores.shape
    if w <= _REDUCE_CHUNK:
        return fast_topk(scores, k)
    nc = -(-w // _REDUCE_CHUNK)
    scores = _pad_cols_to(scores, nc * _REDUCE_CHUNK)
    cv, ci = fast_topk(scores.view(q, nc, _REDUCE_CHUNK), min(k, _REDUCE_CHUNK))
    base = (torch.arange(nc, device=scores.device) * _REDUCE_CHUNK)[None, :, None]
    gi = (ci + base).reshape(q, -1)
    mv, ms = _chunked_exact_reduce(cv.reshape(q, -1), k)
    return mv, torch.gather(gi, 1, ms)


def _windowed_exact_topk(scores: torch.Tensor, k: int):
    """Exact top-k of a wide score matrix by window-max pruning
    (``_windowed_exact_topk``, ``:179``): the row in windows of 64 columns,
    the top ``wpad`` ≥ k windows by their maxima hold the whole top-k, and
    only their scores are reduced. With at most 4·wpad windows it reduces
    the row directly."""
    q, w = scores.shape
    L = _WINDOW
    wpad = max(512, -(-(k + 1) // 128) * 128)
    n_win = -(-w // L)
    if n_win <= 4 * wpad:
        return _chunked_exact_reduce(scores, k)
    blocks = _pad_cols_to(scores, n_win * L).view(q, n_win, L)
    _, widx = _chunked_exact_reduce(blocks.amax(dim=2), wpad)
    slab = torch.gather(blocks, 1, widx[:, :, None].expand(-1, -1, L))
    mv, ms = _chunked_exact_reduce(slab.reshape(q, wpad * L), k)
    win = torch.gather(widx, 1, ms // L)
    return mv, win * L + ms % L


def _score_chunk(q: int) -> int:
    """Columns of one score chunk: ``_SCORE_BUDGET`` entries over Q rows,
    a multiple of ``_REDUCE_CHUNK``."""
    return max(_REDUCE_CHUNK, (_SCORE_BUDGET // q) // _REDUCE_CHUNK * _REDUCE_CHUNK)


def exact_score_blocks(q: int, n: int):
    """[(start, stop), ...]: the column blocks in which exact mode
    (:func:`mips_topk`, :func:`_exact_topk`) scores ``q`` queries over ``n``
    rows, one product a block — the whole corpus where it fits one chunk,
    or below ``_WINDOWED_MIN_Q`` queries where ``q · n`` fits
    ``_SCORE_BUDGET``; else ``_score_chunk(q)`` columns at a time, the last
    block short. The one statement of exact mode's blocking."""
    chunk = _score_chunk(q)
    if (q < _WINDOWED_MIN_Q and q * n <= _SCORE_BUDGET) or n <= chunk:
        return [(0, n)]
    return [(s, min(n, s + chunk)) for s in range(0, n, chunk)]


def exact_scores(queries: torch.Tensor, item_embs: torch.Tensor) -> torch.Tensor:
    """(Q, N) full-f32 scores made of the very products exact mode takes
    (:func:`exact_score_blocks`), so each entry is bit-equal to the score
    :func:`mips_topk` ranks it by on the same device and operands. A
    reference, not a search: the (Q, N) matrix is whole."""
    queries = queries.float()
    return torch.cat([score_matrix(queries, item_embs[s:e], _EXACT)
                      for s, e in exact_score_blocks(queries.shape[0],
                                                     item_embs.shape[0])], dim=1)


def _exact_topk(queries: torch.Tensor, item_embs: torch.Tensor, k: int):
    """Exact top-k at any corpus size (``_exact_topk``, ``:226``): full-f32
    scores in the column blocks of :func:`exact_score_blocks`, each reduced
    by the windowed path and merged; where there are several, each is
    padded with -inf to the first's width, as JAX pads its chunks."""
    queries = queries.float()
    blocks = exact_score_blocks(queries.shape[0], item_embs.shape[0])
    if len(blocks) == 1:
        return _windowed_exact_topk(score_matrix(queries, item_embs, _EXACT), k)
    chunk = blocks[0][1]
    vals, idxs = _init_topk(queries.shape[0], k, queries.device)
    for start, stop in blocks:
        scores = _pad_cols_to(
            score_matrix(queries, item_embs[start:stop], _EXACT), chunk)
        bv, bi = _windowed_exact_topk(scores, min(k, chunk))
        del scores      # one chunk's scores live at a time
        vals, idxs = _merge(vals, idxs, bv, bi + start, k, _chunked_exact_reduce)
    return vals, idxs


def _count_above(queries: torch.Tensor, item_embs: torch.Tensor,
                 tau: torch.Tensor, block_size: int, dense: bool) -> torch.Tensor:
    """(Q,) count of corpus rows scoring strictly above ``tau`` in full
    f32 (``_count_above``, ``:262``): one score matrix, or blocks of
    ``block_size`` rows."""
    queries = queries.float()
    if dense:
        return (score_matrix(queries, item_embs, _EXACT) > tau[:, None]).sum(dim=1)
    bs = min(block_size, item_embs.shape[0])
    count = torch.zeros(queries.shape[0], dtype=torch.int64, device=queries.device)
    for start in range(0, item_embs.shape[0], bs):
        scores = score_matrix(queries, item_embs[start:start + bs], _EXACT)
        count += (scores > tau[:, None]).sum(dim=1)
    return count


def _verified_topk(queries: torch.Tensor, item_embs: torch.Tensor, k: int,
                   block_size: int, oversample: int = 4,
                   recall_target: float = 0.95):
    """Two passes and a certificate (``_verified_topk``, ``:300``): pass A
    keeps m = oversample·k candidates, pass B counts the rows above the k-th
    candidate's score. Both in full f32, so a candidate's two scores agree.
    Up to ``_DENSE_LIMIT`` score entries one matrix serves both; past it,
    blocks. → (values (Q, k), positions (Q, k), exact (Q,) bool)."""
    q, n = queries.shape[0], item_embs.shape[0]
    m = min(n, max(k + 1, oversample * k))
    if q * n <= _DENSE_LIMIT:
        scores = score_matrix(queries.float(), item_embs, _EXACT)
        vals_m, idx_m = fast_topk(scores, m)
        count = (scores > vals_m[:, k - 1, None]).sum(dim=1)
    else:
        # blocks at least 4x the candidates keep the prefilter reduce-bound
        bs_a = min(n, max(block_size, 4 * m))
        vals_m, idx_m = _scan_topk(queries, item_embs, m, bs_a, recall_target,
                                   precision=_EXACT)
        count = _count_above(queries, item_embs, vals_m[:, k - 1], block_size,
                             dense=False)
    exact = certify_topk(vals_m, count, k)
    return vals_m[:, :k], idx_m[:, :k], exact


def _bf16_input_scores(q_bf: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32 scores of bf16-rounded queries (f32 holding bf16 values)
    and rows rounded to bf16 here, with f32 accumulation. The operands are
    exact in TF32, so the card's TF32 products are exact; a bf16 matmul
    would round the scores to bf16 and break ``_BOUND_C``."""
    with _tf32(True):
        return q_bf @ items.to(torch.bfloat16).float().T


def _bound_verified_topk(queries: torch.Tensor, item_embs: torch.Tensor,
                         k: int, m: int):
    """One bf16-input pass, an exact rescore of its top m and a rounding-
    error certificate (``_bound_verified_topk``, ``:357``): every row
    outside the candidates scores at most θ + ε in f32, θ the m-th bf16
    score and ε = ``_BOUND_C``·‖q‖·max‖c‖; the top-k of the rescored
    candidates is exact where θ + ε ≤ their k-th score.
    → (values (Q, k), positions (Q, k), exact (Q,) bool)."""
    q, n = queries.shape[0], item_embs.shape[0]
    queries = queries.float()
    q_bf = queries.to(torch.bfloat16).float()
    chunk = _score_chunk(q)
    if n <= chunk:
        items_bf = item_embs.to(torch.bfloat16).float()
        pv, pi = _windowed_exact_topk(_bf16_input_scores(q_bf, items_bf), m)
        max_sq = (items_bf * items_bf).sum(dim=1).max()
    else:
        pv, pi = _init_topk(q, m, queries.device)
        max_sq = torch.zeros((), device=queries.device)
        for start in range(0, n, chunk):
            block_bf = item_embs[start:start + chunk].to(torch.bfloat16).float()
            scores = _pad_cols_to(_bf16_input_scores(q_bf, block_bf), chunk)
            bv, bi = _windowed_exact_topk(scores, min(m, chunk))
            pv, pi = _merge(pv, pi, bv, bi + start, m, _chunked_exact_reduce)
            max_sq = torch.maximum(max_sq, (block_bf * block_bf).sum(dim=1).max())
    theta = pv[:, m - 1]
    eps = _BOUND_C * torch.sqrt((q_bf * q_bf).sum(dim=1)) * torch.sqrt(max_sq)
    cand = item_embs[pi].float()                                   # (Q, m, D)
    with full_f32_matmul():
        true = torch.bmm(cand, queries[:, :, None])[..., 0]
    tv, tsel = fast_topk(true, k)
    return tv, torch.gather(pi, 1, tsel), theta + eps <= tv[:, k - 1]


def mips_topk_bound_verified(queries: torch.Tensor, item_embs: torch.Tensor,
                             k: int, m: int = 2048):
    """:func:`_bound_verified_topk` with its per-query certificate
    (``mips_topk_bound_verified``, ``:441``)."""
    return _bound_verified_topk(queries, item_embs, k, m)


def certify_topk(cand_vals: torch.Tensor, count_above: torch.Tensor,
                 k: int) -> torch.Tensor:
    """(Q,) bool: the candidate top-k is value-exact iff the global count of
    rows strictly above τ = ``cand_vals[:, k-1]`` equals the count inside
    the candidate top-k (``certify_topk``, ``:452``). Rows tied at τ cannot
    change the top-k values."""
    tau = cand_vals[:, k - 1]
    in_cand = (cand_vals[:, :k] > tau[:, None]).sum(dim=1)
    return count_above.to(torch.int64) == in_cand


def mips_topk_verified(queries: torch.Tensor, item_embs: torch.Tensor, k: int,
                       block_size: int = 4096, oversample: int = 4,
                       recall_target: float = 0.95):
    """:func:`_verified_topk` with its per-query certificate
    (``mips_topk_verified``, ``:469``)."""
    return _verified_topk(queries, item_embs, k, block_size, oversample,
                          recall_target)


def mips_topk_certified(queries: torch.Tensor, item_embs: torch.Tensor, k: int,
                        block_size: int = 4096, oversample: int = 4,
                        recall_target: float = 0.95, method: str = "count",
                        canonical: bool = False):
    """Certified-exact top-k (``mips_topk_certified``, ``:484``) → (values
    (Q, k), positions (Q, k)): the ``count`` or ``bound`` engine, and the
    exact path for the whole batch where any query's certificate fails.
    Values are certified; ids tied at the k-th value may differ from the
    exact path's (``canonical`` orders ties as :func:`canonical_tie_order`).

    JAX escalates inside one program (``lax.cond``) with no host round
    trip. Here the choice reads the certificates on the host: one sync a
    call. Each escalation adds one to ``ESCALATIONS[method]``."""
    n = item_embs.shape[0]
    if method == "bound":
        m = max(k + 512, oversample * k)
        if m >= n:
            vals, idx = _exact_topk(queries, item_embs, k)
            return canonical_tie_order(vals, idx) if canonical else (vals, idx)
        vals, idx, exact = _bound_verified_topk(queries, item_embs, k, m)
    elif method == "count":
        vals, idx, exact = _verified_topk(queries, item_embs, k, block_size,
                                          oversample, recall_target)
    else:
        raise ValueError(f"unknown certified method {method!r}")
    if not bool(exact.all()):
        count_launch(ESCALATIONS, method)
        vals, idx = _exact_topk(queries, item_embs, k)
    return canonical_tie_order(vals, idx) if canonical else (vals, idx)


def mips_topk_numpy(queries, item_embs, k: int):
    """Host numpy reference (``mips_topk_numpy``, ``:746``): f64 scores,
    a stable sort (ties index-ascending) → (f32 values, int32 ids)."""
    scores = np.asarray(queries, np.float64) @ np.asarray(item_embs, np.float64).T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, idx, axis=1)
    return vals.astype(np.float32), idx.astype(np.int32)
