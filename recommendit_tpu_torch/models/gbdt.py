"""Histogram GBDT with a LambdaRank objective — torch port.

Counterpart of ``recommendit_tpu/models/gbdt.py`` (``HistGBDTRanker``):
quantile-binned features (≤256 bins), level-wise tree growth on histogram
split finding, LambdaRank gradients and hessians over packed query groups,
shrinkage, row and feature subsampling, early stopping on validation
NDCG@10, and the fixed-depth device descent the fused serve path scores
candidates with. The ``.npz`` + ``.meta.json`` files are the JAX
package's: each package reads the other's.

The numpy half (:func:`lambdarank_grad_hess`, :func:`pack_group_indices`,
:func:`_grow_tree`, :func:`_tree_from_levels`, ``_bin``, ``_group``,
``_ndcg10``, ``_predict_tree``, ``predict``, the importances, ``save`` and
``load``) is a copy, identical in arithmetic. The JAX module's device code
is XLA, not Pallas, so its counterparts here are plain torch:

* :func:`group_grad_hess` — the jitted vmap of one group's gradient, as one
  batched function over (n_groups, G); each group's ranks come from a
  stable argsort, as ``jnp.argsort`` is stable (ROADMAP C.43).
* :func:`_make_grow_tree_device` — the level-wise grower, one
  ``index_add_`` over (feature, node, bin) segments per level where JAX
  maps a ``segment_sum`` over the features. On the CPU the adds run in row
  order; on the card they are atomics in no fixed order, so two runs there
  may differ in the last bits of a sum (C.22).
* the subsample masks of the device backend replay JAX's ``jax.random``
  stream bit for bit (``ops/quantize.py``: ``threefry_split``,
  ``threefry_bernoulli``; C.45), so both packages sample the same rows.

Bins (C.44): the host ``_bin`` (``np.searchsorted``) puts NaN in the last
bin; the device scorer counts the edges below a value, so NaN goes to bin 0,
as JAX's ``sum(x > edges)`` does. Each path keeps its own rule.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.models.ranker import feature_matrix
from recommendit_tpu_torch.ops.quantize import (
    prng_key,
    threefry_bernoulli,
    threefry_split,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

logger = logging.getLogger(__name__)

DEFAULT_LABEL_GAIN = (0.0, 1.0, 3.0, 7.0, 15.0)
GROUP_SIZE = 64          # rows of a packed group (gbdt.py:504)
GRAD_SLICE_GROUPS = 8192  # groups whose (G, G) pairs are live at once
AUTO_DEVICE_CELLS = 2_000_000   # rows x features from which "auto" grows on the card
SCORE_CHUNK_PAIRS = 1 << 25     # (row, tree) pairs of one descent chunk


# ------------------------------------------------------------------ #
# LambdaRank gradients                                                 #
# ------------------------------------------------------------------ #

def lambdarank_grad_hess(
    scores: np.ndarray,
    gains: np.ndarray,
    query_offsets: np.ndarray,
    sigma: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row gradient/hessian of the LambdaRank objective.

    Args:
        scores: (n,) current model scores.
        gains: (n,) graded gains (label_gain applied).
        query_offsets: (q+1,) row offsets of each query group (rows must be
            grouped contiguously by query).
    """
    n = len(scores)
    grad = np.zeros(n)
    hess = np.zeros(n)
    for s, e in zip(query_offsets[:-1], query_offsets[1:]):
        g = gains[s:e]
        if (g.max() - g.min()) <= 0:
            continue
        sc = scores[s:e]
        order = np.argsort(-sc)
        ranks = np.empty_like(order)
        ranks[order] = np.arange(1, len(sc) + 1)
        disc = 1.0 / np.log2(1.0 + ranks)
        ideal = np.sort(g)[::-1]
        idcg = (ideal / np.log2(2.0 + np.arange(len(g)))).sum()
        if idcg <= 0:
            continue

        gd = g[:, None] - g[None, :]
        pos_pair = gd > 0          # i more relevant than j
        sdiff = sc[:, None] - sc[None, :]
        rho = 1.0 / (1.0 + np.exp(np.clip(sigma * sdiff, -50, 50)))
        delta = np.abs(gd) * np.abs(disc[:, None] - disc[None, :]) / idcg
        lam = sigma * rho * delta * pos_pair
        h = sigma * sigma * rho * (1.0 - rho) * delta * pos_pair

        grad[s:e] += -(lam.sum(axis=1) - lam.sum(axis=0))
        hess[s:e] += h.sum(axis=1) + h.sum(axis=0)
    return grad, hess


def pack_group_indices(
    query_offsets: np.ndarray,
    group_size: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Row indices of each query packed into fixed (n_chunks, G) chunks
    (queries longer than G are shuffled and split — the same fixed-shape
    approximation as the MLP ranker's pack_groups)."""
    chunks, masks = [], []
    for s, e in zip(query_offsets[:-1], query_offsets[1:]):
        idx = np.arange(s, e)
        rng.shuffle(idx)
        for cs in range(0, len(idx), group_size):
            c = idx[cs: cs + group_size]
            row = np.zeros(group_size, np.int32)
            m = np.zeros(group_size, np.float32)
            row[: len(c)] = c
            m[: len(c)] = 1.0
            chunks.append(row)
            masks.append(m)
    return np.stack(chunks), np.stack(masks)


def _log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2``: log(x) / log(2), both in f32."""
    return torch.log(x) / torch.log(torch.tensor(2.0, device=x.device))


def group_grad_hess(s: torch.Tensor, g: torch.Tensor, m: torch.Tensor):
    """LambdaRank gradient and hessian of each packed group: (n_groups, G)
    f32 scores, gains (0 at padding) and masks → two (n_groups, G) f32
    arrays, the batched form of JAX's ``_make_grad_fn`` (gbdt.py:104-134).
    A padded slot scores −1e9 for the ranks and forms no pair."""
    gsz = s.shape[-1]
    dev = s.device
    valid = m > 0
    masked = torch.where(valid, s, torch.full_like(s, -1e9))
    order = torch.argsort(-masked, dim=-1, stable=True)
    positions = torch.arange(1, gsz + 1, dtype=torch.float32, device=dev)
    ranks = torch.empty_like(s).scatter_(-1, order, positions.expand_as(s).contiguous())
    disc = 1.0 / _log2(1.0 + ranks)
    sorted_gains = torch.sort(torch.where(valid, g, torch.zeros_like(g)),
                              dim=-1, descending=True).values
    ideal_disc = 1.0 / _log2(2.0 + torch.arange(gsz, dtype=torch.float32, device=dev))
    idcg = torch.clamp_min((sorted_gains * ideal_disc).sum(-1), np.float32(1e-9))

    gd = g[..., :, None] - g[..., None, :]
    pair = ((gd > 0) & valid[..., :, None] & valid[..., None, :]).to(torch.float32)
    sdiff = s[..., :, None] - s[..., None, :]
    rho = torch.sigmoid(-sdiff)
    delta = gd.abs() * (disc[..., :, None] - disc[..., None, :]).abs() / idcg[..., None, None]
    lam = rho * delta * pair
    h = rho * (1.0 - rho) * delta * pair
    grad = -(lam.sum(-1) - lam.sum(-2))
    hess = h.sum(-1) + h.sum(-2)
    return grad, hess


# ------------------------------------------------------------------ #
# Device (torch) tree growth — catalog-scale backend                   #
# ------------------------------------------------------------------ #

def _make_grow_tree_device(n_feat: int, n_bins: int, max_depth: int,
                           min_child: int, reg_lambda: float):
    """Level-wise histogram tree grower on the tensors' device
    (gbdt.py:141-265).

    At each depth the nodes are the implicit ids 0..2^d−1. One 1-D
    ``index_add_`` builds the (grad, hess, count) histogram of every
    (feature, node, bin) segment (a 2-D one takes a slow path per row on
    the CPU); the split search is vectorised. A split needs left/right
    counts ≥ ``min_child`` (counts of SAMPLED rows) and a strictly
    positive, finite gain; the leaf value is −G/(H+λ) over sampled rows;
    every row, sampled or not, is routed for the score update. A row whose
    node stopped splitting freezes with a STALE node id that collides with
    live ids deeper down, so its weight is zeroed before each histogram.

    Returns ``fn(binned_T, grad, hess, row_mask, feat_mask) -> (levels,
    row_value)``: ``binned_T`` the (F, n) uint8 bin matrix, ``levels`` a
    list of per-depth dicts of ``best_f``, ``best_b``, ``do_split``,
    ``gain``, ``leaf_value`` tensors of shape (2^d,), ``row_value`` (n,)
    each row's leaf value.
    """
    n_seg_bins = n_bins - 1

    def grow(binned_t, grad, hess, row_mask, feat_mask):
        dev = grad.device
        n = grad.shape[0]
        rows = torch.arange(n, device=dev)
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        frozen = torch.zeros(n, dtype=torch.bool, device=dev)
        row_value = torch.zeros(n, dtype=torch.float32, device=dev)
        ghc = torch.stack([grad * row_mask, hess * row_mask, row_mask])   # (3, n)
        bins = binned_t.to(torch.int32)
        feat_ids = torch.arange(n_feat, dtype=torch.int32, device=dev)[:, None]
        part_ids = torch.arange(3, dtype=torch.int32, device=dev)[:, None, None]
        levels = []
        alive = torch.ones(1, dtype=torch.bool, device=dev)
        for depth in range(max_depth + 1):
            n_nodes = 1 << depth
            n_seg = n_feat * n_nodes * n_bins
            ghc_level = ghc * (~frozen).to(torch.float32)
            # one 1-D index_add_ over (part, feature, node, bin) segments,
            # each summed in row order on the CPU
            seg = bins + (node.to(torch.int32) * n_bins)[None, :] \
                + feat_ids * (n_nodes * n_bins)
            hist = torch.zeros(3 * n_seg, dtype=torch.float32, device=dev)
            hist.index_add_(0, (seg[None] + part_ids * n_seg).reshape(-1),
                            ghc_level[:, None, :].expand(3, n_feat, n).reshape(-1))
            hg, hh, hc = hist.reshape(3, n_feat, n_nodes, n_bins)
            gt = hg.sum(-1)                         # (F, nodes) — same ∀F
            ht = hh.sum(-1)
            node_g, node_h = gt[0], ht[0]
            leaf_value = -node_g / (node_h + reg_lambda)

            if depth == max_depth:
                row_value = torch.where(frozen, row_value, leaf_value[node])
                levels.append({
                    "best_f": torch.full((n_nodes,), -1, dtype=torch.int32, device=dev),
                    "best_b": torch.zeros(n_nodes, dtype=torch.int32, device=dev),
                    "do_split": torch.zeros(n_nodes, dtype=torch.bool, device=dev),
                    "gain": torch.zeros(n_nodes, dtype=torch.float32, device=dev),
                    "leaf_value": torch.where(alive, leaf_value,
                                              torch.zeros_like(leaf_value)),
                })
                break

            gl = torch.cumsum(hg, dim=-1)[..., :-1]
            hl = torch.cumsum(hh, dim=-1)[..., :-1]
            cl = torch.cumsum(hc, dim=-1)[..., :-1]
            gr_ = gt[..., None] - gl
            hr_ = ht[..., None] - hl
            cr_ = hc.sum(-1)[..., None] - cl
            parent = node_g ** 2 / (node_h + reg_lambda)   # (nodes,)
            gain = (gl ** 2 / (hl + reg_lambda) + gr_ ** 2 / (hr_ + reg_lambda)
                    - parent[None, :, None])              # (F, nodes, bins-1)
            ok = (cl >= min_child) & (cr_ >= min_child) & feat_mask[:, None, None]
            gain = torch.where(ok, gain, torch.full_like(gain, -torch.inf))
            flat = gain.permute(1, 0, 2).reshape(n_nodes, -1)
            best = torch.argmax(flat, dim=1)
            best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
            best_f = torch.div(best, n_seg_bins, rounding_mode="floor")
            best_b = best % n_seg_bins
            do_split = alive & (best_gain > 0.0) & torch.isfinite(best_gain)

            # rows in alive non-splitting nodes freeze with this leaf value
            newly_leaf = alive & ~do_split
            row_value = torch.where(~frozen & newly_leaf[node], leaf_value[node],
                                    row_value)
            frozen = frozen | newly_leaf[node]

            levels.append({
                "best_f": torch.where(do_split, best_f, -1).to(torch.int32),
                "best_b": torch.where(do_split, best_b, 0).to(torch.int32),
                "do_split": do_split,
                "gain": torch.where(do_split, best_gain, torch.zeros_like(best_gain)),
                "leaf_value": torch.where(newly_leaf, leaf_value,
                                          torch.zeros_like(leaf_value)),
            })

            # route every row (sampled or not) through its node's split
            bin_of_row = binned_t[best_f[node], rows].to(torch.int64)
            go_right = bin_of_row > best_b[node]
            stepped = 2 * node + go_right.to(torch.int64)
            node = torch.where(~frozen & do_split[node], stepped, node)
            # frozen rows keep their node id but alive tracking moves on
            alive = torch.repeat_interleave(do_split, 2)
        return levels, row_value

    return grow


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tree_from_levels(levels, max_depth: int) -> "_Tree":
    """Convert the device grower's per-level arrays into a `_Tree`
    (host-side, arrays are tiny). Node ids are allocated depth-first to
    mirror the numpy grower's layout."""
    max_nodes = 2 ** (max_depth + 1)
    tree = _Tree(max_nodes)
    lv = [
        {k: _host(v) for k, v in level.items()} for level in levels
    ]
    next_free = [1]

    def emit(depth: int, pos: int, node_id: int):
        L = lv[depth]
        if depth < len(lv) - 1 and L["do_split"][pos]:
            li, ri = next_free[0], next_free[0] + 1
            next_free[0] += 2
            tree.feature[node_id] = L["best_f"][pos]
            tree.bin_threshold[node_id] = L["best_b"][pos]
            tree.gain[node_id] = L["gain"][pos]
            tree.left[node_id] = li
            tree.right[node_id] = ri
            emit(depth + 1, 2 * pos, li)
            emit(depth + 1, 2 * pos + 1, ri)
        else:
            tree.value[node_id] = L["leaf_value"][pos]

    emit(0, 0, 0)
    return tree


# ------------------------------------------------------------------ #
# Histogram tree growth                                                #
# ------------------------------------------------------------------ #

class _Tree:
    __slots__ = ("feature", "bin_threshold", "left", "right", "value", "gain")

    def __init__(self, max_nodes: int):
        self.feature = np.full(max_nodes, -1, np.int32)
        self.bin_threshold = np.zeros(max_nodes, np.int32)
        self.left = np.zeros(max_nodes, np.int32)
        self.right = np.zeros(max_nodes, np.int32)
        self.value = np.zeros(max_nodes, np.float32)
        self.gain = np.zeros(max_nodes, np.float32)


def _grow_tree(
    binned: np.ndarray,        # (n, f) uint8
    grad: np.ndarray,
    hess: np.ndarray,
    rows: np.ndarray,
    n_bins: int,
    max_depth: int,
    min_child: int,
    reg_lambda: float,
    feature_idx: np.ndarray,
) -> _Tree:
    max_nodes = 2 ** (max_depth + 1)
    tree = _Tree(max_nodes)
    next_free = [1]

    def leaf_value(r):
        return -grad[r].sum() / (hess[r].sum() + reg_lambda)

    def split_node(node_id: int, r: np.ndarray, depth: int):
        if depth >= max_depth or len(r) < 2 * min_child:
            tree.value[node_id] = leaf_value(r)
            return
        g, h = grad[r], hess[r]
        parent_score = (g.sum() ** 2) / (h.sum() + reg_lambda)
        best_gain, best_f, best_b = 0.0, -1, -1
        for f in feature_idx:
            b = binned[r, f]
            gh = np.bincount(b, weights=g, minlength=n_bins)
            hh = np.bincount(b, weights=h, minlength=n_bins)
            cnt = np.bincount(b, minlength=n_bins)
            gl, hl, cl = np.cumsum(gh)[:-1], np.cumsum(hh)[:-1], np.cumsum(cnt)[:-1]
            gr_, hr_, cr_ = g.sum() - gl, h.sum() - hl, len(r) - cl
            valid = (cl >= min_child) & (cr_ >= min_child)
            if not valid.any():
                continue
            gain = (
                gl**2 / (hl + reg_lambda) + gr_**2 / (hr_ + reg_lambda)
                - parent_score
            )
            gain = np.where(valid, gain, -np.inf)
            bi = int(np.argmax(gain))
            if gain[bi] > best_gain:
                best_gain, best_f, best_b = float(gain[bi]), int(f), bi
        if best_f < 0:
            tree.value[node_id] = leaf_value(r)
            return
        mask = binned[r, best_f] <= best_b
        li, ri = next_free[0], next_free[0] + 1
        next_free[0] += 2
        tree.feature[node_id] = best_f
        tree.bin_threshold[node_id] = best_b
        tree.gain[node_id] = best_gain
        tree.left[node_id] = li
        tree.right[node_id] = ri
        split_node(li, r[mask], depth + 1)
        split_node(ri, r[~mask], depth + 1)

    split_node(0, rows, 0)
    return tree


# ------------------------------------------------------------------ #
# Booster                                                              #
# ------------------------------------------------------------------ #

class HistGBDTRanker:
    """Histogram GBDT trained with LambdaRank (LightGBM-LambdaMART
    semantics: num_leaves→max_depth, label_gain, subsample/colsample,
    reg_lambda, early stopping). Frames are column dicts
    (``features/schema.py``)."""

    def __init__(
        self,
        n_estimators: int = 200,
        learning_rate: float = 0.1,
        max_depth: int = 6,
        n_bins: int = 64,
        min_child_samples: int = 20,
        subsample: float = 0.8,
        colsample: float = 0.8,
        reg_lambda: float = 0.1,
        label_gain: Sequence[float] = DEFAULT_LABEL_GAIN,
        early_stop_rounds: int = 30,
        seed: int = 0,
        backend: str = "auto",
        device=DEFAULT_DEVICE,
    ):
        """``backend``: 'numpy' (host bincount grower), 'device' (the torch
        grower on ``device`` — the catalog-scale path), or 'auto' (device
        when ``device`` is a GPU and rows x features >= 2M, else numpy).
        The gradients are computed on ``device`` by both backends."""
        if backend not in ("auto", "numpy", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        if not 2 <= n_bins <= 256:
            raise ValueError(f"n_bins={n_bins}: bins are uint8, 2..256")
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.colsample = colsample
        self.reg_lambda = reg_lambda
        self.label_gain = tuple(label_gain)
        self.early_stop_rounds = early_stop_rounds
        self.seed = seed
        self.backend = backend
        self.device = resolve_device(device)

        self.feature_names: Optional[List[str]] = None
        self.bin_edges: Optional[np.ndarray] = None   # (f, n_bins-1)
        self.trees: List[_Tree] = []
        self.best_iteration = 0
        self.backend_used: Optional[str] = None
        self.evals_result: Dict[str, List[float]] = {}
        self._trained = False

    @property
    def n_features(self) -> int:
        return len(self.feature_names) if self.feature_names else 0

    # ------------------------------------------------------------------ #

    def _bin(self, X: np.ndarray, fit: bool) -> np.ndarray:
        if fit:
            qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
            self.bin_edges = np.quantile(X, qs, axis=0).T.astype(np.float32)
        out = np.empty(X.shape, np.uint8)
        for f in range(X.shape[1]):
            out[:, f] = np.searchsorted(self.bin_edges[f], X[:, f])
        return out

    @staticmethod
    def _group(query_ids: np.ndarray):
        order = np.argsort(query_ids, kind="stable")
        q = query_ids[order]
        offs = np.concatenate([[0], np.nonzero(np.diff(q))[0] + 1, [len(q)]])
        return order, offs.astype(np.int64)

    def _ndcg10(self, scores, gains, offsets) -> float:
        total, cnt = 0.0, 0
        for s, e in zip(offsets[:-1], offsets[1:]):
            g = gains[s:e]
            if g.max() <= 0:
                continue
            order = np.argsort(-scores[s:e])[:10]
            disc = 1.0 / np.log2(2.0 + np.arange(len(order)))
            dcg = (g[order] * disc).sum()
            ideal = np.sort(g)[::-1][:10]
            idcg = (ideal * disc[: len(ideal)]).sum()
            if idcg > 0:
                total += dcg / idcg
                cnt += 1
        return total / max(cnt, 1)

    # ------------------------------------------------------------------ #

    def train(
        self,
        train_df,
        feature_cols: List[str],
        label_col: str = "label",
        query_col: str = "query_id",
        valid_df=None,
        verbose_eval: int = 50,
    ) -> Dict[str, List[float]]:
        """Boost on the column dict ``train_df``; early-stops on the valid
        frame's NDCG@10 when one is given. Returns (and keeps as
        ``evals_result``) the per-round validation NDCG@10 and the final
        train NDCG@10."""
        self.feature_names = list(feature_cols)
        gain_table = np.asarray(self.label_gain, np.float64)
        dev = self.device

        def prep(frame):
            X = feature_matrix(frame, feature_cols)
            y = np.clip(np.asarray(frame[label_col]).astype(np.int64), 0,
                        len(gain_table) - 1)
            q = np.asarray(frame[query_col])
            order, offs = self._group(q)
            return X[order], gain_table[y[order]], offs

        X, gains, offsets = prep(train_df)
        binned = self._bin(X, fit=True)
        n, f = binned.shape
        scores = np.zeros(n)

        valid = None
        if valid_df is not None:
            Xv, gv, ov = prep(valid_df)
            valid = (self._bin(Xv, fit=False), gv, ov, np.zeros(len(Xv)))

        rng = np.random.default_rng(self.seed)
        evals = {"train_ndcg@10": [], "valid_ndcg@10": []}
        self.evals_result = evals
        best_metric, patience = -np.inf, 0
        logger.info(
            "HistGBDT: %d rows, %d features, %d queries",
            n, f, len(offsets) - 1,
        )

        # gradients over fixed-size packed groups, on the device
        chunk_idx, chunk_mask = pack_group_indices(offsets, GROUP_SIZE, rng)
        chunk_idx_d = torch.as_tensor(chunk_idx.astype(np.int64), device=dev)
        chunk_gains_d = torch.as_tensor(
            (gains[chunk_idx] * chunk_mask).astype(np.float32), device=dev)
        chunk_mask_d = torch.as_tensor(chunk_mask, device=dev)

        def compute_grad_hess(scores_np):
            s = torch.as_tensor(scores_np.astype(np.float32), device=dev)[chunk_idx_d]
            gch, hch = group_grad_hess(s, chunk_gains_d, chunk_mask_d)
            grad = np.zeros(n, np.float64)
            hess = np.zeros(n, np.float64)
            flat = chunk_idx.ravel()
            mask = chunk_mask.ravel() > 0
            grad[flat[mask]] = gch.cpu().numpy().ravel()[mask]
            hess[flat[mask]] = hch.cpu().numpy().ravel()[mask]
            return grad, hess

        if self.backend == "auto":
            # the device grower on the card; on the CPU numpy bincount
            use_device = dev.type != "cpu" and n * f >= AUTO_DEVICE_CELLS
        else:
            use_device = self.backend == "device"
        self.backend_used = "device" if use_device else "numpy"
        if use_device:
            return self._train_device(
                binned, gains, offsets, n, f, rng, valid, evals,
                chunk_idx_d, chunk_gains_d, chunk_mask_d, verbose_eval,
            )

        for it in range(1, self.n_estimators + 1):
            grad, hess = compute_grad_hess(scores)
            rows = np.arange(n)
            if self.subsample < 1.0:
                rows = rng.choice(n, size=int(n * self.subsample),
                                  replace=False)
            feats = np.arange(f)
            if self.colsample < 1.0:
                feats = rng.choice(f, size=max(1, int(f * self.colsample)),
                                   replace=False)
            tree = _grow_tree(
                binned, grad, hess, rows, self.n_bins, self.max_depth,
                self.min_child_samples, self.reg_lambda, feats,
            )
            self.trees.append(tree)
            scores += self.learning_rate * self._predict_tree(tree, binned)

            if valid is not None:
                vb, gv, ov, vscores = valid
                vscores += self.learning_rate * self._predict_tree(tree, vb)
                valid = (vb, gv, ov, vscores)
                m = self._ndcg10(vscores, gv, ov)
                evals["valid_ndcg@10"].append(m)
                if it % verbose_eval == 0:
                    logger.info("iter %d | valid ndcg@10 %.4f", it, m)
                if m > best_metric + 1e-6:
                    best_metric, patience = m, 0
                    self.best_iteration = it
                else:
                    patience += 1
                    if patience >= self.early_stop_rounds:
                        logger.info("Early stop at iter %d (best %d)",
                                    it, self.best_iteration)
                        self.trees = self.trees[: self.best_iteration]
                        break
            else:
                self.best_iteration = it

        self._trained = True
        evals["train_ndcg@10"].append(self._ndcg10(scores, gains, offsets))
        return evals

    def _round_grad(self, scores_d, chunk_idx_d, chunk_gains_d, chunk_mask_d):
        """Every row's gradient and hessian (f32, on the device) from the
        packed groups, computed a slice of ``GRAD_SLICE_GROUPS`` groups at
        a time: a single batch over all groups would hold (n_groups, G, G)
        pairwise intermediates (~12 GB at 6.5M rows)."""
        n = scores_d.shape[0]
        g = torch.zeros(n, dtype=torch.float32, device=scores_d.device)
        h = torch.zeros_like(g)
        for lo in range(0, chunk_idx_d.shape[0], GRAD_SLICE_GROUPS):
            idx = chunk_idx_d[lo:lo + GRAD_SLICE_GROUPS]
            mask = chunk_mask_d[lo:lo + GRAD_SLICE_GROUPS]
            gch, hch = group_grad_hess(scores_d[idx], chunk_gains_d[lo:lo + GRAD_SLICE_GROUPS],
                                       mask)
            flat = idx.reshape(-1)
            keep = (mask.reshape(-1) > 0).to(torch.float32)
            g.index_add_(0, flat, gch.reshape(-1) * keep)
            h.index_add_(0, flat, hch.reshape(-1) * keep)
        return g, h

    def _train_device(self, binned, gains, offsets, n, f, rng, valid,
                      evals, chunk_idx_d, chunk_gains_d, chunk_mask_d,
                      verbose_eval):
        """Device boosting loop (gbdt.py:580-691): gradients, subsampling,
        histogram tree growth and score updates stay on the device; only the
        finished per-tree arrays (KBs) come back each round. The row
        subsample is JAX's: ``key, k1 = split(key)`` then ``bernoulli(k1,
        p, (n,))`` each round from ``PRNGKey(seed)``, replayed bit for bit;
        the feature subsample is drawn from the numpy ``rng``."""
        dev = self.device
        grow_fn = _make_grow_tree_device(
            f, self.n_bins, self.max_depth, self.min_child_samples,
            float(self.reg_lambda),
        )
        binned_t_d = torch.as_tensor(np.ascontiguousarray(binned.T), device=dev)
        scores_d = torch.zeros(n, dtype=torch.float32, device=dev)
        key = prng_key(self.seed)
        lr = self.learning_rate
        logger.info("HistGBDT device backend: %d rows x %d features", n, f)

        best_metric, patience = -np.inf, 0
        for it in range(1, self.n_estimators + 1):
            grad_d, hess_d = self._round_grad(scores_d, chunk_idx_d,
                                              chunk_gains_d, chunk_mask_d)
            key, k1 = threefry_split(key)
            if self.subsample < 1.0:
                # per-row bernoulli(p) instead of the numpy path's exact
                # floor(n·p) draw — identical in expectation
                row_mask = threefry_bernoulli(k1, self.subsample, n, dev).to(
                    torch.float32)
            else:
                row_mask = torch.ones(n, dtype=torch.float32, device=dev)
            feats_mask = np.zeros(f, bool)
            if self.colsample < 1.0:
                feats_mask[rng.choice(
                    f, size=max(1, int(f * self.colsample)),
                    replace=False)] = True
            else:
                feats_mask[:] = True
            levels, row_value = grow_fn(
                binned_t_d, grad_d, hess_d, row_mask,
                torch.as_tensor(feats_mask, device=dev))
            tree = _tree_from_levels(levels, self.max_depth)
            self.trees.append(tree)
            scores_d = scores_d + lr * row_value

            if valid is not None:
                vb, gv, ov, vscores = valid
                vscores += lr * self._predict_tree(tree, vb)
                valid = (vb, gv, ov, vscores)
                m = self._ndcg10(vscores, gv, ov)
                evals["valid_ndcg@10"].append(m)
                if it % verbose_eval == 0:
                    logger.info("iter %d | valid ndcg@10 %.4f", it, m)
                if m > best_metric + 1e-6:
                    best_metric, patience = m, 0
                    self.best_iteration = it
                else:
                    patience += 1
                    if patience >= self.early_stop_rounds:
                        logger.info("Early stop at iter %d (best %d)",
                                    it, self.best_iteration)
                        self.trees = self.trees[: self.best_iteration]
                        break
            else:
                self.best_iteration = it

        self._trained = True
        scores = scores_d.cpu().numpy().astype(np.float64)
        evals["train_ndcg@10"].append(self._ndcg10(scores, gains, offsets))
        return evals

    # ------------------------------------------------------------------ #

    @staticmethod
    def _predict_tree(tree: _Tree, binned: np.ndarray) -> np.ndarray:
        node = np.zeros(len(binned), np.int32)
        active = tree.feature[node] >= 0
        while active.any():
            f = tree.feature[node[active]]
            go_left = (
                binned[np.nonzero(active)[0], f] <= tree.bin_threshold[node[active]]
            )
            nxt = np.where(go_left, tree.left[node[active]],
                           tree.right[node[active]])
            node[active] = nxt
            active = tree.feature[node] >= 0
        return tree.value[node]

    def predict(self, features) -> np.ndarray:
        """Score a frame (column dict) or an (n, F) array on the host."""
        if not self._trained:
            raise RuntimeError("Booster not trained. Call train() or load().")
        if isinstance(features, Mapping):
            X = feature_matrix(features, self.feature_names)
        else:
            X = np.asarray(features, np.float32)
        binned = self._bin(X, fit=False)
        out = np.zeros(len(X))
        for t in self.trees:
            out += self.learning_rate * self._predict_tree(t, binned)
        return out

    # --- device inference export ------------------------------------- #

    def export_arrays(self) -> Dict[str, np.ndarray]:
        """Flat ensemble arrays for on-device scoring: (T, max_nodes)."""
        T = len(self.trees)
        mn = max(len(t.feature) for t in self.trees)
        stack = lambda attr: np.stack(  # noqa: E731
            [np.pad(getattr(t, attr), (0, mn - len(getattr(t, attr))))
             for t in self.trees]
        )
        return {
            "feature": stack("feature").astype(np.int32),
            "bin_threshold": stack("bin_threshold").astype(np.int32),
            "left": stack("left").astype(np.int32),
            "right": stack("right").astype(np.int32),
            "value": stack("value").astype(np.float32),
            "bin_edges": self.bin_edges,
            "learning_rate": np.float32(self.learning_rate),
            "max_depth": np.int32(self.max_depth),
            "n_trees": np.int32(T),
        }

    def make_device_scorer(self):
        """Raw (…, C, F) candidate features on the device → (…, C) ensemble
        scores (gbdt.py:745-785).

        Each feature's bin is the count of its edges strictly below the
        value (``torch.searchsorted``; NaN → bin 0, JAX's ``sum(x > edges)``
        rule). Then a fixed-depth descent over all trees: at each of
        ``max_depth`` levels every (row, tree) pair reads its node's feature
        and threshold and steps to a child; a leaf's children are itself, so
        no pair branches. Trees go in chunks of at most
        ``SCORE_CHUNK_PAIRS`` (row, tree) pairs, so no intermediate holds
        all of them (1,024 users x 500 candidates x 200 trees would take
        410 MB an int32 array); the chunks' sums are added in order."""
        a = self.export_arrays()
        dev = self.device
        T, M = a["feature"].shape
        base = (np.arange(T, dtype=np.int64) * M)[:, None]
        leaf = a["feature"] < 0
        own = base + np.arange(M)[None, :]
        left = np.where(leaf, own, base + a["left"])
        right = np.where(leaf, own, base + a["right"])
        child = torch.as_tensor(np.stack([left, right], -1).reshape(-1).astype(np.int32),
                                device=dev)            # (T·M·2,) global ids
        feature = torch.as_tensor(np.maximum(a["feature"], 0).reshape(-1), device=dev)
        thresh = torch.as_tensor(a["bin_threshold"].reshape(-1), device=dev)
        value = torch.as_tensor(a["value"].reshape(-1), device=dev)
        edges = torch.as_tensor(np.ascontiguousarray(a["bin_edges"]), device=dev)  # (F, E)
        depth = int(a["max_depth"])
        lr = float(a["learning_rate"])
        n_feat = edges.shape[0]
        roots = torch.as_tensor(base[:, 0].astype(np.int32), device=dev)

        def score(x: torch.Tensor) -> torch.Tensor:
            lead = x.shape[:-1]
            xt = x.reshape(-1, n_feat).t().contiguous()          # (F, N)
            xb = torch.searchsorted(edges, xt, out_int32=True)
            xb = xb.masked_fill_(torch.isnan(xt), 0).t().contiguous()  # (N, F)
            n = xb.shape[0]
            row_base = (torch.arange(n, dtype=torch.int32, device=dev) * n_feat)[:, None]
            xb = xb.reshape(-1)
            out = torch.zeros(n, dtype=torch.float32, device=dev)
            step = max(1, SCORE_CHUNK_PAIRS // max(1, n))
            for t0 in range(0, T, step):
                node = roots[t0:t0 + step].expand(n, -1)
                for _ in range(depth):
                    fb = xb[row_base + feature[node]]
                    go_right = (fb > thresh[node]).to(torch.int32)
                    node = child[2 * node + go_right]
                out += value[node].sum(-1)
            return (lr * out).reshape(lead)

        return score

    def predict_device(self, x: torch.Tensor) -> torch.Tensor:
        """One-shot device scoring (for repeated use build the scorer once
        with :meth:`make_device_scorer`)."""
        return self.make_device_scorer()(x)

    # ------------------------------------------------------------------ #

    def feature_importance(self) -> Dict[str, float]:
        """Gain importance — total split gain per feature, normalized
        (LightGBM's importance_type="gain" semantics,
        reference ranker.py:180-188)."""
        if not self._trained:
            raise RuntimeError("Booster not trained.")
        gains = np.zeros(self.n_features)
        for t in self.trees:
            mask = t.feature >= 0
            np.add.at(gains, t.feature[mask], t.gain[mask])
        total = max(gains.sum(), 1e-12)
        return dict(zip(self.feature_names, (gains / total).tolist()))

    def top_features(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.feature_importance().items(),
                      key=lambda kv: -kv[1])[:n]

    # ------------------------------------------------------------------ #

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        arrays = {}
        for i, t in enumerate(self.trees):
            for attr in ("feature", "bin_threshold", "left", "right",
                         "value", "gain"):
                arrays[f"t{i}_{attr}"] = getattr(t, attr)
        np.savez(p, bin_edges=self.bin_edges, **arrays)
        meta = {
            "feature_names": self.feature_names,
            "n_trees": len(self.trees),
            "learning_rate": self.learning_rate,
            "max_depth": self.max_depth,
            "n_bins": self.n_bins,
            "label_gain": list(self.label_gain),
            "best_iteration": self.best_iteration,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))
        logger.info("Saved GBDT (%d trees) to %s", len(self.trees), p)

    @classmethod
    def load(cls, path: str, device=DEFAULT_DEVICE) -> "HistGBDTRanker":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"GBDT model not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        model = cls(
            learning_rate=meta["learning_rate"],
            max_depth=meta["max_depth"],
            n_bins=meta["n_bins"],
            label_gain=meta["label_gain"],
            device=device,
        )
        model.feature_names = meta["feature_names"]
        model.best_iteration = meta["best_iteration"]
        with np.load(p) as data:
            model.bin_edges = data["bin_edges"]
            for i in range(meta["n_trees"]):
                t = _Tree(len(data[f"t{i}_feature"]))
                for attr in ("feature", "bin_threshold", "left", "right",
                             "value", "gain"):
                    if f"t{i}_{attr}" in data:
                        getattr(t, attr)[:] = data[f"t{i}_{attr}"]
                model.trees.append(t)
        model._trained = True
        return model

    def model_info(self) -> Dict:
        if not self._trained:
            return {"trained": False}
        return {
            "trained": True,
            "model_type": "hist-gbdt-lambdarank",
            "n_features": self.n_features,
            "n_trees": len(self.trees),
            "max_depth": self.max_depth,
            "best_iteration": self.best_iteration,
            "top_features": [
                {"feature": f, "importance": round(v, 6)}
                for f, v in self.top_features(10)
            ],
        }
