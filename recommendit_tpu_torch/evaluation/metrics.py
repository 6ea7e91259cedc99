"""Ranking evaluation metrics and training-serving skew detection — torch
port.

Counterpart of ``recommendit_tpu/evaluation/metrics.py``. The per-list
numpy functions (NDCG with log2(i+2) discounts, recall, precision, MRR,
average precision, coverage, intra-list diversity, the binary AUC and log
loss, the binned KL and the multi-K report) are copies of the JAX
module's, which imports pandas and cannot be loaded where the port runs;
``tests/test_torch_evaluation.py`` pins each to its original.
:func:`batch_rank_metrics` is torch on the caller's device, and
:func:`detect_training_serving_skew` takes column dicts of numpy arrays
instead of DataFrames.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

# the functions below down to batch_rank_metrics, and coverage,
# intra_list_diversity, kl_divergence_bins and evaluate_model, are the JAX
# module's source, unchanged


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the rank-sum (Mann-Whitney U) statistic, tie-aware.

    O(N log N); no reference equivalent (the reference has no CTR task).
    Returns 0.5 when either class is empty.
    """
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = float(labels.sum())
    n_neg = float(len(labels) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks over ties
    sorted_scores = scores[order]
    _, inv, counts = np.unique(sorted_scores, return_inverse=True,
                               return_counts=True)
    csum = np.concatenate([[0], np.cumsum(counts)])
    avg = (csum[:-1] + csum[1:] + 1) / 2.0
    ranks[order] = avg[inv]
    rank_pos = ranks[labels > 0.5].sum()
    u = rank_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def binary_logloss(labels: np.ndarray, probs: np.ndarray,
                   eps: float = 1e-12) -> float:
    """Mean negative log-likelihood of Bernoulli labels."""
    labels = np.asarray(labels, dtype=np.float64)
    p = np.clip(np.asarray(probs, dtype=np.float64), eps, 1.0 - eps)
    return float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))


def ndcg_at_k(
    recommended: List[Any],
    relevant: List[Any],
    k: int,
    relevance_scores: Optional[Dict[Any, float]] = None,
) -> float:
    """NDCG@K; binary relevance unless a graded relevance dict is given."""
    relevant_set = set(relevant)
    top_k = list(recommended)[:k]

    if relevance_scores is not None:
        rels = np.array([float(relevance_scores.get(i, 0.0)) for i in top_k])
        ideal = sorted(
            (relevance_scores.get(i, 0.0) for i in relevant), reverse=True
        )[:k]
    else:
        rels = np.array([1.0 if i in relevant_set else 0.0 for i in top_k])
        ideal = [1.0] * min(len(relevant_set), k)

    discounts = 1.0 / np.log2(np.arange(2, rels.size + 2))
    dcg = float((rels * discounts).sum())
    idcg = sum(r / math.log2(i + 2) for i, r in enumerate(ideal) if r > 0)
    return dcg / idcg if idcg > 0 else 0.0


def recall_at_k(recommended: List[Any], relevant: List[Any], k: int) -> float:
    if not relevant:
        return 0.0
    relevant_set = set(relevant)
    hits = sum(1 for i in list(recommended)[:k] if i in relevant_set)
    return hits / len(relevant_set)


def precision_at_k(recommended: List[Any], relevant: List[Any], k: int) -> float:
    if k == 0:
        return 0.0
    relevant_set = set(relevant)
    hits = sum(1 for i in list(recommended)[:k] if i in relevant_set)
    return hits / k


def mrr(recommended: List[Any], relevant: List[Any]) -> float:
    relevant_set = set(relevant)
    for rank, item in enumerate(recommended, start=1):
        if item in relevant_set:
            return 1.0 / rank
    return 0.0


def average_precision(recommended: List[Any], relevant: List[Any]) -> float:
    if not relevant:
        return 0.0
    relevant_set = set(relevant)
    hits, total = 0, 0.0
    for i, item in enumerate(recommended, start=1):
        if item in relevant_set:
            hits += 1
            total += hits / i
    return total / len(relevant_set)


def batch_rank_metrics(rec_ids, rel_matrix, k: int) -> Dict[str, torch.Tensor]:
    """NDCG@K / Recall@K / MRR for a batch of users in one set of tensor
    ops, on the device of ``rec_ids``.

    Args:
        rec_ids: (B, R) int recommended item ids per user (rank order).
        rel_matrix: (B, N+1) bool/0-1 relevance lookup indexed by item id.
        k: cutoff. Lists shorter than ``k`` are scored over their R items
            (as :func:`ndcg_at_k` scores a short list).

    Returns a dict of (B,) float32 tensors; users with no relevant item
    get 0. MRR runs over the whole list.
    """
    rec_ids = torch.as_tensor(rec_ids).long()
    rel = torch.as_tensor(rel_matrix, device=rec_ids.device)
    dev = rec_ids.device
    rec_k = rec_ids[:, :k]
    rels = torch.gather(rel, 1, rec_k).float()
    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32,
                                              device=dev))
    dcg = (rels * discounts[None, : rec_k.shape[1]]).sum(dim=1)

    n_rel = rel.sum(dim=1).float()
    ideal_len = torch.clamp(n_rel, max=float(k))
    cum = torch.cumsum(discounts, dim=0)
    idx = torch.clamp(ideal_len.long() - 1, 0, k - 1)
    one, zero = torch.ones_like(n_rel), torch.zeros_like(n_rel)
    idcg = torch.where(ideal_len > 0, cum[idx], one)
    ndcg = torch.where(n_rel > 0, dcg / idcg, zero)

    hits = rels.sum(dim=1)
    recall = torch.where(n_rel > 0, hits / torch.clamp(n_rel, min=1.0), zero)

    # the first relevant position (argmax returns the first maximum)
    rels_full = torch.gather(rel, 1, rec_ids).float()
    found = rels_full.sum(dim=1) > 0
    first = rels_full.argmax(dim=1).float() + 1.0
    rr = torch.where(found, 1.0 / first, zero)
    return {"ndcg": ndcg, "recall": recall, "mrr": rr, "n_relevant": n_rel}

def coverage(all_recommendations: List[List[Any]], catalog_size: int) -> float:
    if catalog_size == 0:
        return 0.0
    seen = set()
    for recs in all_recommendations:
        seen.update(recs)
    return len(seen) / catalog_size


def intra_list_diversity(
    recommendations: List[Any],
    item_genre_vectors: Dict[Any, np.ndarray],
) -> float:
    """Mean pairwise (1 - cosine) over genre vectors, vectorized."""
    vecs = [
        np.asarray(item_genre_vectors[i], dtype=np.float64)
        for i in recommendations
        if i in item_genre_vectors
    ]
    if len(vecs) < 2:
        return 0.0
    mat = np.stack(vecs)
    norms = np.linalg.norm(mat, axis=1)
    ok = norms > 0
    mat, norms = mat[ok], norms[ok]
    n = mat.shape[0]
    if n < 2:
        return 0.0
    sims = (mat @ mat.T) / np.outer(norms, norms)
    iu = np.triu_indices(n, k=1)
    return float((1.0 - sims[iu]).mean())


def kl_divergence_bins(
    p_values: np.ndarray,
    q_values: np.ndarray,
    n_bins: int = 20,
    epsilon: float = 1e-10,
) -> float:
    """Histogram-estimated KL(P||Q) on the combined value range."""
    p_values = np.asarray(p_values, dtype=np.float64)
    q_values = np.asarray(q_values, dtype=np.float64)
    lo = min(p_values.min(), q_values.min())
    hi = max(p_values.max(), q_values.max())
    if lo == hi:
        return 0.0
    edges = np.linspace(lo, hi, n_bins + 1)
    p_hist, _ = np.histogram(p_values, bins=edges, density=True)
    q_hist, _ = np.histogram(q_values, bins=edges, density=True)
    p_hist = p_hist + epsilon
    q_hist = q_hist + epsilon
    p_hist /= p_hist.sum()
    q_hist /= q_hist.sum()
    return float(np.sum(p_hist * np.log(p_hist / q_hist)))


def detect_training_serving_skew(
    train_features: Mapping[str, np.ndarray],
    serving_features: Mapping[str, np.ndarray],
    threshold: float = 0.1,
    numeric_cols: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Per-feature KL report over two column dicts; flags features with KL
    above threshold. The default columns are the numeric columns of
    ``train_features`` that ``serving_features`` also holds; NaNs are
    dropped, a column with fewer than 10 values either side is skipped, and
    each KL is rounded to 6 digits."""
    if numeric_cols is None:
        numeric_cols = [
            c for c, v in train_features.items()
            if np.asarray(v).dtype.kind in "iufc" and c in serving_features
        ]

    feature_kl: Dict[str, float] = {}
    for col in numeric_cols:
        tv = np.asarray(train_features[col], dtype=float)
        sv = np.asarray(serving_features[col], dtype=float)
        tv, sv = tv[~np.isnan(tv)], sv[~np.isnan(sv)]
        if len(tv) < 10 or len(sv) < 10:
            continue
        feature_kl[col] = round(kl_divergence_bins(tv, sv), 6)

    flagged = [f for f, v in feature_kl.items() if v > threshold]
    result = {
        "feature_kl": feature_kl,
        "flagged_features": flagged,
        "max_kl": max(feature_kl.values()) if feature_kl else 0.0,
        "skew_detected": len(flagged) > 0,
        "threshold": threshold,
        "n_features_checked": len(feature_kl),
    }
    if flagged:
        logger.warning("Training-serving skew in %d features: %s",
                       len(flagged), flagged[:5])
    return result

def evaluate_model(
    recommendations_by_user: Dict[Any, List[Any]],
    ground_truth_by_user: Dict[Any, List[Any]],
    k_values: Optional[List[int]] = None,
    catalog_size: Optional[int] = None,
    item_genre_vectors: Optional[Dict[Any, np.ndarray]] = None,
) -> Dict[str, Any]:
    """Aggregate NDCG/recall/precision per K + MRR/coverage/diversity."""
    if k_values is None:
        k_values = [5, 10, 20]

    users = list(recommendations_by_user.keys())
    if not users:
        return {"error": "No users to evaluate", "n_users": 0}

    results: Dict[str, Any] = {"n_users": len(users), "k_values": k_values}
    per_k = {k: {"ndcg": [], "recall": [], "precision": []} for k in k_values}
    mrr_scores: List[float] = []
    diversity_scores: List[float] = []
    all_recs: List[List[Any]] = []

    for uid in users:
        recs = recommendations_by_user.get(uid, [])
        relevant = ground_truth_by_user.get(uid, [])
        if not relevant:
            continue
        all_recs.append(recs)
        for k in k_values:
            per_k[k]["ndcg"].append(ndcg_at_k(recs, relevant, k))
            per_k[k]["recall"].append(recall_at_k(recs, relevant, k))
            per_k[k]["precision"].append(precision_at_k(recs, relevant, k))
        mrr_scores.append(mrr(recs, relevant))
        if item_genre_vectors:
            diversity_scores.append(
                intra_list_diversity(recs[: k_values[-1]], item_genre_vectors)
            )

    for k in k_values:
        for name, scores in per_k[k].items():
            results[f"{name}@{k}"] = float(np.mean(scores)) if scores else 0.0
    results["mrr"] = float(np.mean(mrr_scores)) if mrr_scores else 0.0
    if catalog_size and all_recs:
        results["coverage"] = coverage(all_recs, catalog_size)
    if diversity_scores:
        results["avg_diversity"] = float(np.mean(diversity_scores))

    for k in k_values:
        logger.info(
            "K=%d | NDCG=%.4f | Recall=%.4f | Precision=%.4f",
            k, results.get(f"ndcg@{k}", 0), results.get(f"recall@{k}", 0),
            results.get(f"precision@{k}", 0),
        )
    logger.info("MRR=%.4f", results["mrr"])
    return results
