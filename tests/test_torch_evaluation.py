"""The port's evaluation metrics (``evaluation/metrics.py``) against the JAX
package's.

The per-list numpy functions are copies: their source is pinned to the
originals, and they are also run on the same seeded inputs and must return
the same values. ``batch_rank_metrics`` (torch) is held to the JAX jnp
version within 1e-6 where JAX accepts the inputs (k up to the list's
length), and to the per-list numpy functions where the list is shorter
than k (JAX raises there). ``detect_training_serving_skew`` and
``evaluate_model`` must return the JAX dicts.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from recommendit_tpu.evaluation import metrics as jm
from recommendit_tpu_torch.evaluation import metrics as tm

COPIED = ["binary_auc", "binary_logloss", "ndcg_at_k", "recall_at_k",
          "precision_at_k", "mrr", "average_precision", "coverage",
          "intra_list_diversity", "kl_divergence_bins", "evaluate_model"]


@pytest.mark.parametrize("name", COPIED)
def test_copied_source_is_pinned(name):
    assert inspect.getsource(getattr(tm, name)) == inspect.getsource(getattr(jm, name))


def _lists(seed, n_users=60, n_items=80):
    rng = np.random.default_rng(seed)
    recs, truth = {}, {}
    for u in range(1, n_users + 1):
        recs[u] = rng.choice(np.arange(1, n_items + 1), size=rng.integers(0, 30),
                             replace=False).tolist()
        truth[u] = rng.choice(np.arange(1, n_items + 1), size=rng.integers(0, 8),
                              replace=False).tolist()
    return recs, truth


@pytest.mark.parametrize("seed", [0, 1])
def test_copied_functions_agree(seed):
    recs, truth = _lists(seed)
    for u in recs:
        r, t = recs[u], truth[u]
        for k in (1, 5, 10, 40):
            assert tm.ndcg_at_k(r, t, k) == jm.ndcg_at_k(r, t, k)
            assert tm.recall_at_k(r, t, k) == jm.recall_at_k(r, t, k)
            assert tm.precision_at_k(r, t, k) == jm.precision_at_k(r, t, k)
        graded = {i: float(j % 3) for j, i in enumerate(t)}
        assert tm.ndcg_at_k(r, t, 10, graded) == jm.ndcg_at_k(r, t, 10, graded)
        assert tm.mrr(r, t) == jm.mrr(r, t)
        assert tm.average_precision(r, t) == jm.average_precision(r, t)
    assert tm.coverage(list(recs.values()), 80) == jm.coverage(list(recs.values()), 80)
    rng = np.random.default_rng(seed)
    vecs = {i: rng.integers(0, 2, 18).astype(np.float32) for i in range(1, 81)}
    for u in list(recs)[:10]:
        assert tm.intra_list_diversity(recs[u], vecs) == jm.intra_list_diversity(
            recs[u], vecs)
    labels = rng.integers(0, 2, 500)
    scores = np.round(rng.normal(size=500), 1)         # ties
    assert tm.binary_auc(labels, scores) == jm.binary_auc(labels, scores)
    probs = rng.uniform(size=500)
    assert tm.binary_logloss(labels, probs) == jm.binary_logloss(labels, probs)
    p, q = rng.normal(size=400), rng.normal(0.3, 1.2, size=300)
    assert tm.kl_divergence_bins(p, q) == jm.kl_divergence_bins(p, q)


def test_evaluate_model_dicts_equal():
    recs, truth = _lists(3)
    rng = np.random.default_rng(3)
    vecs = {i: rng.integers(0, 2, 18).astype(np.float32) for i in range(1, 81)}
    for kw in (dict(), dict(k_values=[10, 20], catalog_size=80,
                            item_genre_vectors=vecs)):
        assert tm.evaluate_model(recs, truth, **kw) == jm.evaluate_model(
            recs, truth, **kw)
    assert tm.evaluate_model({}, truth) == jm.evaluate_model({}, truth)


def _batch(seed, b=40, r=25, n_items=60):
    rng = np.random.default_rng(seed)
    rec = np.stack([rng.permutation(np.arange(1, n_items + 1))[:r] for _ in range(b)])
    rel = rng.random((b, n_items + 1)) < rng.uniform(0, 0.15, (b, 1))
    rel[:, 0] = False
    rel[:5] = False                                    # no relevant item
    rel[5, :] = False
    rel[5, rec[5, -1]] = True                          # the last place only
    return rec, rel


@pytest.mark.parametrize("k", [1, 5, 10, 25])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_rank_metrics_match_jax(k, seed):
    rec, rel = _batch(seed)
    want = jm.batch_rank_metrics(jnp.asarray(rec), jnp.asarray(rel), k)
    got = tm.batch_rank_metrics(torch.as_tensor(rec), torch.as_tensor(rel), k)
    assert set(got) == set(want)
    for name, v in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(v), atol=1e-6,
                                   rtol=0, err_msg=name)
    # k beyond the number of relevant items; users with none score 0
    assert (rel.sum(1) < k).any()
    assert (got["ndcg"][:5] == 0).all() and (got["recall"][:5] == 0).all()


def test_batch_rank_metrics_lists_shorter_than_k():
    """k beyond the list's length (JAX raises on the shapes): each user's
    NDCG and recall are the per-list functions' over the short list."""
    rec, rel = _batch(2, r=7)
    with pytest.raises(TypeError):
        jm.batch_rank_metrics(jnp.asarray(rec), jnp.asarray(rel), 10)
    got = tm.batch_rank_metrics(torch.as_tensor(rec), torch.as_tensor(rel), 10)
    for b in range(len(rec)):
        relevant = np.flatnonzero(rel[b]).tolist()
        np.testing.assert_allclose(got["ndcg"][b].item(),
                                   tm.ndcg_at_k(rec[b].tolist(), relevant, 10),
                                   atol=1e-6)
        np.testing.assert_allclose(got["recall"][b].item(),
                                   tm.recall_at_k(rec[b].tolist(), relevant, 10),
                                   atol=1e-6)
        np.testing.assert_allclose(got["mrr"][b].item(),
                                   tm.mrr(rec[b].tolist(), relevant), atol=1e-6)


def _skew_frames(seed):
    rng = np.random.default_rng(seed)
    n = 300
    train = {"a": rng.normal(size=n).astype(np.float32),
             "b": rng.normal(size=n),
             "c": rng.integers(0, 5, n),
             "same": np.full(n, 2.0),
             "nans": np.where(np.arange(n) < 6, 1.0, np.nan),
             "label": rng.integers(0, 2, n).astype(bool),
             "title": np.array(["t"] * n),
             "only_train": rng.normal(size=n)}
    serving = {"a": train["a"] + np.float32(0.5), "b": train["b"][::-1].copy(),
               "c": rng.integers(0, 9, n), "same": np.full(n, 2.0),
               "nans": rng.normal(size=n), "label": train["label"],
               "title": train["title"]}
    return train, serving


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cols", [None, ["a", "c"]])
def test_skew_report_matches_jax(seed, cols):
    train, serving = _skew_frames(seed)
    want = jm.detect_training_serving_skew(pd.DataFrame(train), pd.DataFrame(serving),
                                           threshold=0.05, numeric_cols=cols)
    got = tm.detect_training_serving_skew(train, serving, threshold=0.05,
                                          numeric_cols=cols)
    assert got == want
    if cols is None:
        # NaNs dropped ("nans" keeps < 10 values and is skipped), bools and
        # strings are not numeric, columns only one side has are skipped
        assert set(got["feature_kl"]) == {"a", "b", "c", "same"}
        assert got["skew_detected"] and "a" in got["flagged_features"]
