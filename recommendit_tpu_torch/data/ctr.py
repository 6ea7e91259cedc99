"""Synthetic Criteo-style CTR dataset (BASELINE config #5) — torch port.

A copy of ``recommendit_tpu/data/ctr.py`` (numpy only, so the port keeps
its own rather than importing the JAX package): everything but this
docstring is the original's code, which ``tests/test_torch_ctr.py`` pins
by syntax tree. It generates a seeded click-through log with the Criteo
shape — 13 dense features, 26 categorical fields with long-tailed
vocabularies — over explicit latent users and items, so that both the
CTR task (AUC, logloss) and the retrieval task (Recall@K of the clicked
item) are learnable and measurable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

N_DENSE = 13
N_SPARSE = 26
N_USER_FIELDS = 8   # C1-C8 describe the user (C1 = user id)
N_ITEM_FIELDS = 18  # C9-C26 describe the item (C9 = item id)


def _zipf_probs(n: int, alpha: float = 1.05) -> np.ndarray:
    """Long-tailed popularity over n values (Criteo vocabularies are
    heavily skewed)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


def _quantile_bin(scores: np.ndarray, n_bins: int) -> np.ndarray:
    """Rank-quantize a score vector into n_bins equal-mass bins.

    Ties the categorical field value to the latent factor that produced
    ``scores`` — the information a CTR model must extract.
    """
    order = np.argsort(scores, kind="stable")
    ranks = np.empty_like(order)
    ranks[order] = np.arange(len(scores))
    return ((ranks * n_bins) // max(1, len(scores))).astype(np.int32)


@dataclasses.dataclass
class CTRDataset:
    """Impression log + entity catalogs.

    ``sparse`` holds per-field-local ids; stack onto one embedding table
    with :func:`recommendit_tpu.models.ctr.field_offsets`.
    """

    dense: np.ndarray          # (N, 13) float32
    sparse: np.ndarray         # (N, 26) int32, field-local ids
    labels: np.ndarray         # (N,) float32 in {0, 1}
    user_ids: np.ndarray       # (N,) int32 — latent user per impression
    item_ids: np.ndarray       # (N,) int32 — latent item per impression
    vocab_sizes: Tuple[int, ...]           # len 26
    user_field_values: np.ndarray          # (n_users, 8) int32 catalog
    item_field_values: np.ndarray          # (n_items, 18) int32 catalog
    n_user_fields: int = N_USER_FIELDS

    @property
    def n_users(self) -> int:
        return self.user_field_values.shape[0]

    @property
    def n_items(self) -> int:
        return self.item_field_values.shape[0]

    def split(self, test_frac: float = 0.1) -> Tuple["CTRDataset", "CTRDataset"]:
        """Temporal-style tail split (impressions are generated in 'time'
        order; the last ``test_frac`` is held out — mirrors the reference's
        90/10 interaction-time split, run_pipeline.py:154-157)."""
        n = len(self.labels)
        cut = n - int(n * test_frac)

        def take(sl):
            return dataclasses.replace(
                self,
                dense=self.dense[sl],
                sparse=self.sparse[sl],
                labels=self.labels[sl],
                user_ids=self.user_ids[sl],
                item_ids=self.item_ids[sl],
            )

        return take(slice(0, cut)), take(slice(cut, n))


def _entity_fields(
    rng: np.random.Generator,
    latents: np.ndarray,
    n_fields: int,
    id_vocab: int,
    aux_vocabs: np.ndarray,
    noise: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Assign categorical field values to entities.

    Field 0 is the entity id itself (big vocab, fully identifying). Fields
    1..n-1 are quantile-binned noisy projections of the entity latent —
    small-vocab demographic-style features correlated with behavior.
    Returns (values (n_entities, n_fields), vocab_sizes (n_fields,)).
    """
    n, k = latents.shape
    values = np.zeros((n, n_fields), dtype=np.int32)
    values[:, 0] = np.arange(n, dtype=np.int32)
    vocabs = np.zeros(n_fields, dtype=np.int64)
    vocabs[0] = id_vocab
    for f in range(1, n_fields):
        w = rng.standard_normal(k)
        score = latents @ w + noise * rng.standard_normal(n)
        v = int(aux_vocabs[(f - 1) % len(aux_vocabs)])
        values[:, f] = _quantile_bin(score, v)
        vocabs[f] = v
    return values, vocabs


def make_ctr_dataset(
    n_examples: int = 100_000,
    n_users: int = 4_000,
    n_items: int = 2_000,
    latent_dim: int = 16,
    target_ctr: float = 0.25,
    signal_scale: float = 4.0,
    seed: int = 0,
    user_aux_vocabs: Optional[np.ndarray] = None,
    item_aux_vocabs: Optional[np.ndarray] = None,
) -> CTRDataset:
    """Generate a seeded Criteo-shaped impression log.

    ``signal_scale`` controls how separable clicks are (Bayes AUC);
    ``target_ctr`` calibrates the global click rate via a bias search
    (Criteo's is ~25%).
    """
    rng = np.random.default_rng(seed)
    if user_aux_vocabs is None:
        user_aux_vocabs = np.array([97, 23, 11, 5, 211, 43, 7])
    if item_aux_vocabs is None:
        item_aux_vocabs = np.array([53, 307, 17, 89, 7, 29, 3, 131, 13,
                                    61, 5, 19, 401, 37, 9, 71, 11])

    # --- latent entities ------------------------------------------------ #
    p = rng.standard_normal((n_users, latent_dim)) / np.sqrt(latent_dim)
    q = rng.standard_normal((n_items, latent_dim)) / np.sqrt(latent_dim)

    user_fields, user_vocabs = _entity_fields(
        rng, p, N_USER_FIELDS, n_users, user_aux_vocabs
    )
    item_fields, item_vocabs = _entity_fields(
        rng, q, N_ITEM_FIELDS, n_items, item_aux_vocabs
    )

    # --- impressions (zipf users x zipf items) --------------------------- #
    u = rng.choice(n_users, size=n_examples, p=_zipf_probs(n_users)).astype(np.int32)
    i = rng.choice(n_items, size=n_examples, p=_zipf_probs(n_items)).astype(np.int32)

    affinity = np.einsum("nk,nk->n", p[u], q[i])

    # --- dense features (I1-I13) ---------------------------------------- #
    # Noisy projections of the latents + context, then count-like
    # transforms on half the columns (Criteo dense are counts; the standard
    # preprocessing is log1p — we emit them already transformed).
    ctx = rng.standard_normal((n_examples, 4))
    dense = np.zeros((n_examples, N_DENSE), dtype=np.float32)
    for j in range(N_DENSE):
        a = rng.standard_normal(latent_dim)
        b = rng.standard_normal(latent_dim)
        c = rng.standard_normal(4)
        raw = p[u] @ a + q[i] @ b + ctx @ c + 0.5 * rng.standard_normal(n_examples)
        if j % 2 == 0:  # count-like: exponentiate then log1p (heavy tail)
            raw = np.log1p(np.exp(np.clip(raw, -10, 10)))
        dense[:, j] = raw.astype(np.float32)

    # --- click labels ----------------------------------------------------- #
    ctx_effect = ctx @ rng.standard_normal(4) * 0.3
    logit = signal_scale * affinity + ctx_effect
    # calibrate bias for the target CTR (monotone in bias -> bisection)
    lo, hi = -20.0, 20.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        if np.mean(1.0 / (1.0 + np.exp(-(logit + mid)))) < target_ctr:
            lo = mid
        else:
            hi = mid
    bias = 0.5 * (lo + hi)
    click_p = 1.0 / (1.0 + np.exp(-(logit + bias)))
    labels = (rng.random(n_examples) < click_p).astype(np.float32)

    sparse = np.concatenate([user_fields[u], item_fields[i]], axis=1)
    vocab_sizes = tuple(int(v) for v in np.concatenate([user_vocabs, item_vocabs]))

    return CTRDataset(
        dense=dense,
        sparse=sparse,
        labels=labels,
        user_ids=u,
        item_ids=i,
        vocab_sizes=vocab_sizes,
        user_field_values=user_fields,
        item_field_values=item_fields,
    )
