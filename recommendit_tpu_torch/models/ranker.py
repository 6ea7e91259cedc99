"""LambdaRank MLP re-ranker — torch port.

Counterpart of ``recommendit_tpu/models/ranker.py``: the MLP scorer over
the 50-feature contract (plus any retrieval features named in
``feature_names``), its three group losses, the group packing, training
with early stopping on validation NDCG@10, ``predict``, gradient feature
importance, the device scorer of the fused serve path and the npz +
``.meta.json`` format (``load`` / ``save``), which both packages read.

The losses take a batch of padded groups, (B, G) scores, gains and masks,
where JAX vmaps a one-group function; each group's ranks come from a
stable argsort under ``no_grad``, as ``jnp.argsort`` is stable and the ranks
are weights only. The host side (:func:`per_query_normalize`,
:func:`pack_groups`) is numpy, computed as the JAX module computes it, with
one change: :func:`per_query_normalize` first shifts each group by its
first row, so a column that is constant over a group (every user feature
over a query) standardises to exact zeros, as the serve scorer's does
(ROADMAP C.8). Training runs JAX's optimizer:
``optax.cosine_decay_schedule`` and ``clip_by_global_norm(1.0)`` before
``optax.adamw`` at its defaults (weight decay 1e-4 on every parameter),
through ``training/train_embeddings.py``'s helpers, which round as optax
does (C.12). ``jax.random`` cannot be replayed in torch: :func:`init_mlp`
draws from a ``torch.Generator``, and :func:`from_jax_params` carries JAX's
params across when both sides must start alike.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

logger = logging.getLogger(__name__)

DEFAULT_LABEL_GAIN = (0.0, 1.0, 3.0, 7.0, 15.0)
MASKED_SCORE = -1e9


# ------------------------------------------------------------------ #
# Pure model functions                                                 #
# ------------------------------------------------------------------ #

def init_mlp(gen: torch.Generator, n_features: int,
             hidden_dims: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Glorot-uniform weights and zero biases, ``w0/b0 …``, drawn on the
    generator's device (the CPU for a default generator)."""
    params = {}
    dims = [n_features] + list(hidden_dims) + [1]
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        limit = float(np.sqrt(6.0 / (d_in + d_out)))
        u = torch.rand((d_in, d_out), generator=gen, device=gen.device)
        params[f"w{i}"] = (2.0 * u - 1.0) * limit
        params[f"b{i}"] = torch.zeros((d_out,), device=gen.device)
    return params


def from_jax_params(params: Mapping[str, np.ndarray],
                    device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """The JAX package's ranker params (numpy arrays, ``w0/b0 …``) as the
    port's, so both trainers can start from the same weights."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
            for k, v in params.items()}


def mlp_score(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(…, F) standardised features → (…,) scores; layers ``w0/b0 …``."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers - 1):
        h = torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
    out = h @ params[f"w{n_layers - 1}"] + params[f"b{n_layers - 1}"]
    return out[..., 0]


def _masked(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask > 0, scores, torch.full_like(scores, MASKED_SCORE))


@torch.no_grad()
def _ranks(masked_scores: torch.Tensor) -> torch.Tensor:
    """(B, G) 1-based rank of each slot by descending score; ties keep slot
    order (a stable sort, as ``jnp.argsort``)."""
    g = masked_scores.shape[-1]
    order = torch.argsort(-masked_scores, dim=-1, stable=True)
    pos = torch.arange(1, g + 1, dtype=torch.float32, device=order.device)
    return torch.zeros_like(masked_scores).scatter_(
        -1, order, pos.expand_as(masked_scores).contiguous())


def _ideal_dcg(gains: torch.Tensor, mask: torch.Tensor,
               within_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    g = gains.shape[-1]
    sorted_gains = torch.sort(torch.where(mask > 0, gains, 0.0), dim=-1,
                              descending=True).values
    disc = 1.0 / torch.log2(2.0 + torch.arange(g, dtype=torch.float32,
                                               device=gains.device))
    if within_k is not None:
        disc = disc * within_k
    return (sorted_gains * disc).sum(-1)


def _pairs(masked_scores, gains, mask):
    """Score differences, gain differences and the valid pairs (gain_i >
    gain_j, both real), each (B, G, G)."""
    s_diff = masked_scores[..., :, None] - masked_scores[..., None, :]
    gain_diff = gains[..., :, None] - gains[..., None, :]
    pair_valid = ((gain_diff > 0) & (mask[..., :, None] > 0)
                  & (mask[..., None, :] > 0)).float()
    return s_diff, gain_diff, pair_valid


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it; its gradient
    at a tie (x = 0) is 1/2, which a clamp-and-abs form gets wrong."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _pairwise_loss(s_diff, weight, pair_valid):
    pair_loss = _softplus(-s_diff) * weight * pair_valid
    n_pairs = pair_valid.sum((-2, -1)).clamp(min=1.0)
    return pair_loss.sum((-2, -1)) / n_pairs


def lambdarank_loss(scores: torch.Tensor, gains: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(B, G) padded groups → (B,) LambdaRank losses: the pairwise logistic
    loss over pairs with gain_i > gain_j, each weighted by the |ΔNDCG| of
    swapping them at their current ranks."""
    masked = _masked(scores, mask)
    disc = 1.0 / torch.log2(1.0 + _ranks(masked))
    idcg = _ideal_dcg(gains, mask).clamp(min=1e-9)
    s_diff, gain_diff, pair_valid = _pairs(masked, gains, mask)
    delta = (gain_diff.abs() * (disc[..., :, None] - disc[..., None, :]).abs()
             / idcg[..., None, None])
    return _pairwise_loss(s_diff, delta, pair_valid)


def lambdaloss_ndcg2(scores: torch.Tensor, gains: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """NDCG-Loss2 of the LambdaLoss framework (Wang et al., CIKM'18): the
    pair weight is the discount gap at the rank distance,
    |1/log2(1+max(d, 1)) − 1/log2(2+d)|."""
    masked = _masked(scores, mask)
    ranks = _ranks(masked)
    idcg = _ideal_dcg(gains, mask).clamp(min=1e-9)
    s_diff, gain_diff, pair_valid = _pairs(masked, gains, mask)
    dist = (ranks[..., :, None] - ranks[..., None, :]).abs()
    delta = (1.0 / torch.log2(1.0 + dist.clamp(min=1.0))
             - 1.0 / torch.log2(2.0 + dist)).abs()
    weight = gain_diff.abs() * delta / idcg[..., None, None]
    return _pairwise_loss(s_diff, weight, pair_valid)


def softmax_listwise_loss(scores: torch.Tensor, gains: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Listwise softmax cross-entropy (ListNet top-1, target ∝ gains)."""
    log_probs = torch.log_softmax(_masked(scores, mask), dim=-1)
    pos_gain = gains * mask
    total = pos_gain.sum(-1, keepdim=True).clamp(min=1e-9)
    return -(pos_gain / total * torch.where(mask > 0, log_probs, 0.0)).sum(-1)


GROUP_LOSSES = {
    "lambdarank": lambdarank_loss,
    "lambdaloss": lambdaloss_ndcg2,
    "softmax": softmax_listwise_loss,
}


def batched_group_loss(params, x, gains, mask, loss_type: str = "lambdarank"):
    """(B, G, F) groups → the mean loss over the usable groups: a group
    counts if it has a pair with gain_i > gain_j (pairwise losses) or any
    positive gain (softmax)."""
    losses = GROUP_LOSSES[loss_type](mlp_score(params, x), gains, mask)
    with torch.no_grad():
        if loss_type == "softmax":
            usable = ((gains * mask) > 0).any(-1)
        else:
            g = torch.where(mask > 0, gains, 0.0)
            usable = ((g[..., :, None] - g[..., None, :]) > 0).flatten(-2).any(-1)
        usable = usable.float()
    return (losses * usable).sum() / usable.sum().clamp(min=1.0)


def batched_lambdarank_loss(params, x, gains, mask):
    """Alias of :func:`batched_group_loss` with ``loss_type='lambdarank'``
    (JAX's backward-compatible name)."""
    return batched_group_loss(params, x, gains, mask, "lambdarank")


def group_ndcg_at_k(scores, gains, mask, k: int):
    """NDCG@k of each padded group (a metric, not a loss): (B,) values and
    (B,) whether the group has any gain."""
    g = scores.shape[-1]
    order = torch.argsort(-_masked(scores, mask), dim=-1, stable=True)
    top_gains = torch.where(mask > 0, gains, 0.0).gather(-1, order)
    disc = 1.0 / torch.log2(2.0 + torch.arange(g, dtype=torch.float32,
                                               device=scores.device))
    within_k = (torch.arange(g, device=scores.device) < k).float()
    dcg = (top_gains * disc * within_k).sum(-1)
    idcg = _ideal_dcg(gains, mask, within_k)
    return torch.where(idcg > 0, dcg / idcg.clamp(min=1e-9), 0.0), idcg > 0


def _first_rows(X: np.ndarray, q: np.ndarray, n_q: int) -> np.ndarray:
    """Each row's group's first row (in row order)."""
    uniq, first = np.unique(q, return_index=True)
    shift = np.zeros((n_q, X.shape[1]), X.dtype)
    shift[uniq] = X[first]
    return shift[q]


def per_query_normalize(X: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Standardise each feature within its query group: shift by the
    group's first row, then JAX's bincount/add.at standardisation,
    (x − mean) / (std + 1e-6) with the population std. The shift changes
    nothing in exact arithmetic; in f32 it makes a column that is constant
    over a group exactly 0, where JAX's unshifted mean leaves a rounding
    residue that the 1e-6 floor blows up to O(0.1)."""
    n_q = int(q.max()) + 1 if len(q) else 0
    if n_q:
        X = X - _first_rows(X, q, n_q)
    counts = np.maximum(
        np.bincount(q, minlength=n_q).astype(np.float32), 1.0
    )[:, None]
    sums = np.zeros((n_q, X.shape[1]), np.float32)
    np.add.at(sums, q, X)
    means = sums / counts
    sq = np.zeros_like(sums)
    np.add.at(sq, q, (X - means[q]) ** 2)
    std = np.sqrt(sq / counts) + 1e-6
    return (X - means[q]) / std[q]


def pack_groups(
    X: np.ndarray,
    labels: np.ndarray,
    query_ids: np.ndarray,
    group_size: int,
    label_gain: Sequence[float] = DEFAULT_LABEL_GAIN,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged query groups → fixed (n_chunks, G, F) padded chunks, with
    their (n_chunks, G) gains and masks. Each query's rows are shuffled
    and split into chunks of ``group_size`` (the pairwise loss then acts
    within chunks), drawing from ``rng`` as JAX does."""
    rng = rng or np.random.default_rng(0)
    gain_table = np.asarray(label_gain, np.float32)
    xs, gs, ms = [], [], []
    order = np.argsort(query_ids, kind="stable")
    Xs, ls, qs = X[order], labels[order], query_ids[order]
    boundaries = np.nonzero(np.diff(qs))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(qs)]])
    for s, e in zip(starts, ends):
        idx = np.arange(s, e)
        rng.shuffle(idx)
        for cs in range(0, len(idx), group_size):
            chunk = idx[cs: cs + group_size]
            n = len(chunk)
            x = np.zeros((group_size, X.shape[1]), np.float32)
            g = np.zeros((group_size,), np.float32)
            m = np.zeros((group_size,), np.float32)
            x[:n] = Xs[chunk]
            lab = np.clip(ls[chunk].astype(np.int64), 0, len(gain_table) - 1)
            g[:n] = gain_table[lab]
            m[:n] = 1.0
            xs.append(x)
            gs.append(g)
            ms.append(m)
    return np.stack(xs), np.stack(gs), np.stack(ms)


def feature_matrix(frame: Mapping[str, np.ndarray], cols: Sequence[str]) -> np.ndarray:
    """(n, F) float32 of ``frame``'s columns, column-major as a DataFrame's
    ``.values`` is: numpy reduces along the contiguous axis pairwise, so
    the layout decides how ``mean(axis=0)`` rounds."""
    return np.stack([np.asarray(frame[c], np.float32) for c in cols]).T


# ------------------------------------------------------------------ #
# Ranker                                                               #
# ------------------------------------------------------------------ #

class LambdaRankScorer:
    """Query-grouped learning-to-rank scorer on the 50-feature contract.
    Frames are column dicts (``features/schema.py``)."""

    def __init__(self, feature_names: Optional[List[str]] = None,
                 hidden_dims: Sequence[int] = (128, 64),
                 learning_rate: float = 3e-3, epochs: int = 40,
                 group_size: int = 64,
                 label_gain: Sequence[float] = DEFAULT_LABEL_GAIN,
                 eval_at: Sequence[int] = (5, 10, 20),
                 early_stop_rounds: int = 5, batch_groups: int = 256,
                 seed: int = 0, loss_type: str = "lambdarank",
                 query_norm: bool = False, device=DEFAULT_DEVICE):
        if loss_type not in GROUP_LOSSES:
            raise ValueError(f"loss_type must be one of {sorted(GROUP_LOSSES)}, "
                             f"got {loss_type!r}")
        self.feature_names = feature_names
        self.hidden_dims = tuple(hidden_dims)
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.group_size = group_size
        self.label_gain = tuple(label_gain)
        self.eval_at = tuple(eval_at)
        self.early_stop_rounds = early_stop_rounds
        self.batch_groups = batch_groups
        self.seed = seed
        self.loss_type = loss_type
        self.query_norm = query_norm
        self.device = resolve_device(device)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.feat_mean: Optional[np.ndarray] = None
        self.feat_std: Optional[np.ndarray] = None
        self._trained = False
        self.best_iteration = 0
        self.evals_result: Dict[str, List[float]] = {}

    @property
    def n_features(self) -> int:
        return len(self.feature_names) if self.feature_names else 0

    # ------------------------------------------------------------------ #

    def _extract(self, frame, feature_cols, label_col, query_col):
        X = feature_matrix(frame, feature_cols)
        y = np.asarray(frame[label_col]).astype(np.int64)
        _, q = np.unique(np.asarray(frame[query_col]), return_inverse=True)
        return X, y, q

    def _standardize(self, X: np.ndarray, q: Optional[np.ndarray]) -> np.ndarray:
        Xn = (X - self.feat_mean) / self.feat_std
        if self.query_norm:
            Xn = per_query_normalize(Xn, np.zeros(len(Xn), np.int64) if q is None else q)
        return Xn

    def train(self, train_df, feature_cols: List[str], label_col: str = "label",
              query_col: str = "query_id", valid_df=None, verbose_eval: int = 10,
              init_params: Optional[Dict[str, torch.Tensor]] = None,
              ) -> Dict[str, List[float]]:
        """Train with LambdaRank; early-stops on valid NDCG@10 when a
        validation frame is given. ``init_params`` sets the initial weights
        (e.g. :func:`from_jax_params`); by default they are drawn from
        ``seed``. The epoch's chunks stay on the device, indexed by the
        epoch's permutation; the host reads one mean loss and one NDCG per
        epoch."""
        from recommendit_tpu_torch.training.train_embeddings import (
            OptaxAdamW,
            clip_by_global_norm_,
            cosine_lr,
        )

        dev = self.device
        self.feature_names = list(feature_cols)
        X, y, q = self._extract(train_df, feature_cols, label_col, query_col)
        self.feat_mean = X.mean(axis=0)
        self.feat_std = X.std(axis=0) + 1e-6
        Xn = self._standardize(X, q)

        host_rng = np.random.default_rng(self.seed)
        packed = pack_groups(Xn, y, q, self.group_size, self.label_gain, host_rng)
        xs, gs, ms = (torch.as_tensor(a, device=dev) for a in packed)
        n_chunks = len(xs)
        logger.info("LambdaRank: %d rows → %d group-chunks of %d (F=%d)",
                    len(X), n_chunks, self.group_size, len(feature_cols))

        valid = None
        if valid_df is not None:
            Xv, yv, qv = self._extract(valid_df, feature_cols, label_col, query_col)
            valid = tuple(torch.as_tensor(a, device=dev) for a in pack_groups(
                self._standardize(Xv, qv), yv, qv, self.group_size,
                self.label_gain, host_rng))

        if init_params is None:
            init_params = init_mlp(torch.Generator().manual_seed(self.seed),
                                   len(feature_cols), self.hidden_dims)
        params = {k: v.to(dev, torch.float32, copy=True).requires_grad_(True)
                  for k, v in init_params.items()}
        plist = list(params.values())
        opt = OptaxAdamW(plist, [True] * len(plist), weight_decay=1e-4)
        bg = min(self.batch_groups, n_chunks)
        steps_per_epoch = max(1, n_chunks // bg)
        decay_steps = max(1, self.epochs * steps_per_epoch)

        best_metric = -np.inf
        best_params = {k: p.detach().clone() for k, p in params.items()}
        patience = 0
        count = 0
        self.evals_result = {"train_loss": [], "valid_ndcg@10": []}
        for epoch in range(1, self.epochs + 1):
            perm = host_rng.permutation(n_chunks)
            take = torch.as_tensor(perm[:steps_per_epoch * bg], device=dev)
            xb = xs[take].reshape(steps_per_epoch, bg, self.group_size, -1)
            gb = gs[take].reshape(steps_per_epoch, bg, self.group_size)
            mb = ms[take].reshape(steps_per_epoch, bg, self.group_size)
            losses = []
            for s in range(steps_per_epoch):
                loss = batched_group_loss(params, xb[s], gb[s], mb[s], self.loss_type)
                grads = list(torch.autograd.grad(loss, plist))
                clip_by_global_norm_(grads, 1.0)
                opt.step(grads, cosine_lr(self.learning_rate, count, decay_steps))
                losses.append(loss.detach())
                count += 1
            loss = float(torch.stack(losses).mean())
            self.evals_result["train_loss"].append(loss)

            if valid is not None:
                ndcg = self._valid_ndcg(params, *valid)
                self.evals_result["valid_ndcg@10"].append(ndcg)
                if epoch % verbose_eval == 0:
                    logger.info("epoch %d | loss %.5f | valid ndcg@10 %.4f",
                                epoch, loss, ndcg)
                if ndcg > best_metric + 1e-5:
                    best_metric = ndcg
                    best_params = {k: p.detach().clone() for k, p in params.items()}
                    self.best_iteration = epoch
                    patience = 0
                else:
                    patience += 1
                    if patience >= self.early_stop_rounds:
                        logger.info("Early stop at epoch %d (best %d, ndcg %.4f)",
                                    epoch, self.best_iteration, best_metric)
                        break
            else:
                best_params = {k: p.detach().clone() for k, p in params.items()}
                self.best_iteration = epoch

        self.params = best_params
        self._trained = True
        return self.evals_result

    @staticmethod
    @torch.no_grad()
    def _valid_ndcg(params, xs, gs, ms, k: int = 10) -> float:
        vals, valid = group_ndcg_at_k(mlp_score(params, xs), gs, ms, k)
        v = valid.float()
        return float((vals * v).sum() / v.sum().clamp(min=1.0))

    # ------------------------------------------------------------------ #

    def predict(self, features) -> np.ndarray:
        """Score a frame (column dict) or an (n, F) array. With
        ``query_norm``: a frame with a ``query_id`` column is normalised
        per query, anything else as ONE candidate set (the serving case)."""
        if not self._trained:
            raise RuntimeError("Ranker not trained. Call train() or load().")
        q = None
        if isinstance(features, Mapping):
            if self.query_norm and "query_id" in features:
                _, q = np.unique(np.asarray(features["query_id"]), return_inverse=True)
            X = feature_matrix(features, self.feature_names)
        else:
            X = np.asarray(features, np.float32)
        x = torch.as_tensor(np.ascontiguousarray(self._standardize(X, q)),
                            device=self.device)
        with torch.no_grad():
            return mlp_score(self.params, x).cpu().numpy()

    def predict_device(self, x_standardized: torch.Tensor) -> torch.Tensor:
        """Device-to-device scoring of input already standardised by
        :meth:`standardize_device`."""
        return mlp_score(self.params, x_standardized)

    def standardize_device(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.as_tensor(self.feat_mean, device=x.device)
        std = torch.as_tensor(self.feat_std, device=x.device)
        return (x - mean) / std

    def make_device_scorer(self):
        """Raw (…, C, F) candidate features → (…, C) scores on the device.

        With ``query_norm`` each feature is standardised over the candidate
        axis: (h − mean) / (std + 1e-6), std the population one (ddof 0, as
        ``jnp.std``). The values are first shifted by the first candidate's
        row — the same standardisation in exact arithmetic — so a column
        that is constant over the candidates (every user feature) becomes
        exactly 0. Unshifted, as in ``ranker.py:508-510``, its mean differs
        from the value by rounding, and that ~1e-7 residue divided by
        ~1e-6 feeds O(0.1) noise into the MLP (ROADMAP, queue C)."""
        params = self.params
        mean = torch.as_tensor(self.feat_mean, dtype=torch.float32, device=self.device)
        std = torch.as_tensor(self.feat_std, dtype=torch.float32, device=self.device)
        qn = self.query_norm

        def score(x: torch.Tensor) -> torch.Tensor:
            h = (x - mean) / std
            if qn:
                h = h - h[..., :1, :]
                m = h.mean(dim=-2, keepdim=True)
                s = h.std(dim=-2, keepdim=True, correction=0) + 1e-6
                h = (h - m) / s
            return mlp_score(params, h)

        return score

    # ------------------------------------------------------------------ #

    def feature_importance(self, n_samples: int = 512) -> Dict[str, float]:
        """Gradient-magnitude importance: mean |∂score/∂x_j| over standard
        normal inputs drawn from a generator seeded with 0 (JAX draws them
        from ``PRNGKey(0)``, so the two packages' samples differ)."""
        if not self._trained:
            raise RuntimeError("Ranker not trained.")
        x = torch.randn((n_samples, self.n_features),
                        generator=torch.Generator().manual_seed(0))
        x = x.to(self.device).requires_grad_(True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(mlp_score(self.params, x).sum(), x)
        imp = grad.abs().mean(0).cpu().numpy()
        return dict(zip(self.feature_names, imp.tolist()))

    def top_features(self, n: int = 10) -> List[Tuple[str, float]]:
        imp = self.feature_importance()
        return sorted(imp.items(), key=lambda kv: -kv[1])[:n]

    # ------------------------------------------------------------------ #

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, feat_mean=self.feat_mean, feat_std=self.feat_std,
                 **{k: v.detach().cpu().numpy() for k, v in self.params.items()})
        meta = {
            "feature_names": self.feature_names,
            "hidden_dims": list(self.hidden_dims),
            "label_gain": list(self.label_gain),
            "eval_at": list(self.eval_at),
            "group_size": self.group_size,
            "best_iteration": self.best_iteration,
            "loss_type": self.loss_type,
            "query_norm": self.query_norm,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))
        logger.info("Saved ranker to %s", p)

    @classmethod
    def load(cls, path: str, device=DEFAULT_DEVICE) -> "LambdaRankScorer":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Ranker not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        scorer = cls(
            feature_names=meta["feature_names"],
            hidden_dims=meta["hidden_dims"],
            label_gain=meta["label_gain"],
            eval_at=meta["eval_at"],
            group_size=meta["group_size"],
            loss_type=meta.get("loss_type", "lambdarank"),
            query_norm=meta.get("query_norm", False),
            device=device,
        )
        with np.load(p) as data:
            scorer.feat_mean = np.asarray(data["feat_mean"], np.float32)
            scorer.feat_std = np.asarray(data["feat_std"], np.float32)
            scorer.params = {
                k: torch.as_tensor(data[k], dtype=torch.float32, device=device)
                for k in data.files if k not in ("feat_mean", "feat_std")
            }
        scorer.best_iteration = meta.get("best_iteration", 0)
        scorer._trained = True
        return scorer

    def model_info(self) -> Dict:
        if not self._trained:
            return {"trained": False}
        n_params = sum(int(np.prod(v.shape)) for v in self.params.values())
        return {
            "trained": True,
            "model_type": f"{self.loss_type}-mlp",
            "query_norm": self.query_norm,
            "n_features": self.n_features,
            "hidden_dims": list(self.hidden_dims),
            "n_parameters": n_params,
            "best_iteration": self.best_iteration,
            "top_features": [
                {"feature": f, "importance": round(v, 6)}
                for f, v in self.top_features(10)
            ],
        }


# JAX's alias of the reference's class name
LightGBMRanker = LambdaRankScorer
