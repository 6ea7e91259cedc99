"""Ranker training stage — torch port.

Counterpart of ``recommendit_tpu/training/train_ranker.py`` (``RankerTrainer``)
on the port's column dicts in place of DataFrames. By default
(``RANKER_TRAINING_MODE=candidates``) the ranker learns from the serving
distribution: for each of ``RANKER_CAND_FOLDS`` inner temporal splits of
the train view, an inner tower is trained on the history slice (the
port's ``EmbeddingTrainer``, so on the card each step launches the in-batch
BPR kernels), an exact index with the bias column retrieves the top
``TOP_K_CANDIDATES`` for every user with a positive in the label slice,
and the seen-filtered candidates are labelled by that slice and assembled
from the history slice's packed tables; every positive is kept, with the
head of the retrieval order and a uniform sample of the tail as
negatives. Users are split 9/1 for the holdout report (NDCG@10/20,
Recall@20, and the retrieval order's NDCG@10 on the same groups). When
the candidate frames cannot be built (``RuntimeError``), it falls back to
the reference's training pairs, with hard negatives mined from the
trained tower and its ``retrieval_score``.

Every data step repeats what the JAX module's pandas calls compute, so the
frames equal JAX's given the same towers:

* ``sort_values`` on one column is pandas' ``nargsort``: numpy's
  quicksort argsort (not stable) for ascending; for descending, the
  reversed values sorted, mapped back and reversed (:func:`pandas_order`);
  the train view is sorted by timestamp again with
  ``data/movielens.timestamp_order`` (C.11: sorting sorted data with an
  unstable sort may move ties);
* ``dropna``, ``unique()`` in order of appearance (C.24), ``isin``;
* the random draws come from numpy generators seeded and drawn as JAX
  draws them: ``default_rng(SEED)`` for the 9/1 user split and then the
  valid split, ``default_rng(SEED + 1_000_003·(j+1))`` for fold j's query
  subsample and tail negatives.

``RANKER_FOLD_CACHE_DIR`` caches a fold's frame as ``.npz`` (the GPU
machine has no pyarrow for JAX's parquet). ``RANKER_TYPE=gbdt`` trains the
histogram GBDT (``models/gbdt.py``) on the same frames in place of the
MLP, with JAX's ``GBDT_*`` settings.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from recommendit_tpu_torch.config import Settings, settings as default_settings
from recommendit_tpu_torch.data.movielens import MovieLensData, timestamp_order
from recommendit_tpu_torch.evaluation.metrics import ndcg_at_k, recall_at_k
from recommendit_tpu_torch.features.engineering import FeatureEngineer, unique_in_order
from recommendit_tpu_torch.features.schema import (
    FEATURE_COLUMNS,
    Columns,
    assemble_packed_np,
    pack_item_features,
    pack_user_features,
)
from recommendit_tpu_torch.models.gbdt import HistGBDTRanker
from recommendit_tpu_torch.models.ranker import LambdaRankScorer
from recommendit_tpu_torch.models.retrieval import MIPSIndex
from recommendit_tpu_torch.models.two_tower import TwoTower
from recommendit_tpu_torch.training.train_embeddings import (
    EmbeddingTrainer,
    build_genre_table,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

logger = logging.getLogger(__name__)


def pandas_order(values: np.ndarray, ascending: bool = True) -> np.ndarray:
    """The row order ``sort_values`` gives a NaN-free column: pandas'
    ``nargsort`` with its default quicksort."""
    values = np.asarray(values)
    if ascending:
        return values.argsort(kind="quicksort")
    idx = np.arange(len(values))[::-1]
    return idx[values[::-1].argsort(kind="quicksort")][::-1]


def take(frame: Mapping[str, np.ndarray], rows) -> Columns:
    """The frame's rows ``rows`` (indices or a boolean mask), every column."""
    return {c: np.asarray(a)[rows] for c, a in frame.items()}


def concat(frames: List[Columns]) -> Columns:
    return {c: np.concatenate([f[c] for f in frames]) for c in frames[0]}


def _rows(data: MovieLensData, rows: np.ndarray) -> MovieLensData:
    """The ratings ``rows`` of ``data``, with its users table and catalog."""
    return dataclasses.replace(data, user_id=data.user_id[rows],
                               item_id=data.item_id[rows],
                               rating=data.rating[rows],
                               timestamp=data.timestamp[rows])


def _items_by_user(user_id: np.ndarray, item_id: np.ndarray) -> Dict[int, set]:
    """Each user's set of items (``groupby("user_id")["item_id"]``)."""
    out: Dict[int, set] = {}
    for u, i in zip(user_id.tolist(), item_id.tolist()):
        out.setdefault(u, set()).add(i)
    return out


class RankerTrainer:
    def __init__(self, data: MovieLensData, cfg: Optional[Settings] = None,
                 feature_engineer: Optional[FeatureEngineer] = None,
                 ranker_output_path: Optional[str] = None,
                 features_dir: Optional[str] = None, device=DEFAULT_DEVICE):
        self.cfg = cfg or default_settings
        self.data = data
        self.fe = feature_engineer
        self.ranker_output_path = ranker_output_path or self.cfg.RANKER_MODEL_PATH
        self.features_dir = features_dir
        self.device = resolve_device(device)
        self.holdout_metrics: Dict[str, float] = {}
        # after run: the ranker, its holdout frame and its columns
        self.ranker: Optional[Union[LambdaRankScorer, HistGBDTRanker]] = None
        self.test_feats: Optional[Columns] = None
        self.feature_cols: List[str] = []
        self._tower_cache = None

    def run(self) -> Union[LambdaRankScorer, HistGBDTRanker]:
        cfg = self.cfg
        fe = self.fe
        if fe is None:
            fe = FeatureEngineer(seed=cfg.SEED)
            fe.set_data(self.data)
        if fe.user_features is None or fe.item_features is None:
            if self.features_dir:
                fe.load_features(self.features_dir)
            if fe.user_features is None or fe.item_features is None:
                fe.build_user_features()
                fe.build_item_features()

        cols = list(FEATURE_COLUMNS)
        frames = None
        if cfg.RANKER_TRAINING_MODE == "candidates":
            try:
                frames = self._build_candidate_frames()
            except RuntimeError as exc:
                logger.warning("candidate ranker training unavailable (%s) — "
                               "falling back to pair training", exc)
        if frames is not None:
            train_feats, test_feats, tower_cols = frames
            cols = cols + tower_cols
        else:
            train_pairs, test_pairs = fe.build_training_pairs(
                n_negatives=cfg.N_NEGATIVES, seed=cfg.SEED)
            if cfg.RANKER_HARD_NEG_FRAC > 0.0:
                train_pairs = self._mine_hard_negatives(train_pairs)
            train_feats = fe.build_interaction_features(train_pairs)
            test_feats = fe.build_interaction_features(test_pairs)
            if cfg.RANKER_USE_RETRIEVAL_SCORE:
                cols = cols + self._add_retrieval_score(train_feats, test_feats)
        train_feats, test_feats = (self._sorted_complete(f, cols)
                                   for f in (train_feats, test_feats))

        # train split into train/valid by query for early stopping
        queries = unique_in_order(train_feats["query_id"]).copy()
        rng = np.random.default_rng(cfg.SEED)
        rng.shuffle(queries)
        n_valid = max(1, len(queries) // 10)
        is_valid = np.isin(train_feats["query_id"], queries[:n_valid])
        valid_df, fit_df = take(train_feats, is_valid), take(train_feats, ~is_valid)

        if cfg.RANKER_TYPE == "gbdt":
            ranker = HistGBDTRanker(
                n_estimators=cfg.GBDT_N_ESTIMATORS,
                learning_rate=cfg.GBDT_LEARNING_RATE,
                max_depth=cfg.GBDT_MAX_DEPTH,
                n_bins=cfg.GBDT_N_BINS,
                label_gain=cfg.RANKER_LABEL_GAIN,
                early_stop_rounds=max(10, cfg.RANKER_EARLY_STOP_ROUNDS * 4),
                seed=cfg.SEED,
                device=self.device,
            )
        else:
            ranker = LambdaRankScorer(
                hidden_dims=cfg.RANKER_HIDDEN_DIMS,
                learning_rate=cfg.RANKER_LEARNING_RATE,
                epochs=cfg.RANKER_EPOCHS,
                group_size=cfg.RANKER_GROUP_SIZE,
                label_gain=cfg.RANKER_LABEL_GAIN,
                eval_at=cfg.RANKER_EVAL_AT,
                early_stop_rounds=cfg.RANKER_EARLY_STOP_ROUNDS,
                seed=cfg.SEED,
                loss_type=cfg.RANKER_LOSS_TYPE,
                query_norm=cfg.RANKER_QUERY_NORM,
                device=self.device,
            )
        ranker.train(fit_df, cols, valid_df=valid_df)

        self.ranker, self.test_feats, self.feature_cols = ranker, test_feats, cols
        self.holdout_metrics = self._evaluate_holdout(ranker, test_feats, cols)
        logger.info("Holdout: %s", self.holdout_metrics)

        ranker.save(self.ranker_output_path)
        for feat, imp in ranker.top_features(10):
            logger.info("importance | %-28s %.5f", feat, imp)
        return ranker

    @staticmethod
    def _sorted_complete(frame: Columns, cols: List[str]) -> Columns:
        """``sort_values("query_id")`` then ``dropna(subset=cols)``."""
        frame = take(frame, pandas_order(frame["query_id"]))
        has_nan = np.zeros(len(frame["query_id"]), bool)
        for c in cols:
            has_nan |= np.isnan(frame[c])
        return take(frame, ~has_nan) if has_nan.any() else frame

    # ------------------------------------------------------------------ #
    # Candidate frames                                                     #
    # ------------------------------------------------------------------ #

    def _build_candidate_frames(self):
        """The ranker's frames from real retrieval candidates (see the
        module docstring): fold j labels on the slice ``[1-(j+1)f, 1-jf)``
        of the train view by time, with an inner tower trained on the
        ratings before it. Returns (train_feats, test_feats, extra_cols);
        users are split 9/1 with all their folds' groups together."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.SEED)
        r = _rows(self.data, timestamp_order(self.data.timestamp))
        f = cfg.RANKER_LABEL_FRACTION
        folds = max(1, cfg.RANKER_CAND_FOLDS)
        if folds * f > 0.5:
            raise RuntimeError(
                f"RANKER_CAND_FOLDS={folds} x RANKER_LABEL_FRACTION={f} "
                "would label more than half the training window")
        frames = []
        for j in range(folds):
            hi = int(len(r) * (1.0 - j * f))
            lo = int(len(r) * (1.0 - (j + 1) * f))
            try:
                frames.extend(self._fold_candidate_frames(
                    _rows(r, np.arange(lo)), _rows(r, np.arange(lo, hi)),
                    np.random.default_rng(cfg.SEED + 1_000_003 * (j + 1)), fold=j))
            except RuntimeError:
                if j == 0 or not frames:
                    raise
                logger.warning("candidate fold %d has no labelable users — "
                               "pooling the %d earlier fold(s) only", j, j)
                break
        all_feats = concat(frames)

        users = np.unique(all_feats["user_id"])
        rng.shuffle(users)
        n_test = max(1, len(users) // 10)
        is_test = np.isin(all_feats["user_id"], users[:n_test])
        test_feats, train_feats = take(all_feats, is_test), take(all_feats, ~is_test)
        logger.info("Candidate ranker training: %d folds, %d users (%d held out), "
                    "%d rows, %.4f positive rate", folds, len(users), n_test,
                    len(all_feats["label"]), all_feats["label"].mean())
        extra = []
        for col, keep in (("retrieval_score", cfg.RANKER_USE_RETRIEVAL_SCORE),
                          ("retrieval_rank", cfg.RANKER_USE_RETRIEVAL_RANK)):
            if keep:
                extra.append(col)
            else:
                del train_feats[col], test_feats[col]
        return train_feats, test_feats, extra

    def _fold_cache_path(self, fold: int, hist: MovieLensData,
                         label: MovieLensData) -> Optional[Path]:
        """Disk-cache path of one fold's candidate frame, keyed by the data
        slice, the inner-tower config and the candidate knobs (not the
        ranker's), or None unless ``RANKER_FOLD_CACHE_DIR`` is set."""
        d = self.cfg.RANKER_FOLD_CACHE_DIR
        if not d:
            return None
        cfg = self.cfg
        ts = hist.timestamp
        key = {
            "fold": fold, "n_hist": len(hist), "n_label": len(label),
            "t0": str(np.datetime64(int(ts[0]), "s")) if len(ts) else "",
            "t1": str(np.datetime64(int(ts[-1]), "s")) if len(ts) else "",
            "seed": cfg.SEED, "epochs": cfg.TRAIN_EPOCHS,
            "dim": cfg.EMBEDDING_DIM, "temp": cfg.SOFTMAX_TEMPERATURE,
            # every inner-tower knob that changes the frames is in the key
            "loss_mode": cfg.LOSS_MODE, "lr": cfg.LEARNING_RATE,
            "bs": cfg.BATCH_SIZE, "hidden": cfg.HIDDEN_DIM,
            "idx_dtype": cfg.INDEX_DTYPE, "k": cfg.TOP_K_CANDIDATES,
            "filter_seen": cfg.FILTER_SEEN, "negs": cfg.RANKER_CAND_NEGS,
            "max_q": cfg.RANKER_MAX_QUERIES,
            "label_frac": cfg.RANKER_LABEL_FRACTION,
        }
        h = hashlib.sha1(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]
        return Path(d) / f"cand_fold{fold}_{h}.npz"

    def _fold_candidate_frames(self, hist: MovieLensData, label: MovieLensData,
                               rng: np.random.Generator, fold: int = 0) -> List[Columns]:
        """One inner split's candidate frame: an inner tower trained on
        ``hist``, serving-shaped candidates, labels from ``label``. Query
        ids are offset per fold so group losses never mix folds."""
        cfg = self.cfg
        cache = self._fold_cache_path(fold, hist, label)
        if cache is not None and cache.exists():
            logger.info("fold %d candidate frame: cache hit (%s)", fold, cache)
            with np.load(cache) as z:
                return [{c: z[c] for c in z.files}]

        model = EmbeddingTrainer(hist, cfg, model_output_path="",
                                 device=self.device).train()
        genre_table = build_genre_table(hist.item_ids, hist.genres, model.n_items)
        item_ids = np.arange(1, model.n_items + 1, dtype=np.int64)
        item_embs = model.get_item_embeddings(item_ids, genre_table[1:])
        bias = cfg.SOFTMAX_TEMPERATURE * model.item_bias_np(item_ids)
        index = MIPSIndex(embedding_dim=model.embed_dim,
                          block_size=cfg.RETRIEVAL_BLOCK_ITEMS,
                          dtype=cfg.INDEX_DTYPE, quant_seed=cfg.SEED,
                          device=self.device)
        index.build(item_embs, item_ids, bias=bias if np.any(bias) else None)

        ife = FeatureEngineer(seed=cfg.SEED)
        ife.set_data(hist)
        ife.build_user_features()
        ife.build_item_features()
        user_table = pack_user_features(ife.user_features, hist.n_users)
        item_table = pack_item_features(ife.item_features, hist.n_items)

        # seen (history) and positive (label slice) items per user, dense
        n_cols = max(model.n_items, int(label.item_id.max(initial=0))) + 1
        n_rows = max(model.n_users, int(label.user_id.max(initial=0))) + 1
        seen = np.zeros((n_rows, n_cols), bool)
        seen[hist.user_id, hist.item_id] = True
        liked = label.rating >= 4
        pos = np.zeros_like(seen)
        pos[label.user_id[liked], label.item_id[liked]] = True
        users = np.unique(label.user_id[liked])
        users = users[(users >= 1) & (users <= model.n_users)]
        if not len(users):
            raise RuntimeError(
                "candidate ranker training: no users with label-window "
                "positives — dataset too small for "
                f"RANKER_LABEL_FRACTION={cfg.RANKER_LABEL_FRACTION}")
        if len(users) > cfg.RANKER_MAX_QUERIES:
            users = np.sort(rng.choice(users, size=cfg.RANKER_MAX_QUERIES, replace=False))
            logger.info("Candidate ranker training: subsampled to %d queries "
                        "(RANKER_MAX_QUERIES)", len(users))

        k = min(cfg.TOP_K_CANDIDATES, index.n_total)
        q = model.user_tower(torch.as_tensor(users, device=self.device)).cpu().numpy()
        vals, ids = index.batch_search(q, k=k)

        n_top = cfg.RANKER_CAND_NEGS // 2
        feats, scores, ranks, items, labels, counts = [], [], [], [], [], []
        for uix, u in enumerate(users.tolist()):
            cand, score = ids[uix], vals[uix].astype(np.float32)
            if cfg.FILTER_SEEN:
                keep = ~seen[u, cand]
                cand, score = cand[keep], score[keep]
            # retrieval position among unseen candidates, as serving ranks
            rank = np.arange(len(cand), dtype=np.float32)
            y = pos[u, cand]
            neg_idx = np.nonzero(~y)[0]
            # head of the retrieval order + uniform tail sample
            tail = neg_idx[n_top:]
            n_tail = min(cfg.RANKER_CAND_NEGS - n_top, len(tail))
            sel_neg = np.concatenate([
                neg_idx[:n_top],
                rng.choice(tail, size=n_tail, replace=False) if n_tail else tail[:0],
            ])
            sel = np.sort(np.concatenate([np.nonzero(y)[0], sel_neg]))
            feats.append(assemble_packed_np(user_table[u], item_table[cand[sel]]))
            scores.append(score[sel])
            ranks.append(np.log1p(rank[sel]))
            items.append(cand[sel])
            labels.append(y[sel].astype(np.int64))
            counts.append(len(sel))
        mat = np.concatenate(feats)
        out: Columns = {c: mat[:, j] for j, c in enumerate(FEATURE_COLUMNS)}
        out["retrieval_score"] = np.concatenate(scores)
        out["retrieval_rank"] = np.concatenate(ranks)
        out["query_id"] = np.repeat(users + fold * (model.n_users + 1), counts)
        out["user_id"] = np.repeat(users, counts)
        out["item_id"] = np.concatenate(items).astype(np.int64)
        out["label"] = np.concatenate(labels)
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache, **out)
            logger.info("fold %d candidate frame: cached to %s", fold, cache)
        return [out]

    # ------------------------------------------------------------------ #
    # Pair-mode features from the trained tower                            #
    # ------------------------------------------------------------------ #

    def _load_tower_embeddings(self):
        """(model, user_embs (n_users+1, D+1), item_embs (n_items, D+1))
        from the trained two-tower file, the bias folded into the last
        column as the serving index scores it ([e, T·b] · [u, 1]); None if
        the file is absent. Cached."""
        if self._tower_cache is not None:
            return self._tower_cache
        path = self.cfg.EMBEDDING_MODEL_PATH
        if not Path(path).exists():
            return None
        model = TwoTower.load(path, device=self.device)
        genre_table = build_genre_table(self.data.item_ids, self.data.genres,
                                        model.n_items)
        item_ids = np.arange(1, model.n_items + 1, dtype=np.int64)
        item_embs = model.get_item_embeddings(item_ids, genre_table[1:])
        bias = self.cfg.SOFTMAX_TEMPERATURE * model.item_bias_np(item_ids)
        item_embs = np.concatenate([item_embs, bias[:, None]], axis=1)
        all_uids = torch.arange(0, model.n_users + 1, device=self.device)
        user_embs = model.user_tower(all_uids).cpu().numpy()
        user_embs = np.concatenate(
            [user_embs, np.ones((len(user_embs), 1), user_embs.dtype)], axis=1)
        self._tower_cache = (model, user_embs, item_embs)
        return self._tower_cache

    def _mine_hard_negatives(self, pairs: Columns) -> Columns:
        """Replace ``RANKER_HARD_NEG_FRAC`` of each query's uniform negatives
        with the tower's top-scoring items the user did not rate (among
        its top ``RANKER_HARD_NEG_POOL``), skipping the user's current
        negatives."""
        cfg = self.cfg
        loaded = self._load_tower_embeddings()
        if loaded is None:
            logger.warning("RANKER_HARD_NEG_FRAC=%.2f but no tower model at %s — "
                           "keeping uniform negatives", cfg.RANKER_HARD_NEG_FRAC,
                           cfg.EMBEDDING_MODEL_PATH)
            return pairs
        model, user_embs, item_embs = loaded
        pool = min(cfg.RANKER_HARD_NEG_POOL, model.n_items)
        rated = _items_by_user(self.data.user_id, self.data.item_id)
        pairs = dict(pairs)
        neg_mask = pairs["label"] == 0
        users = pairs["user_id"]
        new_items = pairs["item_id"].copy()
        n_replaced = 0
        for u in np.unique(users):
            u_neg_idx = np.nonzero(neg_mask & (users == u))[0]
            n_hard = int(len(u_neg_idx) * cfg.RANKER_HARD_NEG_FRAC)
            if n_hard == 0 or u > model.n_users:
                continue
            top = np.argsort(-(item_embs @ user_embs[u]))[:pool] + 1
            u_rated = rated.get(int(u), set())
            keep = set(new_items[u_neg_idx].tolist())
            hard = [int(i) for i in top if i not in u_rated and i not in keep][:n_hard]
            new_items[u_neg_idx[:len(hard)]] = hard
            n_replaced += len(hard)
        pairs["item_id"] = new_items
        logger.info("Hard-negative mining: replaced %d/%d negatives (frac=%.2f, "
                    "pool=%d)", n_replaced, int(neg_mask.sum()),
                    cfg.RANKER_HARD_NEG_FRAC, pool)
        return pairs

    def _add_retrieval_score(self, *frames: Columns) -> List[str]:
        """Attach the trained tower's score of each (user, item) pair as
        ``retrieval_score`` (0 for an id out of range); [] without a tower."""
        loaded = self._load_tower_embeddings()
        if loaded is None:
            logger.warning("RANKER_USE_RETRIEVAL_SCORE set but no tower model at "
                           "%s — skipping the retrieval_score feature",
                           self.cfg.EMBEDDING_MODEL_PATH)
            return []
        model, user_embs, item_embs = loaded
        for frame in frames:
            uids = np.asarray(frame["user_id"]).astype(np.int64)
            iids = np.asarray(frame["item_id"]).astype(np.int64)
            u_ok = (uids >= 0) & (uids <= model.n_users)
            i_ok = (iids >= 1) & (iids <= model.n_items)
            ue = user_embs[np.where(u_ok, uids, 0)]
            ie = item_embs[np.where(i_ok, iids, 1) - 1]
            scores = np.einsum("nd,nd->n", ue, ie).astype(np.float32)
            frame["retrieval_score"] = np.where(u_ok & i_ok, scores, 0.0)
        return ["retrieval_score"]

    # ------------------------------------------------------------------ #

    def _evaluate_holdout(self, ranker, test_feats: Columns, cols) -> Dict[str, float]:
        """Per-query NDCG@10/20 and Recall@20 of the ranker's order over the
        held-out queries with a positive, and ``base_ndcg@10``: the
        retrieval order's NDCG@10 on the same groups (by rank, else by
        score), when a retrieval column is present."""
        scores = np.asarray(ranker.predict(test_feats))
        qid = np.asarray(test_feats["query_id"])
        item = np.asarray(test_feats["item_id"])
        label = np.asarray(test_feats["label"])
        base_col = next((c for c in ("retrieval_rank", "retrieval_score")
                         if c in test_feats), None)
        base = None
        if base_col is not None:
            # rank ascending = better; score descending = better
            sgn = -1.0 if base_col == "retrieval_rank" else 1.0
            base = sgn * np.asarray(test_feats[base_col])

        order = np.argsort(qid, kind="stable")
        bounds = np.nonzero(np.diff(qid[order]))[0] + 1
        ndcg10, ndcg20, rec20, base10 = [], [], [], []
        for rows in (np.split(order, bounds) if len(order) else []):
            g_item = item[rows]
            relevant = g_item[label[rows] == 1].tolist()
            if not relevant:
                continue
            ranked = g_item[pandas_order(scores[rows], ascending=False)].tolist()
            ndcg10.append(ndcg_at_k(ranked, relevant, 10))
            ndcg20.append(ndcg_at_k(ranked, relevant, 20))
            rec20.append(recall_at_k(ranked, relevant, 20))
            if base is not None:
                base_ranked = g_item[pandas_order(base[rows], ascending=False)].tolist()
                base10.append(ndcg_at_k(base_ranked, relevant, 10))
        out = {
            "ndcg@10": float(np.mean(ndcg10)) if ndcg10 else 0.0,
            "ndcg@20": float(np.mean(ndcg20)) if ndcg20 else 0.0,
            "recall@20": float(np.mean(rec20)) if rec20 else 0.0,
            "n_queries": len(ndcg10),
        }
        if base10:
            out["base_ndcg@10"] = float(np.mean(base10))
        return out
