"""Pipeline orchestrator CLI — torch port.

Counterpart of ``recommendit_tpu/pipelines/run_pipeline.py``: the stages
``data``, ``features``, ``load_features``, ``embeddings``, ``index``,
``ranker``, ``evaluate`` and ``skew``, with per-stage timing, and ``all``,
which runs them in JAX's order (data, features, embeddings, index, ranker,
load_features, skew, evaluate). The stages run on the card unless
``--device cpu`` is given.

    python -m recommendit_tpu_torch.pipelines.run_pipeline --stage all \\
        --data-dir data/ml-1m --models-dir models

Nothing is downloaded: the ML-1M files (``ratings.dat``, ``users.dat``,
``movies.dat``, ``README``) are placed in ``--data-dir`` by hand, and the
``data`` stage checks that they are there; ``--synthetic`` writes a
synthetic set there instead. ``embeddings`` keeps a train-state
checkpoint at ``<models-dir>/two_tower_ckpt/best`` (a ``torch.save`` file)
and resumes from it when it exists, as JAX's stage does from its Orbax
directory. ``load_features`` loads the feature files into the feature
store and writes ``features.fsnap`` beside them.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from itertools import islice
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from recommendit_tpu_torch.config import Settings, settings as default_settings
from recommendit_tpu_torch.data.movielens import (
    MovieLensData,
    load_or_synthesize,
    save_movielens,
    timestamp_order,
    verify_dataset,
)
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.evaluation.metrics import (
    detect_training_serving_skew,
    evaluate_model,
    ndcg_at_k,
)
from recommendit_tpu_torch.features.engineering import (
    ITEM_FILE,
    USER_FILE,
    FeatureEngineer,
)
from recommendit_tpu_torch.features.schema import (
    FEATURE_COLUMNS,
    assemble_packed_np,
    pack_item_features,
    pack_user_features,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from recommendit_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger(__name__)

STAGES = ["all", "data", "features", "load_features", "embeddings", "index",
          "ranker", "evaluate", "skew"]
ALL_STAGES = ["data", "features", "embeddings", "index", "ranker",
              "load_features", "skew", "evaluate"]
EVAL_SPLIT = 0.9       # the evaluate stage's temporal cut (reference protocol)
SKEW_PAIRS = 4000      # training pairs the skew stage compares


def _group_items(user_id: np.ndarray, item_id: np.ndarray) -> Dict[int, np.ndarray]:
    """Each user's items in row order, by user id (``groupby("user_id")``)."""
    order = np.argsort(user_id, kind="stable")
    users, starts = np.unique(user_id[order], return_index=True)
    items = np.split(item_id[order], starts[1:])
    return dict(zip(users.tolist(), items))


class TemporalSplit(NamedTuple):
    train_rows: np.ndarray               # the first EVAL_SPLIT of the rows by time
    truth: Dict[int, List[int]]          # each user's held-out positives
    users: List[int]                     # the first eval_users of truth's users
    seen_train: Dict[int, set]           # each user's train-time items, or {}


def temporal_split(data: MovieLensData, eval_users: int,
                   filter_seen: bool) -> TemporalSplit:
    """The reference's temporal protocol: the ratings in pandas' timestamp
    order (C.11), the last 10 % held out, relevance = rating ≥ 4, the
    users with held-out positives by user id and, with ``filter_seen``,
    each user's train-time items."""
    order = timestamp_order(data.timestamp)
    cut = int(len(order) * EVAL_SPLIT)
    train_rows, test_rows = order[:cut], order[cut:]
    test_rows = test_rows[data.rating[test_rows] >= 4]
    truth = {u: items.tolist() for u, items in _group_items(
        data.user_id[test_rows], data.item_id[test_rows]).items()}
    seen_train = (
        {u: set(items.tolist()) for u, items in _group_items(
            data.user_id[train_rows], data.item_id[train_rows]).items()}
        if filter_seen else {})
    return TemporalSplit(train_rows, truth, list(truth)[:eval_users], seen_train)


def first_unseen(seen_train: Dict[int, set], u: int, ordered_ids, k: int = 20) -> List[int]:
    """The first ``k`` of ``ordered_ids`` that user ``u`` did not rate in
    train."""
    s = seen_train.get(u, ())
    return list(islice((int(i) for i in ordered_ids if i not in s), k))


class PipelineOrchestrator:
    def __init__(
        self,
        cfg: Optional[Settings] = None,
        data_dir: Optional[str] = None,
        models_dir: str = "models",
        features_dir: str = "data/features",
        synthetic: bool = False,
        eval_users: int = 200,
        respect_cfg_paths: bool = False,
        device=DEFAULT_DEVICE,
    ):
        self.cfg = cfg or default_settings
        self.data_dir = data_dir or self.cfg.DATA_DIR
        self.models_dir = Path(models_dir)
        self.features_dir = features_dir
        self.synthetic = synthetic
        self.eval_users = eval_users
        self.device = resolve_device(device)
        self.stage_times: Dict[str, float] = {}
        # the evaluate stage's ranked lists, by row ("full", "popularity",
        # "retrieval_only") and user
        self.eval_lists: Dict[str, Dict[int, List[int]]] = {}
        # the ranker stage's trainer (its holdout frame and report)
        self.ranker_trainer = None
        self._data: Optional[MovieLensData] = None
        # the artifacts go into models_dir; respect_cfg_paths=True keeps any
        # path the caller set away from its Settings default
        remap = {
            "EMBEDDING_MODEL_PATH": str(self.models_dir / "two_tower.npz"),
            "INDEX_PATH": str(self.models_dir / "mips.index.npz"),
            "RANKER_MODEL_PATH": str(self.models_dir / "ranker.npz"),
        }
        if respect_cfg_paths:
            defaults = Settings()
            remap = {k: v for k, v in remap.items()
                     if getattr(self.cfg, k) == getattr(defaults, k)}
        self.cfg = self.cfg.replace(**remap, DATA_DIR=self.data_dir)

    # ------------------------------------------------------------------ #

    def _timed(self, name: str, fn):
        logger.info("=== stage: %s ===", name)
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        self.stage_times[name] = dt
        logger.info("=== stage %s done in %.2fs ===", name, dt)
        return out

    def _synthesize(self) -> MovieLensData:
        data = make_synthetic_movielens(
            n_users=self.cfg.SYNTH_USERS, n_items=self.cfg.SYNTH_ITEMS,
            n_ratings=self.cfg.SYNTH_RATINGS, seed=self.cfg.SEED)
        save_movielens(data, self.data_dir)
        return data

    def _load_data(self) -> MovieLensData:
        if self._data is None:
            if self.synthetic and not verify_dataset(Path(self.data_dir)):
                self._synthesize()
            self._data = load_or_synthesize(self.data_dir, seed=self.cfg.SEED)
        return self._data

    def _train_view(self) -> MovieLensData:
        """The temporal train split the training stages see: the first
        ``TRAIN_SPLIT_FRACTION`` of the ratings by time (C.11's order); the
        users table and the catalog stay whole."""
        return self._load_data().train_view(self.cfg.TRAIN_SPLIT_FRACTION)

    # ------------------------------------------------------------------ #
    # Stages                                                               #
    # ------------------------------------------------------------------ #

    def run_data(self):
        if self.synthetic:
            self._data = self._synthesize()
            logger.info("Synthetic dataset written to %s", self.data_dir)
        elif verify_dataset(Path(self.data_dir)):
            logger.info("Dataset already present at %s", self.data_dir)
        else:
            raise RuntimeError(
                "downloading MovieLens-1M needs the network; place "
                "ratings.dat, users.dat, movies.dat and README in "
                f"{self.data_dir} by hand, or pass --synthetic")

    def run_features(self):
        fe = FeatureEngineer(seed=self.cfg.SEED)
        fe.set_data(self._train_view())
        fe.build_user_features()
        fe.build_item_features()
        fe.save_features(self.features_dir)

    def run_load_features(self):
        """The feature files into the store, and the ``features.fsnap``
        snapshot beside them (serving processes map it and skip the bulk
        load)."""
        from recommendit_tpu_torch.features.snapshot import write_snapshot_from_frames
        from recommendit_tpu_torch.features.store import FeatureStore

        store = FeatureStore(self.cfg.REDIS_URL, ttl=self.cfg.FEATURE_CACHE_TTL_SECONDS)
        tables = []
        for name in (USER_FILE, ITEM_FILE):
            with np.load(Path(self.features_dir) / name) as z:
                tables.append({c: z[c] for c in z.files})
        store.load_all_features(*tables)
        write_snapshot_from_frames(str(Path(self.features_dir) / "features.fsnap"),
                                   *tables)
        logger.info("Store stats: %s", store.stats())

    def run_embeddings(self, resume: bool = True):
        """Train the towers on the train view, saving the train state at
        every best epoch and, with ``resume``, resuming from
        ``two_tower_ckpt/best`` when it exists. With ``HOST_TABLE`` the
        host-table trainer runs instead (tables in host RAM or a memmap, no
        checkpoints); where its tables exceed the in-HBM budget it writes no
        model, and ``run_index`` streams the catalog through it."""
        from recommendit_tpu_torch.training.train_embeddings import EmbeddingTrainer

        if self.cfg.HOST_TABLE:
            from recommendit_tpu_torch.training.host_train import (
                HostTableEmbeddingTrainer,
            )

            trainer = HostTableEmbeddingTrainer(
                self._train_view(), self.cfg,
                model_output_path=self.cfg.EMBEDDING_MODEL_PATH, device=self.device)
            if trainer.train() is None:
                self._host_trainer = trainer
            return trainer.history
        ckpt_dir = self.models_dir / "two_tower_ckpt"
        trainer = EmbeddingTrainer(self._train_view(), self.cfg,
                                   model_output_path=self.cfg.EMBEDDING_MODEL_PATH,
                                   ckpt_dir=str(ckpt_dir), device=self.device)
        resume_from = None
        best = ckpt_dir / "best"
        if resume and best.exists():
            logger.info("Found checkpoint at %s — resuming", best)
            resume_from = str(best)
        trainer.train(resume_from=resume_from)
        return trainer.history

    def run_index(self):
        """Build the index from the saved model or, after a host-table run
        with no in-HBM model, from its catalog streamed through the item
        head (with its raw item bias in softmax mode)."""
        from recommendit_tpu_torch.training.build_index import IndexBuilder

        builder = IndexBuilder(self._train_view(), self.cfg,
                               model_path=self.cfg.EMBEDDING_MODEL_PATH,
                               index_output_path=self.cfg.INDEX_PATH,
                               device=self.device)
        ht = getattr(self, "_host_trainer", None)
        if ht is None:
            builder.build()
            return
        bias = ht._dense.get("item_bias")
        builder.build(embeddings=ht.embed_catalog(),
                      bias=None if bias is None else bias[1:].cpu().numpy())

    def run_ranker(self) -> Dict:
        from recommendit_tpu_torch.training.train_ranker import RankerTrainer

        self.ranker_trainer = RankerTrainer(
            self._train_view(), self.cfg,
            ranker_output_path=self.cfg.RANKER_MODEL_PATH,
            features_dir=self.features_dir, device=self.device)
        self.ranker_trainer.run()
        return self.ranker_trainer.holdout_metrics

    def run_evaluate(self) -> Dict:
        """Temporal-split offline evaluation through the serving pipeline
        (last 10 % by time, relevance = rating ≥ 4, K ∈ {5, 10, 20}, the
        first ``eval_users`` users with held-out positives by user id),
        with the popularity and retrieval-only rows and the paired NDCG@10
        statistic. The serving pipeline sees only the train view."""
        from recommendit_tpu_torch.serving.recommender import (
            RecommendationPipeline,
            popularity_order,
        )

        data = self._load_data()
        # every row filters the user's train-time items when FILTER_SEEN is
        # on, as the serve path does
        split = temporal_split(data, self.eval_users, self.cfg.FILTER_SEEN)
        truth, users = split.truth, split.users

        pipeline = RecommendationPipeline(
            model_path=self.cfg.EMBEDDING_MODEL_PATH,
            index_path=self.cfg.INDEX_PATH,
            ranker_path=self.cfg.RANKER_MODEL_PATH,
            features_dir=self.features_dir, cfg=self.cfg, device=self.device)
        pipeline.load(self._train_view())
        recs = pipeline.batch_recommend(users, k=20)

        pop_all = popularity_order(data.item_id[split.train_rows]).tolist()
        pop_recs = {u: first_unseen(split.seen_train, u, pop_all) for u in users}
        self.eval_lists = {"full": recs, "popularity": pop_recs}
        report = evaluate_model(recs, truth, k_values=[5, 10, 20],
                                catalog_size=data.n_items)
        pop_report = evaluate_model(pop_recs, truth, k_values=[10, 20])
        report["popularity_ndcg@10"] = pop_report["ndcg@10"]
        report["popularity_recall@20"] = pop_report["recall@20"]
        report["popularity_mrr"] = pop_report["mrr"]

        known = [u for u in users if 1 <= u <= pipeline.model.n_users]
        if known:
            q = np.stack([pipeline.model.get_user_embedding(u) for u in known])
            k_search = (min(self.cfg.TOP_K_CANDIDATES, pipeline.index.n_total)
                        if self.cfg.FILTER_SEEN else 20)
            _, ids = pipeline.index.batch_search(q, k=k_search)
            retr_recs = {u: first_unseen(split.seen_train, u, ids[i].tolist())
                         for i, u in enumerate(known)}
            self.eval_lists["retrieval_only"] = retr_recs
            retr_report = evaluate_model(retr_recs, truth, k_values=[10, 20])
            report["retrieval_only_ndcg@10"] = retr_report["ndcg@10"]
            report["retrieval_only_recall@20"] = retr_report["recall@20"]
            report["retrieval_only_mrr"] = retr_report["mrr"]

            # the two rows score the same users: the paired difference
            d = np.asarray([
                ndcg_at_k(recs.get(u, []), truth[u], 10)
                - ndcg_at_k(retr_recs[u], truth[u], 10)
                for u in known if truth.get(u)
            ])
            if len(d) > 1:
                se = float(d.std(ddof=1) / np.sqrt(len(d)))
                report["paired_ndcg10_full_minus_retrieval"] = float(d.mean())
                report["paired_ndcg10_se"] = se
                report["paired_ndcg10_t"] = float(d.mean() / se) if se > 0 else 0.0

        out = self.models_dir / "evaluation.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2, default=float))
        logger.info("Evaluation written to %s", out)
        return report

    def run_skew(self) -> Dict:
        """Training-serving skew check: the offline feature join of a
        sample of training pairs against the packed-table assembly of the
        same (user, item) pairs. With one contract the two agree (max KL
        0); a nonzero report means the contract drifted."""
        data = self._train_view()
        fe = FeatureEngineer(seed=self.cfg.SEED)
        fe.set_data(data)
        fe.load_features(self.features_dir)
        if fe.user_features is None or fe.item_features is None:
            fe.build_user_features()
            fe.build_item_features()

        pairs, _ = fe.build_training_pairs(n_negatives=2, seed=self.cfg.SEED)
        # DataFrame.sample(n, random_state=SEED): a RandomState permutation's
        # first n rows
        n = len(pairs["label"])
        take = np.random.RandomState(self.cfg.SEED).permutation(n)[:min(SKEW_PAIRS, n)]
        sample = {c: a[take] for c, a in pairs.items()}
        train_feats = fe.build_interaction_features(sample)

        user_table = pack_user_features(fe.user_features, data.n_users)
        item_table = pack_item_features(fe.item_features, data.n_items)
        rows = np.stack([
            assemble_packed_np(user_table[int(u)], item_table[np.array([int(i)])])[0]
            for u, i in zip(sample["user_id"].tolist(), sample["item_id"].tolist())
        ]) if n else np.zeros((0, len(FEATURE_COLUMNS)), np.float32)
        serving_feats = {c: rows[:, j] for j, c in enumerate(FEATURE_COLUMNS)}

        report = detect_training_serving_skew(
            {c: train_feats[c] for c in FEATURE_COLUMNS}, serving_feats,
            threshold=self.cfg.SKEW_KL_THRESHOLD)
        out = self.models_dir / "skew_report.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2, default=float))
        logger.info("Skew check: max_kl=%.6f detected=%s (report → %s)",
                    report["max_kl"], report["skew_detected"], out)
        return report

    # ------------------------------------------------------------------ #

    def run_stage(self, stage: str):
        if stage not in STAGES:
            raise ValueError(f"Unknown stage {stage}; choose from {STAGES}")
        if stage == "all":
            return self.run_all()
        return self._timed(stage, getattr(self, f"run_{stage}"))

    def run_all(self):
        out = None
        for stage in ALL_STAGES:
            out = self._timed(stage, getattr(self, f"run_{stage}"))
        logger.info("Stage times: %s",
                    {k: round(v, 2) for k, v in self.stage_times.items()})
        return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="recommendit_tpu_torch pipeline")
    parser.add_argument("--stage", choices=STAGES, default="all")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--models-dir", default="models")
    parser.add_argument("--features-dir", default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="generate synthetic MovieLens-format data")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--eval-users", type=int, default=200)
    parser.add_argument("--log-level", default=None)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="where the stages run (default: the card)")
    args = parser.parse_args(argv)

    cfg = default_settings
    if args.epochs:
        cfg = cfg.replace(TRAIN_EPOCHS=args.epochs)
    setup_logging(args.log_level or cfg.LOG_LEVEL)
    orch = PipelineOrchestrator(
        cfg=cfg,
        data_dir=args.data_dir,
        models_dir=args.models_dir,
        features_dir=args.features_dir or (
            str(Path(args.data_dir).parent / "features") if args.data_dir
            else "data/features"),
        synthetic=args.synthetic,
        eval_users=args.eval_users,
        device=args.device,
    )
    result = orch.run_stage(args.stage)
    if isinstance(result, dict):
        print(json.dumps(result, indent=2, default=float))
    return result


if __name__ == "__main__":
    main()
