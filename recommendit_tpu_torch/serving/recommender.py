"""End-to-end recommendation pipeline — torch port.

Counterpart of ``recommendit_tpu/serving/recommender.py``: cache → user
tower → top-C retrieval → packed feature assembly → ranker (blended with
the retrieval score) → seen mask → top-k, with the popularity fallback for
unknown users and the unseen-popularity backfill. The hot path runs on
``device`` as one chain of tensor ops per batch; a fused index sends
batches of 384 users or more through the window kernel
(``ops/mips_window.py``).

``load`` needs no pandas: it takes the port's ``MovieLensData`` — whose
ratings the packed feature tables are recomputed from when no fresh
snapshot is in ``features_dir`` — or plain arrays (:class:`ServeData`),
which need the snapshots; with neither it reads ``data_dir`` (or makes the
synthetic set). Online feature updates write the packed rows in place on
the device, and :meth:`RecommendationPipeline.enable_micro_batching`
coalesces concurrent requests into padded ``serve_batch`` buckets.
"""
from __future__ import annotations

import dataclasses
import logging
import statistics
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from recommendit_tpu_torch.config import Settings, settings as default_settings
from recommendit_tpu_torch.data.movielens import MovieLensData, load_or_synthesize
from recommendit_tpu_torch.features.engineering import (
    ITEM_SNAPSHOT,
    USER_FILE,
    USER_SNAPSHOT,
    FeatureEngineer,
)
from recommendit_tpu_torch.features.schema import (
    assemble_packed,
    item_dict_to_packed,
    pack_item_features,
    pack_user_features,
    pad_packed_width,
    user_dict_to_packed,
)
from recommendit_tpu_torch.features.store import FeatureStore
from recommendit_tpu_torch.models import MIPSIndex, TwoTower, load_ranker
from recommendit_tpu_torch.ops.seen import SeenSet, seen_mask
from recommendit_tpu_torch.ops.topk import fast_topk
from recommendit_tpu_torch.serving.batcher import MicroBatcher, QueueFullError
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from recommendit_tpu_torch.utils.latency import LatencyTracker

logger = logging.getLogger(__name__)

MAX_K = 100  # API cap (reference app.py:32 k<=100)
BUCKETS = (8, 32, 256, 1024)   # the micro-batcher's padded batch sizes


def micro_batch_buckets(max_batch: int) -> List[int]:
    """The padded batch sizes of a micro-batcher of ``max_batch``: each
    bucket up to it, or ``max_batch`` alone below the smallest."""
    return [b for b in BUCKETS if b <= max_batch] or [max_batch]


@dataclasses.dataclass
class RecommendationResult:
    item_id: int
    title: str
    score: float
    rank: int
    retrieval_score: float = 0.0
    genres: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeData:
    """What :meth:`RecommendationPipeline.load` reads besides the model
    files: the ratings' (user_id, item_id) columns, the catalog size and
    optional item titles and genre lists."""
    user_id: np.ndarray
    item_id: np.ndarray
    n_users: int = 0
    n_items: int = 0
    titles: Dict[int, str] = dataclasses.field(default_factory=dict)
    genres: Dict[int, List[str]] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_movielens(cls, data: MovieLensData) -> "ServeData":
        """From the port's ``MovieLensData``: its ratings, sizes, titles and
        genre lists."""
        ids = np.asarray(data.item_ids).astype(np.int64).tolist()
        return cls(
            user_id=data.user_id,
            item_id=data.item_id,
            n_users=int(data.n_users),
            n_items=int(data.n_items),
            titles=dict(zip(ids, [str(t) for t in data.titles.tolist()])),
            genres={i: str(g).split("|")
                    for i, g in zip(ids, data.genre_strs.tolist())},
        )


def popularity_order(item_id: np.ndarray) -> np.ndarray:
    """Item ids by rating count, most rated first.

    Ties fall as in the JAX pipeline, which orders with pandas'
    ``Series.sort_values(ascending=False)`` over the per-item counts:
    reverse, ascending quicksort, reverse."""
    items, counts = np.unique(np.asarray(item_id, np.int64), return_counts=True)
    rev = counts[::-1]
    pos = np.arange(len(counts))[::-1][rev.argsort(kind="quicksort")][::-1]
    return items[pos]


def _blend(scores, rvals, unseen, beta: float):
    """z(ranker) + beta · z(retrieval), both standardised over the unseen
    candidates (recommender.py:276-287)."""
    if beta <= 0.0:
        return scores
    m = unseen.float()
    cnt = m.sum(-1, keepdim=True).clamp(min=1.0)

    def _z(x):
        mu = (x * m).sum(-1, keepdim=True) / cnt
        var = (((x - mu) ** 2) * m).sum(-1, keepdim=True) / cnt
        return (x - mu) * torch.rsqrt(var + 1e-9)

    return _z(scores) + beta * _z(rvals)


def _with_extras(feats, rvals, unseen, extra_feats: List[str]):
    """Append the retrieval feature columns named by the ranker, in its
    training order: ``retrieval_score`` and ``retrieval_rank`` =
    log1p(max(position among unseen candidates, 0))."""
    cols = []
    for name in extra_feats:
        if name == "retrieval_score":
            cols.append(rvals)
        else:
            r = torch.cumsum(unseen.float(), dim=-1) - 1.0
            cols.append(torch.log1p(r.clamp(min=0.0)))
    if not cols:
        return feats
    return torch.cat([feats] + [c[..., None] for c in cols], dim=-1)


class RecommendationPipeline:
    """Two-stage serving pipeline on one device."""

    def __init__(self, model_path: Optional[str] = None,
                 index_path: Optional[str] = None,
                 ranker_path: Optional[str] = None,
                 redis_url: Optional[str] = None,
                 data_dir: Optional[str] = None,
                 features_dir: Optional[str] = None,
                 top_k_candidates: Optional[int] = None,
                 cfg: Optional[Settings] = None,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg or default_settings
        self.model_path = model_path or self.cfg.EMBEDDING_MODEL_PATH
        self.index_path = index_path or self.cfg.INDEX_PATH
        self.ranker_path = ranker_path or self.cfg.RANKER_MODEL_PATH
        self.redis_url = redis_url or self.cfg.REDIS_URL
        self.data_dir = data_dir or self.cfg.DATA_DIR
        self.features_dir = features_dir
        self.top_k_candidates = top_k_candidates or self.cfg.TOP_K_CANDIDATES
        self.device = resolve_device(device)

        self.model: Optional[TwoTower] = None
        self.index: Optional[MIPSIndex] = None
        self.ranker = None
        self.feature_store: Optional[FeatureStore] = None
        self._item_titles: Dict[int, str] = {}
        self._item_genres: Dict[int, List[str]] = {}
        self._popularity_fallback: List[int] = []
        self._seen: Optional[SeenSet] = None

        self.latency_tracker = LatencyTracker(1000)
        self.retrieval_latency = LatencyTracker(1000)
        self.ranking_latency = LatencyTracker(1000)
        self._cache_hits = 0
        self._cache_misses = 0
        self._loaded = False
        self._retrieval_fraction = 0.5
        self._stage_calibration: Dict[str, Any] = {"measured": False}
        self._calls_since_recal = 0
        self._recal_thread: Optional[threading.Thread] = None
        self._recal_lock = threading.Lock()
        self._batcher: Optional[MicroBatcher] = None
        # the micro-batcher's warm-up and its first live batch (host ms, the
        # copy to the host included)
        self._batch_timing: Dict[str, Any] = {}

    # --- load ------------------------------------------------------------ #

    def load(self, data=None) -> None:
        """Load the model files and build the serve path. ``data``: a
        ``MovieLensData`` or a :class:`ServeData`; by default the dataset
        in ``data_dir``, or the synthetic set where there is none (JAX's
        ``load_or_synthesize``). A ``features.fsnap`` in ``features_dir``
        backs the feature store, through the numpy reader."""
        t0 = time.time()
        self.model = TwoTower.load(self.model_path, device=self.device)
        self.index = MIPSIndex.load(self.index_path, device=self.device)
        self.ranker = load_ranker(self.ranker_path, device=self.device)
        self.feature_store = FeatureStore(
            redis_url=self.redis_url, ttl=self.cfg.FEATURE_CACHE_TTL_SECONDS)
        if self.features_dir:
            fsnap = Path(self.features_dir) / "features.fsnap"
            if fsnap.exists():
                from recommendit_tpu_torch.features.snapshot import FeatureSnapshot

                # the numpy reader: the C++ one reads no faster behind the
                # store (tools/snapshot_reader_ab.py) and would build at load
                self.feature_store.attach_snapshot(
                    FeatureSnapshot(str(fsnap), prefer_native=False))
                logger.info("Feature store backed by snapshot %s", fsnap)
        if data is None:
            data = load_or_synthesize(self.data_dir, seed=self.cfg.SEED)
        source = data
        if not isinstance(data, ServeData):
            data = ServeData.from_movielens(data)
        self._item_titles = dict(data.titles)
        self._item_genres = dict(data.genres)
        self._popularity_fallback = popularity_order(data.item_id).tolist()
        n_users = max(self.model.n_users, data.n_users,
                      int(np.max(data.user_id, initial=0)))
        n_items = max(self.model.n_items, data.n_items,
                      int(np.max(data.item_id, initial=0)))
        self._load_packed_tables(source, n_users, n_items)
        self._seen = (SeenSet(data.user_id, data.item_id, n_items)
                      if self.cfg.FILTER_SEEN else None)
        self._build_serve_fn()
        self._loaded = True
        logger.info("Pipeline loaded in %.2fs", time.time() - t0)

    def _load_packed_tables(self, data, n_users: int, n_items: int) -> None:
        """The packed user/item feature tables (JAX ``_build_packed_tables``).

        The ``.npy`` snapshots in ``features_dir`` are used when they are
        fresh (no newer ``user_features.npz``) and large enough. Otherwise
        the feature tables are loaded from ``features_dir`` or computed
        from ``data``'s ratings, packed, and written back as the snapshots
        (when there is a ``features_dir``). A :class:`ServeData` holds no
        ratings to compute from, so without a usable snapshot it raises."""
        snap_u = snap_i = None
        if self.features_dir:
            snap_u = Path(self.features_dir) / USER_SNAPSHOT
            snap_i = Path(self.features_dir) / ITEM_SNAPSHOT
            feats = Path(self.features_dir) / USER_FILE
            fresh = (snap_u.exists() and snap_i.exists()
                     and (not feats.exists()
                          or snap_u.stat().st_mtime >= feats.stat().st_mtime))
            if fresh:
                up = np.load(snap_u, mmap_mode="r")
                ip = np.load(snap_i, mmap_mode="r")
                if up.shape[0] >= n_users + 1 and ip.shape[0] >= n_items + 1:
                    logger.info("Loaded packed feature snapshot from %s",
                                self.features_dir)
                    self._set_packed_tables(up[: n_users + 1],
                                            ip[: n_items + 1], n_users)
                    return
        if isinstance(data, ServeData):
            raise ValueError(
                "no fresh packed feature snapshot of the right size in "
                f"features_dir={self.features_dir!r}; load a MovieLensData "
                "to compute the features from its ratings")

        fe = FeatureEngineer(seed=self.cfg.SEED)
        fe.set_data(data)
        if self.features_dir and Path(self.features_dir).exists():
            fe.load_features(self.features_dir)
        if fe.user_features is None or fe.item_features is None:
            fe.build_user_features()
            fe.build_item_features()
        user_packed = pack_user_features(fe.user_features, n_users)
        item_packed = pack_item_features(fe.item_features, n_items)
        if snap_u is not None:
            snap_u.parent.mkdir(parents=True, exist_ok=True)
            np.save(snap_u, user_packed)
            np.save(snap_i, item_packed)
        self._set_packed_tables(user_packed, item_packed, n_users)

    def _set_packed_tables(self, user_packed, item_packed, n_users: int) -> None:
        """Move the tables to the device, the item rows padded to
        ``GATHER_PAD_WIDTH`` columns."""
        self._user_packed = torch.as_tensor(
            np.array(user_packed, np.float32), device=self.device)
        self._item_packed = torch.as_tensor(
            pad_packed_width(np.array(item_packed, np.float32)),
            device=self.device)
        self._n_users = n_users

    def _build_serve_fn(self) -> None:
        """Fix the serve path's constants and warm it up: the device
        searcher, the ranker's scorer, the seen set on device, the blend."""
        self._score_fn = self.ranker.make_device_scorer()
        self._n_cand = min(self.top_k_candidates, self.index.n_total)
        self._k_out = min(MAX_K, self._n_cand)
        self._retrieve = self.index.make_device_searcher(self._n_cand)
        self._item_ids_dev = self.index._ids_dev
        if self._seen is not None:
            self._seen_dev = self._seen.device_arrays(self.device)
            self._seen_steps = self._seen.search_steps
        fnames = list(self.ranker.feature_names or [])
        self._extra_feats = [
            n for n in fnames if n in ("retrieval_score", "retrieval_rank")]
        self._beta = float(self.cfg.RANKER_BLEND_RETRIEVAL)
        self.serve(1)  # warm-up, so the first request's latency is clean
        self.recalibrate_stage_split()

    # --- the device path ------------------------------------------------- #

    @torch.no_grad()
    def serve_batch(self, user_ids):
        """(B,) user ids → (B, k_out) ranked item ids, scores and retrieval
        scores, as tensors on the device; the whole two-stage pipeline for
        B users (recommender.py:334-363)."""
        uids = torch.as_tensor(user_ids, device=self.device).long().reshape(-1)
        q = self.model.user_tower(uids)
        rvals, pos = self._retrieve(q)
        cand_ids = self._item_ids_dev[pos]                       # (B, C)
        feats = assemble_packed(self._user_packed[uids],
                                self._item_packed[cand_ids])     # (B, C, 50)
        if self._seen is not None:
            indptr, cols = self._seen_dev
            seen = seen_mask(indptr, cols, self._seen_steps, uids[:, None],
                             cand_ids)
        else:
            seen = torch.zeros(cand_ids.shape, dtype=torch.bool, device=self.device)
        feats = _with_extras(feats, rvals, ~seen, self._extra_feats)
        scores = _blend(self._score_fn(feats), rvals, ~seen, self._beta)
        scores = scores.masked_fill(seen, float("-inf"))
        top_scores, sel = fast_topk(scores, self._k_out)
        return (torch.gather(cand_ids, 1, sel), top_scores,
                torch.gather(rvals, 1, sel))

    def serve(self, user_id: int):
        """One user → (k_out,) ids, scores and retrieval scores on device."""
        ids, scores, rvals = self.serve_batch([user_id])
        return ids[0], scores[0], rvals[0]

    @torch.no_grad()
    def _retrieve_only(self, user_id: int):
        q = self.model.user_tower(
            torch.as_tensor([user_id], device=self.device).long())
        return self._retrieve(q)[0]

    # --- stage split ------------------------------------------------------ #

    def _time_ms(self, fn) -> float:
        """Device time of ``fn()`` on the card (CUDA events), host time on
        the CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def recalibrate_stage_split(self) -> dict:
        """(Re-)measure the retrieval share of a single request's time by
        timing user tower + retrieval alone against the full serve call.
        Returns and stores the record served under
        ``get_stats()['stage_split']``."""
        try:
            uids = [1 + (i % max(1, self._n_users)) for i in range(15)]
            t_retr = statistics.median(
                self._time_ms(lambda u=u: self._retrieve_only(u)) for u in uids)
            t_full = statistics.median(
                self._time_ms(lambda u=u: self.serve(u)) for u in uids)
            t_retr, t_full = max(t_retr, 1e-6), max(t_full, 1e-6)
            self._retrieval_fraction = min(0.95, max(0.05, t_retr / t_full))
            self._stage_calibration = {
                "measured": True,
                "timer": "cuda_event" if self.device.type == "cuda" else "host",
                "retrieval_fraction": round(self._retrieval_fraction, 3),
                "retrieve_only_ms": round(t_retr, 3),
                "full_call_ms": round(t_full, 3),
                "at_unix": round(time.time(), 1),
                "concurrent_with_traffic": self._calls_since_recal > 0,
            }
        except RuntimeError:
            logger.warning("Stage-split calibration failed; keeping the "
                           "previous split", exc_info=True)
        with self._recal_lock:
            self._calls_since_recal = 0
        return self._stage_calibration

    def _maybe_recalibrate(self) -> None:
        """Start a background re-measurement every STAGE_RECAL_EVERY
        requests (0 disables); requests never wait for it."""
        every = self.cfg.STAGE_RECAL_EVERY
        if not every:
            return
        with self._recal_lock:
            self._calls_since_recal += 1
            if self._calls_since_recal < every:
                return
            t = self._recal_thread
            if t is not None and t.is_alive():
                return
            self._calls_since_recal = 0
            self._recal_thread = threading.Thread(
                target=self.recalibrate_stage_split, daemon=True)
            self._recal_thread.start()

    # --- online feature updates ------------------------------------------ #

    def update_user_features(self, user_id: int, features: Dict[str, Any]) -> None:
        """Write the user's features to the store and their packed row on the
        device, and drop their cached recommendations: the next request
        scores with the new features."""
        self.feature_store.store_user_features(user_id, features)
        if 0 <= user_id <= self._n_users:
            self._write_row(self._user_packed, user_id,
                            user_dict_to_packed(features))
        self.feature_store.invalidate_recommendations(user_id)

    def update_item_features(self, item_id: int, features: Dict[str, Any]) -> None:
        """Write the item's features to the store and its packed row."""
        self.feature_store.store_item_features(item_id, features)
        if 0 <= item_id < self._item_packed.shape[0]:
            self._write_row(self._item_packed, item_id, pad_packed_width(
                item_dict_to_packed(features), self._item_packed.shape[1]))

    @torch.no_grad()
    def _write_row(self, table: torch.Tensor, row: int, vec: np.ndarray) -> None:
        """Overwrite ``table[row]`` in place, on the current stream, after
        every serve call queued before it (JAX swaps in a new array)."""
        table[row] = torch.as_tensor(vec, dtype=table.dtype, device=table.device)

    # --- micro-batching ---------------------------------------------------- #

    def enable_micro_batching(self, max_batch: int = 256, max_wait_ms: float = 2.0,
                              warm_buckets: bool = True) -> None:
        """Coalesce concurrent requests into one ``serve_batch`` call.

        Each batch is padded with user 1 to the smallest bucket of
        (8, 32, 256, 1024) up to ``max_batch`` that holds it; only the
        1,024 bucket is large enough for the window kernel (batches of 384
        or more). Its rows come back as numpy arrays after one copy to the
        host. With ``warm_buckets`` every bucket runs once on the dispatch
        thread before the batcher takes requests: PyTorch gives each thread
        its own cuBLAS handle and workspace, so a warm-up on the calling
        thread would leave them to the first live batch."""
        buckets = micro_batch_buckets(max_batch)
        warm = object()
        timing: Dict[str, Any] = {"warm_s": None, "warm_thread": None,
                                  "first_live_batch_ms": None,
                                  "first_live_batch_size": None}

        def warm_up() -> None:
            t0 = time.perf_counter()
            for b in buckets:
                self._serve_rows([1] * b)
            timing["warm_s"] = time.perf_counter() - t0
            timing["warm_thread"] = threading.current_thread().name

        def batch_fn(user_ids):
            if user_ids and user_ids[0] is warm:
                warm_up()
                return [None] * len(user_ids)
            n = len(user_ids)
            bucket = next((b for b in buckets if b >= n), buckets[-1])
            t0 = time.perf_counter()
            rows = self._serve_rows(list(user_ids) + [1] * (bucket - n))
            if timing["first_live_batch_ms"] is None:
                timing["first_live_batch_ms"] = (time.perf_counter() - t0) * 1e3
                timing["first_live_batch_size"] = n
            ids, scores, rvals = rows
            return [(ids[i], scores[i], rvals[i]) for i in range(n)]

        batcher = MicroBatcher(batch_fn, max_batch, max_wait_ms)
        if warm_buckets:
            try:
                batcher.submit(warm, timeout=3600.0)
            except BaseException:
                batcher.close()
                raise
            batcher.batches_dispatched = batcher.requests_served = 0
            logger.info("Warmed %d batch buckets in %.1fs on the dispatch thread",
                        len(buckets), timing["warm_s"])
        self._batch_timing = timing
        self._batcher = batcher
        logger.info("Micro-batching enabled (max_batch=%d, wait=%.1fms)",
                    max_batch, max_wait_ms)

    def _serve_rows(self, user_ids):
        """``serve_batch`` brought to the host in one copy: (ids, scores,
        retrieval scores) as numpy arrays. The ids and the f32 scores are
        exact in f64."""
        packed = torch.stack([t.double() for t in self.serve_batch(user_ids)])
        ids, scores, rvals = packed.cpu().numpy()
        return ids.astype(np.int64), scores.astype(np.float32), rvals.astype(np.float32)

    # --- inference ------------------------------------------------------- #

    def _result(self, iid: int, score: float, rank: int,
                retrieval_score: float) -> RecommendationResult:
        return RecommendationResult(
            item_id=iid, title=self._item_titles.get(iid, f"Item {iid}"),
            score=score, rank=rank, retrieval_score=retrieval_score,
            genres=self._item_genres.get(iid, []))

    def get_recommendations(self, user_id: int, k: Optional[int] = None,
                            use_cache: bool = True) -> List[RecommendationResult]:
        if not self._loaded:
            raise RuntimeError("Pipeline not loaded. Call load() first.")
        k = k or self.cfg.TOP_K_RESULTS
        t_start = time.time()
        if use_cache:
            cached = self.feature_store.get_cached_recommendations(user_id)
            if cached is not None:
                self._cache_hits += 1
                return [RecommendationResult(**it) for it in cached][:k]
        self._cache_misses += 1

        if not (1 <= user_id <= self._n_users):
            logger.warning("Unknown user %d — popularity fallback", user_id)
            return self._popularity_recommendations(k)

        t_dev = time.time()
        try:
            if self._batcher is not None:
                ids, scores, retr = self._batcher.submit(user_id)
            else:
                ids, scores, retr = (t.cpu().numpy() for t in self.serve(user_id))
        except QueueFullError:
            # backpressure is a load signal, not a failure: the HTTP layer
            # answers 429
            raise
        except Exception:
            logger.exception("Serve path failed for user %d", user_id)
            return self._popularity_recommendations(k)
        device_ms = (time.time() - t_dev) * 1000
        frac = self._retrieval_fraction
        self.retrieval_latency.record(device_ms * frac)
        self.ranking_latency.record(device_ms * (1.0 - frac))
        self._maybe_recalibrate()

        # seen candidates carry -inf: keep the finite rows, then backfill
        # from unseen popularity so k unseen items come back
        finite = np.isfinite(scores)
        ids, scores, retr = ids[finite], scores[finite], retr[finite]
        results = [
            self._result(int(i), float(s), rank, float(r))
            for rank, (i, s, r) in enumerate(
                zip(ids[:k].tolist(), scores[:k].tolist(), retr[:k].tolist()),
                start=1)
        ]
        if len(results) < k:
            fill = self._unseen_popularity(
                user_id, k, exclude={r.item_id for r in results})
            for iid in fill[: k - len(results)]:
                results.append(self._result(int(iid), float("-inf"),
                                            len(results) + 1, 0.0))
        if use_cache and results:
            self.feature_store.cache_recommendations(
                user_id, [dataclasses.asdict(r) for r in results],
                ttl=self.cfg.CACHE_TTL_SECONDS)
        self.latency_tracker.record((time.time() - t_start) * 1000)
        return results

    def batch_recommend(self, user_ids: List[int], k: Optional[int] = None,
                        batch_size: int = 256) -> Dict[int, List[int]]:
        """Offline batched recommendation → ranked item-id lists. Unknown
        users get the popularity fallback. Batches of 384 or more users over
        a corpus above 65,536 items take the window kernel."""
        k = k or self.cfg.TOP_K_RESULTS
        out: Dict[int, List[int]] = {}
        known = [u for u in user_ids if 1 <= u <= self._n_users]
        for u in user_ids:
            if not (1 <= u <= self._n_users):
                out[u] = self._popularity_fallback[:k]
        for s in range(0, len(known), batch_size):
            chunk = known[s: s + batch_size]
            padded = chunk + [1] * (batch_size - len(chunk))
            ids, scores, _ = self.serve_batch(padded)
            ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
            for row, u in enumerate(chunk):
                got = ids[row][np.isfinite(scores[row])][:k].tolist()
                if len(got) < k:
                    got += self._unseen_popularity(
                        u, k, exclude=set(got))[: k - len(got)]
                out[u] = got
        return out

    def _unseen_popularity(self, user_id: int, k: int, exclude=()) -> List[int]:
        """Most popular items the user has not seen."""
        fill = [i for i in self._popularity_fallback[: 4 * k + len(exclude)]
                if i not in exclude]
        if self._seen is not None and fill:
            arr = np.asarray(fill, dtype=np.int64)
            seen = self._seen.contains(np.full(arr.shape, user_id, np.int64), arr)
            fill = [int(i) for i, s in zip(fill, seen) if not s]
        return fill[:k]

    def _popularity_recommendations(self, k: int) -> List[RecommendationResult]:
        return [self._result(int(iid), 1.0 - rank / (k + 1), rank, 0.0)
                for rank, iid in enumerate(self._popularity_fallback[:k], start=1)]

    def get_stats(self) -> Dict[str, Any]:
        total = self._cache_hits + self._cache_misses
        return {
            "total_requests": total,
            "cache_hits": self._cache_hits,
            "cache_misses": self._cache_misses,
            "cache_hit_rate": self._cache_hits / max(total, 1),
            "latency_p50_ms": round(self.latency_tracker.p50, 2),
            "latency_p99_ms": round(self.latency_tracker.p99, 2),
            "retrieval_p50_ms": round(self.retrieval_latency.p50, 2),
            "retrieval_p99_ms": round(self.retrieval_latency.p99, 2),
            "ranking_p50_ms": round(self.ranking_latency.p50, 2),
            "ranking_p99_ms": round(self.ranking_latency.p99, 2),
            "stage_split": self._stage_calibration,
            "device": str(self.device),
            **({"micro_batcher": {**self._batcher.stats, **self._batch_timing}}
               if self._batcher is not None else {}),
        }
