"""End-to-end recommendation pipeline — torch port.

Counterpart of ``recommendit_tpu/serving/recommender.py``: cache → user
tower → top-C retrieval → packed feature assembly → ranker (blended with
the retrieval score) → seen mask → top-k, with the popularity fallback for
unknown users and the unseen-popularity backfill. The hot path runs on
``device`` as one chain of tensor ops per batch; a fused index sends
batches of 384 users or more through the window kernel
(``ops/mips_window.py``).

``load`` needs no pandas: it takes plain arrays (:class:`ServeData`) or a
``MovieLensData``, whose frames are read through ``to_numpy`` only.
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
from recommendit_tpu_torch.features.schema import assemble_packed, pad_packed_width
from recommendit_tpu_torch.features.store import FeatureStore
from recommendit_tpu_torch.models import MIPSIndex, TwoTower, load_ranker
from recommendit_tpu_torch.ops.seen import SeenSet, seen_mask
from recommendit_tpu_torch.ops.topk import fast_topk
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from recommendit_tpu_torch.utils.latency import LatencyTracker

logger = logging.getLogger(__name__)

MAX_K = 100  # API cap (reference app.py:32 k<=100)


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
    def from_movielens(cls, data) -> "ServeData":
        """From a ``MovieLensData`` (ratings / movies frames)."""
        r, m = data.ratings, data.movies
        ids = m["item_id"].to_numpy().astype(np.int64).tolist()
        return cls(
            user_id=r["user_id"].to_numpy(),
            item_id=r["item_id"].to_numpy(),
            n_users=int(data.n_users),
            n_items=int(data.n_items),
            titles=dict(zip(ids, m["title"].astype(str).tolist())),
            genres={i: str(g).split("|")
                    for i, g in zip(ids, m["genres"].tolist())},
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
                 features_dir: Optional[str] = None,
                 top_k_candidates: Optional[int] = None,
                 cfg: Optional[Settings] = None,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg or default_settings
        self.model_path = model_path or self.cfg.EMBEDDING_MODEL_PATH
        self.index_path = index_path or self.cfg.INDEX_PATH
        self.ranker_path = ranker_path or self.cfg.RANKER_MODEL_PATH
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

    # --- load ------------------------------------------------------------ #

    def load(self, data) -> None:
        """Load the model files and build the serve path. ``data``: a
        :class:`ServeData` or a ``MovieLensData``."""
        t0 = time.time()
        if not isinstance(data, ServeData):
            data = ServeData.from_movielens(data)
        self.model = TwoTower.load(self.model_path, device=self.device)
        self.index = MIPSIndex.load(self.index_path, device=self.device)
        self.ranker = load_ranker(self.ranker_path, device=self.device)
        self.feature_store = FeatureStore()
        self._item_titles = dict(data.titles)
        self._item_genres = dict(data.genres)
        self._popularity_fallback = popularity_order(data.item_id).tolist()
        n_users = max(self.model.n_users, data.n_users,
                      int(np.max(data.user_id, initial=0)))
        n_items = max(self.model.n_items, data.n_items,
                      int(np.max(data.item_id, initial=0)))
        self._load_packed_tables(n_users, n_items)
        self._seen = (SeenSet(data.user_id, data.item_id, n_items)
                      if self.cfg.FILTER_SEEN else None)
        self._build_serve_fn()
        self._loaded = True
        logger.info("Pipeline loaded in %.2fs", time.time() - t0)

    def _load_packed_tables(self, n_users: int, n_items: int) -> None:
        """The packed user/item feature tables from their ``.npy``
        snapshots (``user_packed.npy``, ``item_packed.npy``) in
        ``features_dir`` — the JAX pipeline's fast path. Recomputing them
        from raw ratings needs the pandas feature engineering, which is not
        ported (ROADMAP)."""
        if not self.features_dir:
            raise ValueError("features_dir with the packed .npy snapshots is required")
        snap_u = Path(self.features_dir) / "user_packed.npy"
        snap_i = Path(self.features_dir) / "item_packed.npy"
        up = np.load(snap_u, mmap_mode="r")
        ip = np.load(snap_i, mmap_mode="r")
        if up.shape[0] < n_users + 1 or ip.shape[0] < n_items + 1:
            raise ValueError(
                f"packed snapshot too small: users {up.shape[0]} < {n_users + 1} "
                f"or items {ip.shape[0]} < {n_items + 1}")
        self._user_packed = torch.as_tensor(
            np.array(up[: n_users + 1], np.float32), device=self.device)
        self._item_packed = torch.as_tensor(
            pad_packed_width(np.array(ip[: n_items + 1], np.float32)),
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
        ids, scores, retr = (t.cpu().numpy() for t in self.serve(user_id))
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
        }
