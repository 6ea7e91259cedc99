"""The serve system under test: ``RecommendationPipeline.serve_batch`` of
the port, built in memory from the benchmark's inputs.

Set-up builds what ``RecommendationPipeline.load`` builds from its files —
the two-tower, the index (``MIPSIndex.build``), the ranker, the packed
feature tables, the seen set — from tensors the benchmark drew on the
card, and then ``_build_serve_fn`` (the pipeline's own warm-up and stage
calibration). A call is one ``serve_batch`` of the mix's batch; its ids
and scores come to the host in one copy before the next call. The
pipeline's searcher is wrapped to keep each call's candidates for the
check and, in a traced run, to open the ``perfbench.retrieve`` range.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import judge
from perfbench.inputs import serve_inputs
from perfbench.reference import twotower_serve as ref
from perfbench.seeds import derive

CHECK_USERS = 4096          # served users the check compares, in whole batches


def keep_indices(seed: int, pool: int, batch: int) -> set:
    """The pool's batches whose last service in the window is checked,
    drawn from the seed: enough for ``CHECK_USERS`` users."""
    rng = np.random.default_rng(derive(seed, "check"))
    n_keep = min(pool, -(-CHECK_USERS // batch))
    return set(rng.choice(pool, n_keep, replace=False).tolist())


class Session:
    def __init__(self, cell, seed: int, device):
        from recommendit_tpu_torch.config import Settings
        from recommendit_tpu_torch.features.schema import FEATURE_COLUMNS
        from recommendit_tpu_torch.models import LambdaRankScorer, MIPSIndex, TwoTower
        from recommendit_tpu_torch.ops.seen import SeenSet
        from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

        self.cfg = cfg = cell.config
        self.seed, self.device = seed, torch.device(device)
        self.batch = int(cell.traffic["batch"])
        self.pool = int(cell.traffic["pool"])
        self.rows = self.batch
        self.sizes = {"users": cfg["n_users"], "items": cfg["n_items"]}
        self.limits = cfg["checks"]
        self.marker = cfg["trace_marker"]
        inp = serve_inputs(cfg, seed, self.device)
        u, n, d, h = cfg["n_users"], cfg["n_items"], cfg["embedding_dim"], cfg["hidden_dim"]

        settings = Settings(EMBEDDING_DIM=d, HIDDEN_DIM=h, INDEX_MODE=cfg["index_mode"],
                            INDEX_DTYPE=cfg["index_dtype"],
                            TOP_K_CANDIDATES=cfg["top_k_candidates"], FILTER_SEEN=True,
                            RANKER_BLEND_RETRIEVAL=float(cfg["blend_retrieval"]),
                            RANKER_QUERY_NORM=True, STAGE_RECAL_EVERY=0)
        pipe = RecommendationPipeline(cfg=settings, device=self.device)
        model = TwoTower(u, n, d, h, device=self.device)
        for name, t in inp.tower.items():
            getattr(model, name).data.copy_(t)
        index = MIPSIndex(d, cfg["index_block"], cfg["index_mode"], cfg["index_dtype"],
                          device=self.device)
        index.build(inp.item_vecs.cpu().numpy(), np.arange(1, n + 1, dtype=np.int64),
                    bias=inp.item_bias.cpu().numpy())
        names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
        if len(names) != cfg["n_features"]:
            raise ValueError(f"the ranker takes {len(names)} features, the "
                             f"configuration states {cfg['n_features']}")
        ranker = LambdaRankScorer(feature_names=names, hidden_dims=tuple(cfg["ranker_hidden"]),
                                  query_norm=True, device=self.device)
        ranker.params = {k: v.clone() for k, v in inp.ranker.items()}
        ranker.feat_mean = inp.feat_mean.cpu().numpy()
        ranker.feat_std = inp.feat_std.cpu().numpy()
        ranker._trained = True
        pipe.model, pipe.index, pipe.ranker = model, index, ranker
        pipe._set_packed_tables(inp.user_feats.cpu().numpy(), inp.item_feats.cpu().numpy(), u)
        pipe._seen = SeenSet(inp.ratings_user.cpu().numpy(), inp.ratings_item.cpu().numpy(), n)
        pipe._build_serve_fn()
        pipe._loaded = True
        self.pipe = pipe
        # the inputs are drawn again for the check: the window holds only
        # the program's memory
        del inp

        # the searcher, wrapped: its last output, and the layer range when traced
        self._ranges = False
        self._last = None
        search = pipe._retrieve

        def retrieve(q):
            with (torch.profiler.record_function("perfbench.retrieve") if self._ranges
                  else contextlib.nullcontext()):
                out = search(q)
            self._last = out
            return out

        pipe._retrieve = retrieve
        self.keep = keep_indices(seed, self.pool, self.batch)
        self.kept = {}

    # --- the timed path ---------------------------------------------------- #

    def call(self, batch):
        return self.pipe.serve_batch(batch["user"])

    @staticmethod
    def finish(out):
        ids, scores, _ = out
        return torch.stack([ids.double(), scores.double()]).cpu()

    drain = None

    def on_result(self, i: int, out, host) -> None:
        if i in self.keep:
            self.kept[i] = (self._last, host)

    def warm(self, batches) -> int:
        """Two calls at the cell's shape; the window starts at batch 0."""
        for b in batches[:2]:
            self.finish(self.call(b))
        return 0

    def layer_ranges(self, on: bool) -> None:
        self._ranges = on

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def busy(summary) -> tuple:
        """(busy_s, window_s) of the traced window (one card)."""
        return summary.busy_s, summary.window_s

    def memory_peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def facts(self) -> dict:
        route, w, _ = ref.retrieval_rule(self.cfg, self.batch)
        return {"batch": self.batch, "route": route, "window": w}

    def release(self) -> None:
        self.pipe = None
        self._last = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check --------------------------------------------------------- #

    def numbers(self, batches) -> dict:
        """The reference's check of every kept batch's users."""
        users, pos, rvals, ids, scores = [], [], [], [], []
        for i in sorted(self.kept):
            (rv, p), host = self.kept[i]
            users.append(batches[i]["user"])
            pos.append(p)
            rvals.append(rv)
            ids.append(host[0].to(self.device).long())
            scores.append(host[1].to(self.device).float())
        if not users:
            raise RuntimeError("no kept batch was served in the window")
        inp = serve_inputs(self.cfg, self.seed, self.device)
        with torch.no_grad():
            return judge.serve_numbers(inp, self.cfg, self.batch, torch.cat(users),
                                       torch.cat(pos), torch.cat(rvals), torch.cat(ids),
                                       torch.cat(scores))
