"""Sharded multi-device serving — torch port of
``recommendit_tpu/parallel/serve.py``.

The two-stage serve path (embed → retrieve → featurize → rank → top-k)
over the ``('data', 'model')`` mesh:

* the query batch is split over ``data`` (each data slice serves its
  users),
* the item corpus is row-sharded over ``model`` (the sharded exact MIPS of
  ``parallel/retrieval.py`` runs inside),
* tower params, feature tables and ranker params are whole on every rank
  (they are small; the corpus is the scaling term);
* the slices' results are all-gathered over ``data``, so every rank
  returns the whole batch's (JAX returns one global array).

Single-card serving (``serving/recommender.py``) covers the reference's
workload; this is the capacity path for corpora beyond one card's memory.
"""
from __future__ import annotations

from typing import Callable

import torch

from recommendit_tpu_torch.features.schema import assemble_packed
from recommendit_tpu_torch.models.two_tower import user_tower
from recommendit_tpu_torch.ops.topk import fast_topk, full_f32_matmul
from recommendit_tpu_torch.parallel.embedding import gather_slices
from recommendit_tpu_torch.parallel.mesh import DATA_AXIS
from recommendit_tpu_torch.parallel.retrieval import sharded_mips_topk
from recommendit_tpu_torch.parallel.train import data_slice


def make_sharded_serve_fn(
    mesh,
    params: dict,
    item_corpus: torch.Tensor,    # this rank's (N / S, D) rows of the corpus
    item_ids: torch.Tensor,       # (N,), maps corpus row → item id
    user_packed: torch.Tensor,    # (n_users+1, 24)
    item_packed: torch.Tensor,    # (n_items+1, 23+)
    score_fn: Callable,           # (…, F) raw feats → (…,) ranker scores
    n_candidates: int = 500,
    k_out: int = 100,
    block_size: int = 4096,
    use_retrieval_score: bool = False,
) -> Callable:
    """Build serve(user_ids (B,)) → (item_ids (B, k), scores, retrieval
    scores), B a multiple of the ``data`` size, the same on every rank."""
    item_ids = item_ids.long()

    @torch.no_grad()
    def serve(user_ids: torch.Tensor):
        uids = data_slice(user_ids, mesh).long()
        with full_f32_matmul():
            q = user_tower(params, uids)
            rvals, pos = sharded_mips_topk(q, item_corpus, n_candidates, mesh,
                                           block_size)
            cand_ids = item_ids[pos]
            feats = assemble_packed(user_packed[uids], item_packed[cand_ids])
            if use_retrieval_score:
                feats = torch.cat([feats, rvals[:, :, None]], dim=2)
            scores = score_fn(feats)
            top_scores, sel = fast_topk(scores, k_out)
        out = (torch.gather(cand_ids, 1, sel), top_scores,
               torch.gather(rvals, 1, sel))
        return tuple(gather_slices(x.contiguous(), mesh, DATA_AXIS) for x in out)

    return serve
