"""Sharded-corpus MIPS retrieval — torch port of
``recommendit_tpu/parallel/retrieval.py``.

The item corpus is row-sharded over the ``model`` group; each rank runs the
port's exact top-k (``ops/topk.mips_topk``, full f32) over its rows, then
the per-shard candidate lists (k each) are combined:

* :func:`sharded_mips_topk`: one all-gather of the (Q, k) lists over the
  group and an exact top-k merge of the (Q, S·k) candidates;
* :func:`sharded_mips_topk_ring`: the lists pass around the ring
  (``batch_isend_irecv``) in S − 1 steps, each merged into a running
  top-k — (Q, k) in flight a step instead of (Q, S·k).

``torch.topk`` orders tied scores arbitrarily (C.6), so ``canonical=True``
reorders each merged list into (value desc, index asc) order with
``canonical_tie_order``: every member of a tie group that beats the k-th
value survives each merge whatever its order, so canonicalising the final
list is enough for element-identity with the single-device path.
"""
from __future__ import annotations

from typing import Tuple

import torch

from recommendit_tpu_torch.ops.topk import canonical_tie_order, fast_topk, mips_topk
from recommendit_tpu_torch.parallel.embedding import _all_gather, _ring_pass
from recommendit_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_index,
    axis_ranks,
    axis_size,
)


def _local_topk(queries, items_shard, k: int, block_size: int, shard: int):
    """This shard's top-k → (values, global indices), padded to k columns
    (−inf) where the shard holds fewer than k rows."""
    rows = items_shard.shape[0]
    k_local = min(k, rows)
    vals, idx = mips_topk(queries, items_shard, k_local, block_size)
    if k_local < k:  # pad so every shard contributes k candidates
        pad = k - k_local
        vals = torch.nn.functional.pad(vals, (0, pad), value=-float("inf"))
        idx = torch.nn.functional.pad(idx, (0, pad))
    return vals, idx + shard * rows


def _merge(run_v, run_i, cand_v, cand_i, k: int):
    cat_v = torch.cat([run_v, cand_v], dim=1)
    cat_i = torch.cat([run_i, cand_i], dim=1)
    mv, sel = fast_topk(cat_v, k)
    return mv, torch.gather(cat_i, 1, sel)


def _check(k, mesh, axis, n_rows):
    n = axis_size(mesh, axis)
    if k > n_rows * n:
        raise ValueError(f"k={k} exceeds corpus size {n_rows * n}")
    return n, axis_index(mesh, axis)


@torch.no_grad()
def sharded_mips_topk(queries: torch.Tensor, items_shard: torch.Tensor, k: int,
                      mesh, block_size: int = 4096, axis: str = MODEL_AXIS,
                      canonical: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a corpus row-sharded on ``axis``.

    ``queries`` (Q, D): the same on every rank of the group;
    ``items_shard``: this rank's (N / S, D) rows; ``block_size`` is
    ``mips_topk``'s (its approx mode's block; the exact path each shard
    runs sizes its own chunks). Returns (values (Q, k),
    global row indices (Q, k)), the same on every rank of the group.
    ``canonical``: (value desc, index asc) tie order, element-identical to
    ``canonical_tie_order`` of the single-device ``mips_topk``.
    """
    s, me = _check(k, mesh, axis, items_shard.shape[0])
    vals, gidx = _local_topk(queries, items_shard, k, block_size, me)
    q = queries.shape[0]
    group = mesh.get_group(axis)
    all_v = vals.new_empty((s * q, k))
    all_i = gidx.new_empty((s * q, k))
    _all_gather(all_v, vals.contiguous(), group=group)
    _all_gather(all_i, gidx.contiguous(), group=group)
    # (S·Q, k) in shard order → (Q, S·k)
    all_v = all_v.reshape(s, q, k).permute(1, 0, 2).reshape(q, s * k)
    all_i = all_i.reshape(s, q, k).permute(1, 0, 2).reshape(q, s * k)
    mvals, sel = fast_topk(all_v, k)
    midx = torch.gather(all_i, 1, sel)
    return canonical_tie_order(mvals, midx) if canonical else (mvals, midx)


@torch.no_grad()
def sharded_mips_topk_ring(queries: torch.Tensor, items_shard: torch.Tensor,
                           k: int, mesh, block_size: int = 4096,
                           axis: str = MODEL_AXIS, canonical: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring-merge form of :func:`sharded_mips_topk` (same results)."""
    s, me = _check(k, mesh, axis, items_shard.shape[0])
    vals, gidx = _local_topk(queries, items_shard, k, block_size, me)
    group = mesh.get_group(axis)
    ranks = axis_ranks(mesh, axis)
    run_v, run_i, buf_v, buf_i = vals, gidx, vals, gidx
    for _ in range(s - 1):
        buf_v, buf_i = _ring_pass((buf_v, buf_i), group, ranks, me, 1)
        run_v, run_i = _merge(run_v, run_i, buf_v, buf_i, k)
    return canonical_tie_order(run_v, run_i) if canonical else (run_v, run_i)
