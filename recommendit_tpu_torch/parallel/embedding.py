"""Row-sharded embedding tables with collective lookup — torch port of
``recommendit_tpu/parallel/embedding.py``.

Each rank of a ``model`` group holds one contiguous block of a table's
rows. Two lookups, each an autograd function whose backward is written out:

* masked all-reduce (:func:`sharded_embedding_lookup`, the default): every
  shard gathers its local rows for the whole id batch (ids outside it
  read row 0 and are zeroed), then one ``all_reduce`` over ``model``
  combines the shards. The output is replicated over ``model``, and every
  rank of the group repeats the compute that follows, so each holds the
  same cotangent: the backward passes it through the all-reduce unchanged
  and scatter-adds it into the rank's own rows. (Summing it over the group
  instead — ``torch.distributed.nn``'s all-reduce backward — would scale
  the table's gradient by the group's size.)
* ring (:func:`bucketed_embedding_lookup`): the batch is split into one
  packet a shard; each packet visits every shard around the ring
  (``batch_isend_irecv`` to the next rank), collecting its rows. The
  backward sends each packet's ids and cotangent around the reverse ring,
  each shard scatter-adding into its rows.

Tables are each rank's own shard (rows / model size rows); ids are global
row numbers and every rank of the group is given the same ids.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from recommendit_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_index,
    axis_size,
)

# all_gather_into_tensor under its newer name where torch has it
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def local_rows(n_rows_global: int, n_shards: int) -> int:
    if n_rows_global % n_shards != 0:
        raise ValueError(
            f"table rows {n_rows_global} must divide mesh axis {n_shards}; "
            "pad with parallel.mesh.pad_to_multiple"
        )
    return n_rows_global // n_shards


def _local_hits(ids: torch.Tensor, shard: int, rows: int):
    """(safe local row, in-range mask) of global ``ids`` on shard ``shard``."""
    local = ids.long() - shard * rows
    ok = (local >= 0) & (local < rows)
    return torch.where(ok, local, torch.zeros_like(local)), ok


def _gather_local(table_shard, ids, shard):
    safe, ok = _local_hits(ids, shard, table_shard.shape[0])
    emb = table_shard.index_select(0, safe)
    return torch.where(ok[:, None], emb, torch.zeros_like(emb))


def _scatter_local(grad_shard, ids, g, shard):
    safe, ok = _local_hits(ids, shard, grad_shard.shape[0])
    grad_shard.index_add_(0, safe, torch.where(ok[:, None], g, torch.zeros_like(g)))


class _MaskedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_shard, ids, group, shard):
        emb = _gather_local(table_shard, ids, shard)
        dist.all_reduce(emb, group=group)
        ctx.save_for_backward(ids)
        ctx.shard, ctx.table_shape = shard, table_shard.shape
        return emb

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = g.new_zeros(ctx.table_shape)
        _scatter_local(grad, ids, g, ctx.shard)
        return grad, None, None, None


def sharded_embedding_lookup(table_shard: torch.Tensor, ids: torch.Tensor,
                             mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Lookup ids in a row-sharded table → (B, D) embeddings, the same on
    every rank of the ``axis`` group. Differentiable: the backward
    scatter-adds into each shard's local rows."""
    return _MaskedLookup.apply(table_shard, ids, mesh.get_group(axis),
                               axis_index(mesh, axis))


def _ring_pass(tensors, group, ranks, me, step):
    """Send ``tensors`` to the rank ``step`` places on around the ring of
    ``group`` (whose global ranks are ``ranks``, this rank at ``me``) and
    receive the same shapes from the rank ``step`` places back."""
    n = len(ranks)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), ranks[(me + step) % n], group))
        ops.append(dist.P2POp(dist.irecv, o, ranks[(me - step) % n], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_shard, ids_slice, group, me):
        ranks = dist.get_process_group_ranks(group)
        n = len(ranks)
        ids = ids_slice
        acc = table_shard.new_zeros((ids.shape[0], table_shard.shape[1]))
        # hop t: this rank holds the packet of shard (me - t) and the rows
        # of shard me; after n hops the packet is home, full
        for _ in range(n):
            acc = acc + _gather_local(table_shard, ids, me)
            if n > 1:
                ids, acc = _ring_pass((ids, acc), group, ranks, me, 1)
        ctx.save_for_backward(ids_slice)
        ctx.group, ctx.ranks, ctx.me = group, ranks, me
        ctx.table_shape = table_shard.shape
        return acc

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        ranks, me = ctx.ranks, ctx.me
        grad = g.new_zeros(ctx.table_shape)
        g = g.contiguous()
        # the reverse ring: the packet's ids and cotangent visit every shard
        for t in range(len(ranks)):
            _scatter_local(grad, ids, g, me)
            if t < len(ranks) - 1:
                ids, g = _ring_pass((ids, g), ctx.group, ranks, me, -1)
        return grad, None, None, None


class _GatherSlices(torch.autograd.Function):
    """All-gather of each rank's (b, ...) slice along dim 0 over ``group``
    → (n·b, ...). Every rank then repeats the same compute on the whole, so
    the backward takes the rank's own slice of the cotangent (a
    reduce-scatter would count it once a rank)."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), group=group)
        ctx.bounds = (index * x.shape[0], (index + 1) * x.shape[0])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.bounds
        return g[a:b], None, None, None


def gather_slices(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Each rank's slice of a batch along ``axis`` → the whole batch, on
    every rank of the group; differentiable (see :class:`_GatherSlices`)."""
    return _GatherSlices.apply(x, mesh.get_group(axis), axis_index(mesh, axis),
                               axis_size(mesh, axis))


def bucketed_embedding_lookup(table_shard: torch.Tensor, ids: torch.Tensor,
                              mesh, axis: str = MODEL_AXIS,
                              replicate_out: bool = False) -> torch.Tensor:
    """Ring lookup for LARGE batches (the masked all-reduce wins at small B).

    ``ids``: the global (B,) batch, the same on every rank of the group; B
    must divide the ``axis`` size (pad via ``pad_to_multiple``). Shard i
    sends packet i (ids [i·B/n, (i+1)·B/n)) around the ring: each hop moves
    (B/n, D), against the all-reduce's (B, D). Returns this rank's packet
    (B/n, D), or, with ``replicate_out``, the whole (B, D) gathered over
    the group (which costs the saved bandwidth back).
    """
    n = axis_size(mesh, axis)
    if ids.shape[0] % n != 0:
        raise ValueError(
            f"batch {ids.shape[0]} must divide model axis {n}; "
            "pad with parallel.mesh.pad_to_multiple"
        )
    me = axis_index(mesh, axis)
    b = ids.shape[0] // n
    out = _RingLookup.apply(table_shard, ids[me * b:(me + 1) * b].contiguous(),
                            mesh.get_group(axis), me)
    if replicate_out:
        out = gather_slices(out, mesh, axis)
    return out


def sharded_dual_lookup(user_table: torch.Tensor, item_table: torch.Tensor,
                        user_ids: torch.Tensor, item_ids: torch.Tensor,
                        mesh, axis: str = MODEL_AXIS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """User and item lookups, back to back over the same group."""
    return (sharded_embedding_lookup(user_table, user_ids, mesh, axis),
            sharded_embedding_lookup(item_table, item_ids, mesh, axis))
