"""Distributed two-tower training step: DP over the batch × row-sharded
tables — torch port of ``recommendit_tpu/parallel/train.py``.

Every rank is given the same global batch and works on its ``data`` slice:

* the embedding rows come through the masked all-reduce lookup over
  ``model`` (``parallel/embedding.py``); the tower MLPs run on the slice;
* the towers' (B/n, D) outputs are all-gathered over ``data`` (the backward
  takes the rank's own slice), and the in-batch BPR loss runs on the whole
  (B, D) — so the (B, B) loss is the global one, as JAX's ``P('data')``
  constraints make it, and on the card it launches kernels 5 and 6
  (``ops/bpr.in_batch_bpr_loss``, ``csrc/bpr.cu``) every step. Every rank
  computes the same loss;
* gradients: each rank's (dense and table-shard) gradients hold its slice's
  part, and are summed over ``data`` — never over the whole world: the
  ``model`` ranks of a data slice hold the same dense gradients. Table
  shards are replicated over ``data``, as JAX's ``P('model', None)`` is.

Dropout draws from an explicit ``torch.Generator`` a data slice
(:func:`dropout_generator`); the model ranks of a slice must draw the same
masks, since they repeat one compute. ``jax.random`` masks cannot be
replayed, so parity with JAX runs at dropout 0.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from recommendit_tpu_torch.models.two_tower import (
    item_tower_from_embed,
    user_tower_from_embed,
)
from recommendit_tpu_torch.ops.bpr import in_batch_bpr_loss
from recommendit_tpu_torch.ops.topk import full_f32_matmul
from recommendit_tpu_torch.parallel.embedding import gather_slices, sharded_dual_lookup
from recommendit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    AdamW,
    ShardedOptState,
    axis_index,
    axis_size,
    init_opt_sharded,
    mesh_device,
    params_shardings,
    shard_tree,
)


def shard_params(params: dict, mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of the global params (numpy arrays or tensors):
    tables row-sharded, the rest whole, on the rank's device."""
    return shard_tree(params, params_shardings(params, mesh))


def data_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of a global batch along ``data``."""
    n = axis_size(mesh, DATA_AXIS)
    if x.shape[0] % n:
        raise ValueError(
            f"batch {x.shape[0]} must divide data axis {n}; "
            "pad with parallel.mesh.pad_to_multiple")
    b = x.shape[0] // n
    i = axis_index(mesh, DATA_AXIS)
    return x[i * b:(i + 1) * b]


def dropout_generator(mesh, seed: int) -> torch.Generator:
    """A generator for this rank's dropout masks: one stream a data slice,
    the same on every model rank of it."""
    gen = torch.Generator(device=mesh_device(mesh))
    return gen.manual_seed(seed * axis_size(mesh, DATA_AXIS)
                           + axis_index(mesh, DATA_AXIS))


def _check_tx(opt_state: ShardedOptState, tx: AdamW) -> None:
    if opt_state.tx != tx:
        raise ValueError(f"the optimizer state was built for {opt_state.tx}, "
                         f"the step for {tx}")


# elements of one all-reduce of small gradients packed together (64 MiB of
# f32); a larger gradient is reduced in place, alone
GRAD_BUCKET = 1 << 24


def _grads(params: dict, names, loss: torch.Tensor):
    """Each rank's gradients of ``loss`` w.r.t. ``params[names]`` (zeros
    where the loss does not reach a param), contiguous and each its own
    tensor: autograd hands one tensor to two leaves where their sum is
    used (``a + b``), and the in-place reduction and clipping would then
    count it twice."""
    leaves = [params[k] for k in names]
    out, seen = [], set()
    for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True)):
        g = torch.zeros_like(p) if g is None else g.contiguous()
        if id(g) in seen:
            g = g.clone()
        seen.add(id(g))
        out.append(g)
    return out


def all_reduce_(tensors, group, bucket: int = GRAD_BUCKET) -> None:
    """Sum each of ``tensors`` (contiguous) over ``group`` in place: one
    all-reduce a tensor of at least ``bucket`` elements, the smaller ones
    packed, in order, into flat buckets of at most ``bucket`` elements (a
    copy of one bucket at a time). Per element a sum over one or two ranks
    is exact whatever the packing; over more, the collective's order of
    summation follows the element's place in its buffer."""
    small: list = []

    def flush():
        flat = torch.cat([t.reshape(-1) for t in small])
        dist.all_reduce(flat, group=group)
        for t, f in zip(small, flat.split([t.numel() for t in small])):
            t.copy_(f.view_as(t))
        small.clear()

    for t in tensors:
        if t.numel() >= bucket:
            dist.all_reduce(t, group=group)
            continue
        if small and sum(x.numel() for x in small) + t.numel() > bucket:
            flush()
        small.append(t)
    if small:
        flush()


def sharded_grads(mesh, params: dict, names, loss: torch.Tensor,
                  bucket: int = GRAD_BUCKET):
    """Gradients of the global ``loss`` w.r.t. ``params[names]``, summed
    over ``data`` in place (:func:`all_reduce_`; nothing to sum where the
    axis has one rank): the whole batch's gradient of each rank's tensor
    (the table shards' of their own rows). No second copy of the gradients
    is made: the step's peak stays params + grads + moments, as in JAX's
    donated step."""
    grads = _grads(params, names, loss)
    if axis_size(mesh, DATA_AXIS) > 1:
        all_reduce_(grads, mesh.get_group(DATA_AXIS), bucket)
    return grads


def _sharded_grads_flat(mesh, params: dict, names, loss: torch.Tensor):
    """:func:`sharded_grads` by one all-reduce of every gradient copied into
    one flat buffer (two copies of the gradients at once): the reference
    the in-place form is held to."""
    grads = _grads(params, names, loss)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group(DATA_AXIS))
    return [f.view_as(g) for f, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def make_sharded_loss_fn(mesh, genre_table, dropout_rate: float = 0.0,
                         loss_fn: Callable = in_batch_bpr_loss) -> Callable:
    """loss(params, batch, rng=None) → the global batch's loss, the same on
    every rank (the step's forward; see :func:`make_sharded_train_step`)."""
    genre_table = torch.as_tensor(genre_table, device=mesh_device(mesh)).float()

    def loss(params, batch, rng: Optional[torch.Generator] = None):
        u_ids, i_ids = (data_slice(x, mesh) for x in batch)
        ue_rows, ie_rows = sharded_dual_lookup(
            params["user_embed"], params["item_embed"], u_ids, i_ids, mesh)
        genres = genre_table[i_ids.long()]
        ue = user_tower_from_embed(params, ue_rows, dropout_rate, rng)
        ie = item_tower_from_embed(params, ie_rows, genres, dropout_rate, rng)
        return loss_fn(gather_slices(ue, mesh, DATA_AXIS),
                       gather_slices(ie, mesh, DATA_AXIS))

    return loss


def make_sharded_train_step(mesh, tx: AdamW, genre_table,
                            dropout_rate: float = 0.0,
                            loss_fn: Callable = in_batch_bpr_loss) -> Callable:
    """Build the distributed train step.

    Returns step(params, opt_state, batch, rng=None) -> (params, opt_state,
    loss), with batch = (user_ids (B,), item_ids (B,)) global-batch tensors
    on the rank's device, the same on every rank; ``rng`` a generator of
    :func:`dropout_generator` (dropout is off without one). The params and
    the state (:func:`init_sharded_state`, whose ``tx`` it uses) are updated
    in place and returned.
    """
    loss_of = make_sharded_loss_fn(mesh, genre_table, dropout_rate, loss_fn)

    def step(params, opt_state, batch, rng: Optional[torch.Generator] = None):
        _check_tx(opt_state, tx)
        with full_f32_matmul():
            loss = loss_of(params, batch, rng)
            opt_state.apply_(sharded_grads(mesh, params, opt_state.names, loss))
        return params, opt_state, loss.detach()

    return step


def init_sharded_state(mesh, tx: AdamW, params: dict
                       ) -> Tuple[Dict[str, torch.Tensor], ShardedOptState]:
    """Shard the global params and build this rank's optimizer state."""
    params = shard_params(params, mesh)
    return params, init_opt_sharded(tx, params, mesh)
