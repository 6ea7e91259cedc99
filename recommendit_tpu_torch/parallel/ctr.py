"""Distributed CTR training step: DP over impressions × row-sharded table —
torch port of ``recommendit_tpu/parallel/ctr.py``.

The same composition as the two-tower step (``parallel/train.py``): the
stacked 26-field table row-shards over ``model`` and is read through the
masked all-reduce lookup; the bottom/top MLPs, the interaction and the
towers run on each rank's ``data`` slice. The logits and, in joint mode,
the towers' outputs are all-gathered over ``data`` (the backward takes the
rank's own slice), so the BCE mean and the click-weighted in-batch softmax
are the global batch's, as under JAX's ``P('data')`` constraints, and every
rank computes the same loss. Gradients are summed over ``data``.

The table must divide the ``model`` size: ``init_ctr_params(pad_rows_to=…)``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from recommendit_tpu_torch.models.ctr import (
    bce_loss,
    ctr_forward_from_embed,
    item_tower_ctr,
    user_tower_ctr,
    weighted_in_batch_softmax,
)
from recommendit_tpu_torch.ops.topk import full_f32_matmul
from recommendit_tpu_torch.parallel.embedding import (
    gather_slices,
    sharded_embedding_lookup,
)
from recommendit_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    AdamW,
    Sharding,
    ShardedOptState,
    init_opt_sharded,
    replicated,
    row_sharded,
    shard_tree,
)
from recommendit_tpu_torch.parallel.train import _check_tx, data_slice, sharded_grads


def ctr_params_shardings(params: dict, mesh) -> Dict[str, Sharding]:
    """Stacked table row-sharded on 'model'; every MLP weight replicated."""
    return {k: row_sharded(mesh) if k == "embed" else replicated(mesh)
            for k in params}


def shard_ctr_params(params: dict, mesh) -> Dict[str, torch.Tensor]:
    return shard_tree(params, ctr_params_shardings(params, mesh))


def make_ctr_sharded_train_step(mesh, tx: AdamW, n_user_fields: int,
                                joint: bool = True,
                                retrieval_weight: float = 0.5,
                                temperature: float = 0.1) -> Callable:
    """Build the distributed CTR/joint train step.

    Returns step(params, opt_state, batch) -> (params, opt_state, loss)
    with batch = (dense (B,13), stacked_ids (B,26), labels (B,)) global
    tensors on the rank's device, optionally with a fourth element log_q
    (B,), the per-example item log-popularity of the logQ-corrected
    in-batch softmax. The params and state (:func:`init_ctr_sharded_state`)
    are updated in place and returned.
    """
    def compute_loss(params, dense, ids, labels, log_q):
        b, f = ids.shape
        rows = sharded_embedding_lookup(
            params["embed"], ids.reshape(-1), mesh).reshape(b, f, -1)
        if not joint:
            logits = ctr_forward_from_embed(params, dense, rows)
            return bce_loss(gather_slices(logits, mesh, DATA_AXIS), labels)
        ue = user_tower_ctr(params, rows[:, :n_user_fields])
        ie = item_tower_ctr(params, rows[:, n_user_fields:])
        sim = (ue * ie).sum(dim=-1)
        logits = ctr_forward_from_embed(params, dense, rows, sim)
        ret = weighted_in_batch_softmax(
            gather_slices(ue, mesh, DATA_AXIS), gather_slices(ie, mesh, DATA_AXIS),
            labels, log_q, temperature=temperature)
        return (bce_loss(gather_slices(logits, mesh, DATA_AXIS), labels)
                + retrieval_weight * ret)

    def step(params, opt_state, batch):
        _check_tx(opt_state, tx)
        dense, ids, labels = batch[:3]
        log_q = batch[3] if len(batch) > 3 else None
        with full_f32_matmul():
            loss = compute_loss(params, data_slice(dense, mesh),
                                data_slice(ids, mesh), labels, log_q)
            opt_state.apply_(sharded_grads(mesh, params, opt_state.names, loss))
        return params, opt_state, loss.detach()

    return step


def init_ctr_sharded_state(mesh, tx: AdamW, params: dict
                           ) -> Tuple[Dict[str, torch.Tensor], ShardedOptState]:
    """Shard the global params; the optimizer state over this rank's shards."""
    shardings = ctr_params_shardings(params, mesh)
    params = shard_tree(params, shardings)
    return params, init_opt_sharded(tx, params, mesh, shardings)
