"""Rank bodies of the layer's parity checks: every function of
``parallel/`` run on given numpy inputs, the results returned as numpy.

:func:`run_cases` runs on each rank of a group (``launch.spawn``) at one
mesh shape; the caller — the CPU tests, which hold the results against the
JAX package's sharded functions and the single-device ones — builds the
inputs from numpy seeds and the JAX package's initial params, and passes
them in as numpy arrays, so nothing here imports JAX. Every rank runs every
case in the same order (their collectives must meet).
"""
from __future__ import annotations

import numpy as np
import torch

from recommendit_tpu_torch.parallel.embedding import (
    bucketed_embedding_lookup,
    gather_slices,
    sharded_dual_lookup,
    sharded_embedding_lookup,
)
from recommendit_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    AdamW,
    clip_by_global_norm_sharded_,
    create_mesh,
    mesh_device,
    row_sharded,
)
from recommendit_tpu_torch.parallel.retrieval import (
    sharded_mips_topk,
    sharded_mips_topk_ring,
)

MERGES = {"allgather": sharded_mips_topk, "ring": sharded_mips_topk_ring}


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy (on the CPU ``numpy()`` shares the tensor's memory, which
    later in-place steps would change)."""
    return t.detach().cpu().numpy().copy()


def _whole(shard: torch.Tensor, mesh) -> np.ndarray:
    """A row-sharded tensor's global array (its shards gathered over
    ``model``)."""
    with torch.no_grad():
        return _np(gather_slices(shard.detach().contiguous(), mesh, MODEL_AXIS))


def _tensor(x, mesh):
    return torch.as_tensor(np.asarray(x), device=mesh_device(mesh))


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _lookups(mesh, inp) -> dict:
    out = {}
    c = inp["lookup"]
    t = row_sharded(mesh).shard(c["table"])
    out["lookup"] = _np(sharded_embedding_lookup(t, _tensor(c["ids"], mesh), mesh))
    out["ring_replicated"] = _np(bucketed_embedding_lookup(
        t, _tensor(c["ids"], mesh), mesh, replicate_out=True))
    out["ring_packet"] = _np(bucketed_embedding_lookup(t, _tensor(c["ids"], mesh), mesh))
    c = inp["dual"]
    ut, it = (row_sharded(mesh).shard(c[k]) for k in ("user_table", "item_table"))
    ue, ie = sharded_dual_lookup(ut, it, _tensor(c["user_ids"], mesh),
                                 _tensor(c["item_ids"], mesh), mesh)
    out["dual"] = (_np(ue), _np(ie))
    # the table's gradient of <lookup(ids), cot>, both lookups
    c = inp["lookup_grad"]
    cot = _tensor(c["cot"], mesh)
    for name, fn in (("masked", sharded_embedding_lookup),
                     ("ring", lambda t, i, m: bucketed_embedding_lookup(
                         t, i, m, replicate_out=True))):
        t = row_sharded(mesh).shard(c["table"]).requires_grad_(True)
        (fn(t, _tensor(c["ids"], mesh), mesh) * cot).sum().backward()
        out[f"grad_{name}"] = _whole(t.grad, mesh)
    t = row_sharded(mesh).shard(inp["lookup"]["table"])
    out["ring_indivisible_raises"] = _raises(lambda: bucketed_embedding_lookup(
        t, _tensor(np.zeros(31, np.int64), mesh), mesh))
    out["rows_indivisible_raises"] = _raises(
        lambda: row_sharded(mesh).shard(np.ones((31, 4), np.float32)))
    return out


def _retrieval(mesh, inp) -> dict:
    out = {}
    for case in ("retrieval", "ties", "k_big"):
        c = inp[case]
        items = row_sharded(mesh).shard(c["items"])
        for name, fn in MERGES.items():
            v, i = fn(_tensor(c["q"], mesh), items, c["k"], mesh,
                      canonical=c["canonical"])
            out[f"{case}_{name}"] = (_np(v), _np(i))
    return out


def _train(mesh, inp) -> dict:
    from recommendit_tpu_torch.parallel.train import (
        init_sharded_state,
        make_sharded_loss_fn,
        make_sharded_train_step,
        sharded_grads,
    )

    c = inp["train"]
    batch = (_tensor(c["u"], mesh), _tensor(c["i"], mesh))
    out = {}
    # the first step's gradients, summed over data
    params, state = init_sharded_state(mesh, AdamW(c["lr"]), c["params"])
    loss_of = make_sharded_loss_fn(mesh, c["genre"])
    grads = sharded_grads(mesh, params, state.names, loss_of(params, batch))
    out["grads"] = {k: _whole(g, mesh) if k.endswith("_embed") else _np(g)
                    for k, g in zip(state.names, grads)}
    # the same gradients clipped by the global norm over the shards
    clip_by_global_norm_sharded_(grads, state.sharded, c["clip_norm"],
                                 mesh.get_group(MODEL_AXIS))
    out["clipped_grads"] = {k: _whole(g, mesh) if k.endswith("_embed") else _np(g)
                            for k, g in zip(state.names, grads)}
    out["b1_raises"] = _raises(lambda: loss_of(params, tuple(x[:1] for x in batch)))
    for name, tx in (("adam", AdamW(c["lr"])),
                     ("clip_adamw", AdamW(c["lr"], weight_decay=c["weight_decay"],
                                          clip_norm=c["clip_norm"]))):
        params, state = init_sharded_state(mesh, tx, c["params"])
        step = make_sharded_train_step(mesh, tx, c["genre"])
        losses = []
        for _ in range(c["steps"]):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
        out[name] = {
            "losses": losses,
            "params": {k: _whole(p, mesh) if k.endswith("_embed") else _np(p)
                       for k, p in params.items()},
            "mu_shapes": {k: tuple(m.shape) for k, m in state.state_dict()["mu"].items()},
            "local_shapes": {k: tuple(p.shape) for k, p in params.items()},
        }
    return out


def _serve(mesh, inp) -> dict:
    from recommendit_tpu_torch.models.ranker import mlp_score
    from recommendit_tpu_torch.parallel.serve import make_sharded_serve_fn

    c = inp["serve"]
    dev = mesh_device(mesh)
    params = {k: _tensor(v, mesh).float() for k, v in c["params"].items()}
    rparams = {k: _tensor(v, mesh).float() for k, v in c["ranker"].items()}
    serve = make_sharded_serve_fn(
        mesh, params, row_sharded(mesh).shard(c["corpus"]),
        _tensor(c["item_ids"], mesh), _tensor(c["user_packed"], mesh),
        _tensor(c["item_packed"], mesh), lambda f: mlp_score(rparams, f),
        n_candidates=c["n_candidates"], k_out=c["k_out"])
    ids, scores, rvals = serve(torch.as_tensor(c["user_ids"], device=dev))
    return {"serve": (_np(ids), _np(scores), _np(rvals))}


def _ctr(mesh, inp) -> dict:
    from recommendit_tpu_torch.parallel.ctr import (
        init_ctr_sharded_state,
        make_ctr_sharded_train_step,
    )

    c = inp["ctr"]
    out = {}
    for joint in (False, True):
        tx = AdamW(c["lr"])
        params, state = init_ctr_sharded_state(mesh, tx, c["params"])
        step = make_ctr_sharded_train_step(mesh, tx, c["n_user_fields"], joint=joint)
        losses = []
        for batch in c["batches"]:
            params, state, loss = step(params, state,
                                       tuple(_tensor(a, mesh) for a in batch))
            losses.append(float(loss))
        out["joint" if joint else "plain"] = {
            "losses": losses, "embed": _whole(params["embed"], mesh)}
    return out


def run_cases(shape, inputs: dict) -> dict:
    """Every case on this rank of a mesh of ``shape`` → numpy results."""
    mesh = create_mesh(shape=tuple(shape))
    out = {"coordinate": tuple(mesh.get_coordinate())}
    for part in (_lookups, _retrieval, _train, _serve, _ctr):
        out.update(part(mesh, inputs))
    return out
