"""Multi-device dry run — counterpart of ``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n, device)`` spawns n ranks over a ``('data', 'model')``
mesh (model 4, 2 or 1, the largest that divides n) and runs, on tiny
shapes, one sharded two-tower step (row-sharded tables × data parallel,
dropout 0.2, clipping and AdamW), both sharded-retrieval merges (which
must agree) and one joint CTR step over a row-sharded stacked table.

    python -m recommendit_tpu_torch.parallel.dryrun 4 --device cpu
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE


def _model_axis(n: int) -> int:
    return next(m for m in (4, 2, 1) if n % m == 0)


def _rank(n_devices: int) -> dict:
    from recommendit_tpu_torch.models.ctr import field_offsets, init_ctr_params
    from recommendit_tpu_torch.models.two_tower import init_params
    from recommendit_tpu_torch.parallel import (
        AdamW,
        create_mesh,
        init_ctr_sharded_state,
        init_sharded_state,
        make_ctr_sharded_train_step,
        make_sharded_train_step,
        row_sharded,
        sharded_mips_topk,
        sharded_mips_topk_ring,
    )
    from recommendit_tpu_torch.parallel.mesh import mesh_device
    from recommendit_tpu_torch.parallel.train import dropout_generator

    model_axis = _model_axis(n_devices)
    mesh = create_mesh(shape=(n_devices // model_axis, model_axis))
    dev = mesh_device(mesh)
    n_users = n_items = 16 * model_axis   # divisible by the model axis
    d, h, batch = 16, 32, 4 * n_devices

    params = init_params(torch.Generator().manual_seed(0), n_users - 1,
                         n_items - 1, d, h, device="cpu")
    rng = np.random.default_rng(0)
    genre_table = (rng.random((n_items, 18)) < 0.2).astype(np.float32)
    tx = AdamW(1e-3, weight_decay=1e-4, clip_norm=1.0)
    step = make_sharded_train_step(mesh, tx, genre_table, dropout_rate=0.2)
    sp, so = init_sharded_state(mesh, tx, params)
    u_ids = torch.as_tensor(rng.integers(1, n_users, size=batch), device=dev)
    i_ids = torch.as_tensor(rng.integers(1, n_items, size=batch), device=dev)
    sp, so, loss = step(sp, so, (u_ids, i_ids), dropout_generator(mesh, 1))
    loss = float(loss)
    assert math.isfinite(loss), f"non-finite loss {loss}"

    # sharded-corpus retrieval over the mesh (both merge schedules)
    corpus = row_sharded(mesh).shard(
        rng.normal(size=(16 * n_devices, d)).astype(np.float32))
    queries = torch.as_tensor(rng.normal(size=(4, d)).astype(np.float32), device=dev)
    vals, idx = sharded_mips_topk(queries, corpus, 8, mesh)
    assert vals.shape == (4, 8) and bool(torch.isfinite(vals).all())
    _, ridx = sharded_mips_topk_ring(queries, corpus, 8, mesh)
    assert bool((ridx == idx).all()), "ring merge must match all-gather merge"

    # the joint CTR step: stacked 26-field table row-sharded on 'model'
    vocab_sizes = [8, 4, 4, 8, 4, 4, 8, 4] + [8, 4] * 9   # 26 fields
    ctr_params = init_ctr_params(
        torch.Generator().manual_seed(2), vocab_sizes, embed_dim=8,
        top_hidden=(32,), retrieval_dim=8, pad_rows_to=model_axis, device="cpu")
    ctr_tx = AdamW(1e-3)
    cp, co = init_ctr_sharded_state(mesh, ctr_tx, ctr_params)
    ctr_step = make_ctr_sharded_train_step(mesh, ctr_tx, n_user_fields=8)
    raw = np.stack([rng.integers(0, v, size=batch) for v in vocab_sizes], axis=1)
    ctr_batch = tuple(torch.as_tensor(a, device=dev) for a in (
        rng.normal(size=(batch, 13)).astype(np.float32),
        raw + field_offsets(vocab_sizes)[None, :],
        (rng.random(batch) < 0.25).astype(np.float32)))
    cp, co, ctr_loss = ctr_step(cp, co, ctr_batch)
    ctr_loss = float(ctr_loss)
    assert math.isfinite(ctr_loss), f"non-finite CTR loss {ctr_loss}"
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "loss": loss,
            "retrieval_top1": float(vals[0, 0]), "ctr_loss": ctr_loss}


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE,
                     timeout: float = 300.0) -> dict:
    """Run the dry run on ``n_devices`` ranks (one card each on ``cuda``,
    which raises with fewer cards) → rank 0's summary; every rank must
    report the same losses."""
    from recommendit_tpu_torch.parallel.launch import spawn

    outs = spawn(_rank, n_devices, (n_devices,), device=device, timeout=timeout)
    for o in outs[1:]:
        if (o["loss"], o["ctr_loss"]) != (outs[0]["loss"], outs[0]["ctr_loss"]):
            raise AssertionError(f"ranks disagree on the losses: {outs}")
    r = outs[0]
    print(f"dryrun_multichip OK: mesh={r['mesh']} loss={r['loss']:.4f} "
          f"retrieval_top1={r['retrieval_top1']:.3f} "
          f"ctr_loss={r['ctr_loss']:.4f}", flush=True)
    return r


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=("cuda", "cpu"))
    args = ap.parse_args()
    dryrun_multichip(args.n, args.device)
