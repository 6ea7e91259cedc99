"""Scale-configuration smoke runs — torch port of ``scripts/scale_smoke.py``.

Runs the distributed training step and the sharded retrieval at the
configurations' widths on ``--nproc`` ranks (one card each, or gloo ranks
with ``--device cpu``). Rows are capped (``--row-cap``) unless ``--full``,
which uses the real row counts and needs the matching device memory:
``web100m`` holds 51.2 + 5.1 GB of f32 tables, ≈ 169 GB with AdamW's two
moments, so at least four 80 GB cards — and at four the optimizer step's
full-size temporaries do not fit yet (PERF.md §7). Each rank draws only
its own rows of the tables (from ``SEED`` and its shard), so no process
holds a whole table.

Usage:
  python -m recommendit_tpu_torch.scripts.scale_smoke --nproc 2 --device cpu
  python -m recommendit_tpu_torch.scripts.scale_smoke --config ml25m --full --nproc 1
  python -m recommendit_tpu_torch.scripts.scale_smoke --config web100m --full --nproc 4
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

CONFIGS = {
    # name: (n_users, n_items, dim, hidden, batch, corpus_k)
    "ml1m": (6_040, 3_952, 64, 128, 1024, 500),
    "ml25m": (162_541, 62_423, 256, 512, 2048, 500),
    "web100m": (100_000_000, 10_000_000, 128, 256, 4096, 500),
}
STEADY_STEPS = 5
QUERIES = 64
SEED = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _local_table(rows_global: int, dim: int, mesh, seed: int) -> torch.Tensor:
    """This rank's rows of an N(0, 0.1²) table (row 0 the zero padding row),
    drawn from a generator of (seed, shard)."""
    from recommendit_tpu_torch.parallel.mesh import MODEL_AXIS, axis_index, axis_size, mesh_device

    n = axis_size(mesh, MODEL_AXIS)
    shard = axis_index(mesh, MODEL_AXIS)
    rows = rows_global // n
    gen = torch.Generator(device=mesh_device(mesh)).manual_seed(seed * 1009 + shard)
    t = 0.1 * torch.randn((rows, dim), generator=gen, device=mesh_device(mesh))
    if shard == 0:
        t[0] = 0.0
    return t.requires_grad_(True)


def _rank(config: str, full: bool, row_cap: int) -> dict:
    import torch.distributed as dist

    from recommendit_tpu_torch.models.two_tower import init_params
    from recommendit_tpu_torch.parallel import (
        AdamW,
        create_mesh,
        make_sharded_train_step,
        sharded_mips_topk,
    )
    from recommendit_tpu_torch.parallel.mesh import (
        MODEL_AXIS,
        axis_size,
        init_opt_sharded,
        mesh_device,
        row_sharded,
    )
    from recommendit_tpu_torch.parallel.train import dropout_generator

    n_users, n_items, dim, hidden, batch, k = CONFIGS[config]
    if not full:
        n_users, n_items = min(n_users, row_cap), min(n_items, row_cap)
        batch = min(batch, 512)
    n_dev = dist.get_world_size()
    mesh = create_mesh(prefer_model=min(4, n_dev))
    dev = mesh_device(mesh)
    shards = axis_size(mesh, MODEL_AXIS)
    # tables must divide the model axis
    n_users_p = -(-(n_users + 1) // shards) * shards - 1
    n_items_p = -(-(n_items + 1) // shards) * shards - 1
    rank0 = dist.get_rank() == 0
    if rank0:
        print(f"config={config} users={n_users_p} items={n_items_p} dim={dim} "
              f"hidden={hidden} batch={batch} mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"device={dev.type}", flush=True)

    seed = SEED
    rng = np.random.default_rng(seed)
    params = {name: v.to(dev).requires_grad_(True) for name, v in init_params(
        torch.Generator().manual_seed(seed), 1, 1, dim, hidden, device="cpu").items()
        if not name.endswith("_embed") and name != "item_bias"}
    params["item_bias"] = torch.zeros(n_items_p + 1, device=dev, requires_grad=True)
    params["user_embed"] = _local_table(n_users_p + 1, dim, mesh, seed)
    params["item_embed"] = _local_table(n_items_p + 1, dim, mesh, seed + 1)
    genre_table = (rng.random((n_items_p + 1, 18)) < 0.2).astype(np.float32)
    tx = AdamW(1e-3, weight_decay=1e-4, clip_norm=1.0)
    step = make_sharded_train_step(mesh, tx, genre_table, dropout_rate=0.2)
    state = init_opt_sharded(tx, params, mesh)
    u = torch.as_tensor(rng.integers(1, n_users_p, size=batch), device=dev)
    i = torch.as_tensor(rng.integers(1, n_items_p, size=batch), device=dev)
    gen = dropout_generator(mesh, seed + 1)

    out = {"config": config, "users": n_users_p, "items": n_items_p,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "device": dev.type}
    t0 = time.perf_counter()
    params, state, loss = step(params, state, (u, i), gen)
    _sync(dev)
    out["first_step_s"] = time.perf_counter() - t0
    out["first_loss"] = float(loss)
    t0 = time.perf_counter()
    for _ in range(STEADY_STEPS):
        params, state, loss = step(params, state, (u, i), gen)
    _sync(dev)
    dt = (time.perf_counter() - t0) / STEADY_STEPS
    out.update(step_ms=dt * 1e3, examples_per_s=batch / dt, last_loss=float(loss))
    if rank0:
        print(f"train step first: {out['first_step_s']:.2f}s loss={out['first_loss']:.4f}; "
              f"steady: {dt * 1e3:.2f} ms ({batch / dt:.0f} ex/s)", flush=True)
    del params, state

    # sharded-corpus retrieval at the same dim
    corpus_rows = min(n_items_p + 1, 1 << 17)
    corpus_rows = -(-corpus_rows // shards) * shards
    corpus = row_sharded(mesh).shard(
        rng.normal(size=(corpus_rows, dim)).astype(np.float32))
    queries = torch.as_tensor(rng.normal(size=(QUERIES, dim)).astype(np.float32),
                              device=dev)
    t0 = time.perf_counter()
    vals, _ = sharded_mips_topk(queries, corpus, min(k, corpus_rows), mesh)
    _sync(dev)
    out.update(retrieval_rows=corpus_rows, retrieval_s=time.perf_counter() - t0,
               retrieval_top1=float(vals[0, 0]))
    if rank0:
        print(f"sharded retrieval ({corpus_rows} rows x {shards} shards): "
              f"{out['retrieval_s']:.3f}s top1={out['retrieval_top1']:.3f}", flush=True)
    return out


def run(config: str = "ml25m", full: bool = False, row_cap: int = 4096,
        nproc: int = 1, device=DEFAULT_DEVICE, timeout: float = 1800.0) -> list:
    from recommendit_tpu_torch.parallel.launch import spawn

    return spawn(_rank, nproc, (config, full, row_cap), device=device,
                 timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=CONFIGS, default="ml25m")
    ap.add_argument("--full", action="store_true",
                    help="use real row counts (needs matching device memory)")
    ap.add_argument("--row-cap", type=int, default=4096,
                    help="row cap per table when not --full")
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    outs = run(args.config, args.full, args.row_cap, args.nproc, args.device)
    if any(not np.isfinite(o["last_loss"]) for o in outs):
        raise SystemExit(f"non-finite loss: {outs}")
    print(json.dumps(outs[0]))
    print("scale smoke OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
