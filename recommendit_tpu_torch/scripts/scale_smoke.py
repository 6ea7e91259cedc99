"""Scale-configuration smoke runs — torch port of ``scripts/scale_smoke.py``.

Runs the distributed training step and the sharded retrieval at the
configurations' widths on ``--nproc`` ranks (one card each, or gloo ranks
with ``--device cpu``). Rows are capped (``--row-cap``) unless ``--full``,
which uses the real row counts and needs the matching device memory:
``web100m`` holds 51.2 + 5.1 GB of f32 tables, so at least four 80 GB
cards. At four, a rank holds 25,000,001 user and 2,500,001 item rows, and
its state — params, grads and AdamW's two moments, 4 x 14.1 GB — peaks
at that plus a few chunks of scratch: the optimizer step runs in place a
bounded chunk at a time and the gradients are summed in place, as JAX's
donated step does. ``chip_smoke.py``'s ``web100m_shard`` phase runs that
one rank's shard on one card (:func:`train_shard` with ``of_shards=4``).
Each rank draws only its own rows of the tables (from ``SEED`` and its
shard), so no process holds a whole table.

Usage:
  python -m recommendit_tpu_torch.scripts.scale_smoke --nproc 2 --device cpu
  python -m recommendit_tpu_torch.scripts.scale_smoke --config ml25m --full --nproc 1
  python -m recommendit_tpu_torch.scripts.scale_smoke --config web100m --full --nproc 4
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

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


def _local_table(rows: int, dim: int, shard: int, dev: torch.device,
                 seed: int) -> torch.Tensor:
    """Shard ``shard``'s ``rows`` rows of an N(0, 0.1²) table (row 0 of
    shard 0 the zero padding row), drawn from a generator of (seed, shard)."""
    gen = torch.Generator(device=dev).manual_seed(seed * 1009 + shard)
    t = torch.randn((rows, dim), generator=gen, device=dev).mul_(0.1)
    if shard == 0:
        t[0] = 0.0
    return t.requires_grad_(True)


def padded_rows(n: int, shards: int) -> int:
    """The table's rows less the padding row 0, padded so that rows + 1
    divide ``shards``."""
    return -(-(n + 1) // shards) * shards - 1


def train_shard(mesh, config: str, full: bool = False, row_cap: int = 4096,
                of_shards: Optional[int] = None, steps: int = STEADY_STEPS,
                loss_fn: Optional[Callable] = None, seed: int = SEED) -> dict:
    """The training half of a rank: ``1 + steps`` sharded two-tower steps
    (dim, hidden, batch of ``config``; in-batch BPR; dropout 0.2; AdamW
    with weight decay 1e-4 and clipping at 1.0) on ``mesh``.

    The tables are laid out as over a ``model`` axis of ``of_shards``
    ranks (default: the mesh's own): each rank of ``mesh`` holds the rows
    one rank of that layout holds, drawn for its shard, and the batch's
    ids are drawn among the rows the mesh holds. So a ``(1, 1)`` mesh with
    ``of_shards=4`` runs exactly the shard, and the memory, of one rank of
    a four-card run. The item bias and the genre table are replicated at
    the whole catalog's rows, as every rank holds them. ``loss_fn`` (the
    step's loss of the gathered towers) defaults to the in-batch BPR.

    Returns the run's record: rows, losses, ms a step, and the bytes of
    the state (params + grads + two moments) and, on the card, the peak
    allocated since the call (``peak_gib``)."""
    import torch.distributed as dist

    from recommendit_tpu_torch.models.two_tower import init_params
    from recommendit_tpu_torch.ops.bpr import in_batch_bpr_loss
    from recommendit_tpu_torch.parallel import AdamW, make_sharded_train_step
    from recommendit_tpu_torch.parallel.mesh import (
        MODEL_AXIS,
        axis_index,
        axis_size,
        init_opt_sharded,
        mesh_device,
    )
    from recommendit_tpu_torch.parallel.train import dropout_generator

    n_users, n_items, dim, hidden, batch, _ = CONFIGS[config]
    if not full:
        n_users, n_items = min(n_users, row_cap), min(n_items, row_cap)
        batch = min(batch, 512)
    dev = mesh_device(mesh)
    shards = axis_size(mesh, MODEL_AXIS)
    layout = of_shards or shards
    if layout % shards:
        raise ValueError(f"a layout over {layout} shards cannot map onto a "
                         f"model axis of {shards}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # tables must divide the model axis
    n_users_p, n_items_p = padded_rows(n_users, layout), padded_rows(n_items, layout)
    user_rows, item_rows = (n_users_p + 1) // layout, (n_items_p + 1) // layout
    shard = axis_index(mesh, MODEL_AXIS)
    out = {"config": config, "users": n_users_p, "items": n_items_p,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "device": dev.type,
           "of_shards": layout, "user_rows": user_rows, "item_rows": item_rows}
    if dist.get_rank() == 0:
        print(f"config={config} users={n_users_p} items={n_items_p} dim={dim} "
              f"hidden={hidden} batch={batch} mesh={out['mesh']} "
              f"rows a rank={user_rows}+{item_rows} (of {layout} shards) "
              f"device={dev.type}", flush=True)

    rng = np.random.default_rng(seed)
    params = {name: v.to(dev).requires_grad_(True) for name, v in init_params(
        torch.Generator().manual_seed(seed), 1, 1, dim, hidden, device="cpu").items()
        if not name.endswith("_embed") and name != "item_bias"}
    params["item_bias"] = torch.zeros(n_items_p + 1, device=dev, requires_grad=True)
    params["user_embed"] = _local_table(user_rows, dim, shard, dev, seed)
    params["item_embed"] = _local_table(item_rows, dim, shard, dev, seed + 1)
    genre_table = (rng.random((n_items_p + 1, 18)) < 0.2).astype(np.float32)
    tx = AdamW(1e-3, weight_decay=1e-4, clip_norm=1.0)
    step = make_sharded_train_step(mesh, tx, genre_table, dropout_rate=0.2,
                                   loss_fn=loss_fn or in_batch_bpr_loss)
    state = init_opt_sharded(tx, params, mesh)
    out["state_gib"] = 4 * sum(p.numel() * p.element_size()
                               for p in params.values()) / 2**30
    # ids among the rows the mesh holds (all of them where the layout is the mesh's)
    u = torch.as_tensor(rng.integers(1, min(n_users_p, user_rows * shards), size=batch),
                        device=dev)
    i = torch.as_tensor(rng.integers(1, min(n_items_p, item_rows * shards), size=batch),
                        device=dev)
    gen = dropout_generator(mesh, seed + 1)

    t0 = time.perf_counter()
    params, state, loss = step(params, state, (u, i), gen)
    _sync(dev)
    out["first_step_s"] = time.perf_counter() - t0
    losses = [float(loss)]
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(params, state, (u, i), gen)
        losses.append(loss)
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps
    out.update(first_loss=losses[0], losses=[float(x) for x in losses], step_ms=dt * 1e3,
               examples_per_s=batch / dt, last_loss=float(loss), batch=batch)
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if dist.get_rank() == 0:
        print(f"train step first: {out['first_step_s']:.2f}s loss={out['first_loss']:.4f}; "
              f"steady: {dt * 1e3:.2f} ms ({batch / dt:.0f} ex/s); state "
              f"{out['state_gib']:.2f} GiB" + (f", peak {out['peak_gib']:.2f} GiB"
                                                if "peak_gib" in out else ""), flush=True)
    return out


def _rank(config: str, full: bool, row_cap: int) -> dict:
    import torch.distributed as dist

    from recommendit_tpu_torch.parallel import create_mesh, sharded_mips_topk
    from recommendit_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size, mesh_device, row_sharded

    k = CONFIGS[config][-1]
    mesh = create_mesh(prefer_model=min(4, dist.get_world_size()))
    dev = mesh_device(mesh)
    shards = axis_size(mesh, MODEL_AXIS)
    out = train_shard(mesh, config, full, row_cap)

    # sharded-corpus retrieval at the same dim
    rng = np.random.default_rng(SEED + 2)
    dim = CONFIGS[config][2]
    corpus_rows = min(out["items"] + 1, 1 << 17)
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
    if dist.get_rank() == 0:
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
