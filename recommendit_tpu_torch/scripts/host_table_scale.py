"""Host-table (larger-than-HBM) training at real row counts — the
counterpart of ``scripts/host_table_scale.py``.

Drives ``HostTableEmbeddingTrainer`` end to end: the tables in host RAM (or
a memmap with ``--memmap-dir``), only each batch's rows on the card. The
``web100m`` configuration's user table (100M x 128 f32 = 51.2 GB) is larger
than one card's memory — the point of the trainer. ``--mode hbm`` trains
the same data with the in-HBM ``EmbeddingTrainer``; ``both`` runs the two.

    python -m recommendit_tpu_torch.scripts.host_table_scale --config ml25m --mode both
    python -m recommendit_tpu_torch.scripts.host_table_scale --config web100m \\
        --ratings 2000000 --epochs 1

Runs on the card (without one it fails; ``--device cpu`` runs the twins
here). Prints the JAX script's JSON line (``platform`` is the card's name),
with each trainer's per-epoch history beside it. The loss is the JAX
script's ``softmax`` unless ``--loss-mode`` says otherwise (``in_batch``
runs the BPR kernels every step).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

CONFIGS = {
    # name: (n_users, n_items, dim, hidden, batch)
    "ml1m": (6_040, 3_952, 64, 128, 1024),
    "ml25m": (162_541, 62_423, 256, 512, 2048),
    "web100m": (100_000_000, 10_000_000, 128, 256, 4096),
}


def sparse_synthetic(n_users: int, n_items: int, n_ratings: int, seed: int):
    """A ``MovieLensData`` whose id range spans the whole tables and whose
    rating count is the training stream's length (the JAX script's draws in
    its order, without pandas): uniform users, items skewed as n·u³, every
    rating a positive (4 or 5), the largest ids pinned to row 0."""
    from recommendit_tpu_torch.data.movielens import MovieLensData
    from recommendit_tpu_torch.features.schema import encode_genres_matrix

    rng = np.random.default_rng(seed)
    u = rng.integers(1, n_users + 1, size=n_ratings)
    i = (n_items * rng.random(size=n_ratings) ** 3).astype(np.int64) + 1
    u[0], i[0] = n_users, n_items
    rating = rng.integers(4, 6, size=n_ratings)
    timestamp = rng.integers(9e8, 1e9, size=n_ratings).astype(np.int64)
    genre_strs = np.array(["Drama"])
    return MovieLensData(
        user_id=u, item_id=i, rating=rating, timestamp=timestamp,
        user_ids=np.array([n_users]), item_ids=np.array([n_items]),
        genres=encode_genres_matrix(genre_strs), gender=np.array(["F"]),
        age=np.array([25]), occupation=np.array([0]), zip_code=np.array(["00000"]),
        titles=np.array(["x (1999)"]), genre_strs=genre_strs)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=CONFIGS, default="ml25m")
    ap.add_argument("--mode", choices=["host", "hbm", "both"], default="host")
    ap.add_argument("--ratings", type=int, default=1_000_000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=0, help="override batch")
    ap.add_argument("--dim", type=int, default=0, help="override dim")
    ap.add_argument("--memmap-dir", default="", help="disk-backed tables")
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--loss-mode", default="softmax",
                    choices=["softmax", "in_batch", "pairwise"])
    ap.add_argument("--seed", type=int, default=0, help="the synthetic stream's seed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    return ap.parse_args(argv)


def scale_settings(args: argparse.Namespace):
    """(Settings, dims) of the configuration, as the JAX script sets them."""
    from recommendit_tpu_torch.config import Settings

    n_users, n_items, dim, hidden, batch = CONFIGS[args.config]
    batch = args.batch or batch
    dim = args.dim or dim
    cfg = Settings(
        EMBEDDING_DIM=dim, HIDDEN_DIM=hidden, BATCH_SIZE=batch,
        TRAIN_EPOCHS=args.epochs, LOSS_MODE=args.loss_mode, DROPOUT=0.0,
        HOST_TABLE=True, HOST_TABLE_PREFETCH=args.prefetch,
        HOST_TABLE_DIR=args.memmap_dir,
        EMBEDDING_MODEL_PATH="",  # no 50 GB model write
        TRAIN_JIT_SCOPE="step", SEED=args.seed)
    return cfg, (n_users, n_items, dim, hidden, batch)


def steady_ex_per_s(history) -> float:
    """Mean examples/s over the epochs after the first (which carries the
    warm-up), or the first where there is one."""
    steady = history[1:] or history
    return float(np.mean([h["examples_per_s"] for h in steady]))


def run(args: argparse.Namespace):
    """Train as ``args`` say → (the JSON line's dict, the trainers by mode)."""
    import torch

    from recommendit_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg, (n_users, n_items, dim, hidden, batch) = scale_settings(args)
    platform = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else device.type)
    table_gb = (n_users + n_items + 2) * dim * 4 / 2**30
    print(f"config={args.config} users={n_users} items={n_items} dim={dim} "
          f"hidden={hidden} batch={batch} ratings={args.ratings} "
          f"tables={table_gb:.1f} GiB platform={platform}", flush=True)

    t0 = time.time()
    data = sparse_synthetic(n_users, n_items, args.ratings, seed=args.seed)
    print(f"synthetic stream built in {time.time() - t0:.1f}s", flush=True)
    out = {"config": args.config, "platform": platform,
           "table_gib": round(table_gb, 2), "batch": batch, "dim": dim}
    trainers = {}

    if args.mode in ("host", "both"):
        from recommendit_tpu_torch.training.host_train import HostTableEmbeddingTrainer

        t0 = time.time()
        tr = HostTableEmbeddingTrainer(data, cfg, model_output_path="", device=device)
        print(f"tables allocated+initialized in {time.time() - t0:.1f}s", flush=True)
        tr.train()
        out["host_ex_per_s"] = round(steady_ex_per_s(tr.history))
        out["host_losses"] = [round(h["loss"], 4) for h in tr.history]
        out["host_history"] = tr.history
        trainers["host"] = tr

    if args.mode in ("hbm", "both"):
        from recommendit_tpu_torch.training.train_embeddings import EmbeddingTrainer

        tr = EmbeddingTrainer(data, cfg.replace(HOST_TABLE=False), model_output_path="",
                              device=device)
        tr.train()
        out["hbm_ex_per_s"] = round(steady_ex_per_s(tr.history))
        out["hbm_losses"] = [round(h["loss"], 4) for h in tr.history]
        out["hbm_history"] = tr.history
        trainers["hbm"] = tr
    return out, trainers


def main(argv: Optional[List[str]] = None) -> int:
    out, _ = run(parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
