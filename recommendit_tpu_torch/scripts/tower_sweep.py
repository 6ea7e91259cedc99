"""Retrieval-only tower sweep on the canonical benchmark — torch port of
``scripts/tower_sweep.py``.

Trains the towers and builds the index (the pipeline's ``embeddings`` and
``index`` stages), then scores the retrieval-only and popularity rows with
the reference's temporal protocol (the last 10 % of the ratings by time
held out, relevance = rating ≥ 4, the train-time items filtered), as
JAX's driver does; the ranker is not trained. The q3k data (3,000 x 2,000
x 400k, data seed 0) is generated once into ``<work-dir>/data`` and
shared across configurations, so rows are comparable. Appends one JSON
line per (name, seed), and an aggregate line over several seeds, to
``--log``.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.tower_sweep --name dim128 \\
      --seeds 2 --cfg EMBEDDING_DIM=128 [--cfg LOSS_MODE=in_batch]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE


def popularity_report(data, split, known) -> dict:
    """The popularity row over the users ``known`` (the retrieval row's) of
    ``split`` (``run_pipeline.temporal_split``): the train rows' items by
    count, each user's train-time items filtered."""
    from recommendit_tpu_torch.evaluation.metrics import evaluate_model
    from recommendit_tpu_torch.pipelines.run_pipeline import first_unseen
    from recommendit_tpu_torch.serving.recommender import popularity_order

    pop_all = popularity_order(data.item_id[split.train_rows]).tolist()
    return evaluate_model({u: first_unseen(split.seen_train, u, pop_all) for u in known},
                          split.truth, k_values=[10, 20])


def run_one(name: str, seed: int, args) -> dict:
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.data.movielens import save_movielens
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
    from recommendit_tpu_torch.evaluation.metrics import evaluate_model
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.pipelines.run_pipeline import (
        PipelineOrchestrator,
        first_unseen,
        temporal_split,
    )
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides

    cfg = apply_overrides(Settings(SEED=seed, SYNTH_USERS=args.users,
                                   SYNTH_ITEMS=args.items, SYNTH_RATINGS=args.ratings),
                          args.cfg)
    data_dir = f"{args.work_dir}/data"
    if not os.path.exists(f"{data_dir}/ratings.dat"):
        save_movielens(make_synthetic_movielens(
            n_users=args.users, n_items=args.items, n_ratings=args.ratings,
            seed=args.data_seed), data_dir)

    work = f"{args.work_dir}/{name}_s{seed}"
    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=data_dir, models_dir=f"{work}/models",
        features_dir=f"{work}/features", synthetic=False,
        eval_users=args.eval_users, device=args.device,
    )
    t0 = time.time()
    orch.run_stage("embeddings")
    orch.run_stage("index")

    # the retrieval-only and popularity rows, reference temporal protocol
    data = orch._load_data()
    split = temporal_split(data, args.eval_users, cfg.FILTER_SEEN)
    model = TwoTower.load(orch.cfg.EMBEDDING_MODEL_PATH, device=args.device)
    index = MIPSIndex.load(orch.cfg.INDEX_PATH, device=args.device)
    known = [u for u in split.users if 1 <= u <= model.n_users]
    q = np.stack([model.get_user_embedding(u) for u in known])
    k_search = (min(cfg.TOP_K_CANDIDATES, index.n_total)
                if cfg.FILTER_SEEN else 20)
    _, ids = index.batch_search(q, k=k_search)
    retr = evaluate_model(
        {u: first_unseen(split.seen_train, u, ids[i].tolist())
         for i, u in enumerate(known)},
        split.truth, k_values=[10, 20])
    # popularity over the same users as retrieval, as JAX's driver scores it
    pop = popularity_report(data, split, known)
    return {
        "name": name, "seed": seed,
        "retrieval_ndcg@10": retr["ndcg@10"],
        "retrieval_recall@20": retr["recall@20"],
        "retrieval_mrr": retr["mrr"],
        "popularity_ndcg@10": pop["ndcg@10"],
        "ret_over_pop": retr["ndcg@10"] / max(pop["ndcg@10"], 1e-12),
        "cfg": {kv.split("=", 1)[0]: kv.split("=", 1)[1]
                for kv in (args.cfg or [])},
        "seconds": round(time.time() - t0, 1),
    }


def parse_args(argv=None):
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", required=True)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--users", type=int, default=3000)
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--ratings", type=int, default=400_000)
    ap.add_argument("--eval-users", type=int, default=500)
    ap.add_argument("--cfg", action="append",
                    help="Settings override KEY=VALUE (repeatable)")
    ap.add_argument("--work-dir", default=os.path.join(tmp, "tower_sweep"))
    ap.add_argument("--log", default=os.path.join(tmp, "tower_sweep.jsonl"))
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def run(args) -> list:
    """One row per seed, then the aggregate over several seeds; each line
    printed and appended to ``--log`` → the lines, in that order."""
    lines = []

    def emit(row):
        lines.append(row)
        line = json.dumps(row, default=float)
        print(line, flush=True)
        with open(args.log, "a") as f:
            f.write(line + "\n")

    rows = []
    for s in range(args.seed_base, args.seed_base + args.seeds):
        rows.append(run_one(args.name, s, args))
        emit(rows[-1])
    if len(rows) > 1:
        emit({
            "name": args.name, "agg": True, "n_seeds": len(rows),
            "retrieval_ndcg@10": float(
                np.mean([r["retrieval_ndcg@10"] for r in rows])),
            "std": float(np.std([r["retrieval_ndcg@10"] for r in rows])),
            "popularity_ndcg@10": rows[0]["popularity_ndcg@10"],
            "ret_over_pop": float(np.mean([r["ret_over_pop"] for r in rows])),
        })
    return lines


def main(argv=None) -> int:
    from recommendit_tpu_torch.utils.logging import setup_logging

    setup_logging("WARNING")
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
