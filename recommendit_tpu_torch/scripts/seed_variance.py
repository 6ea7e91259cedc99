"""Seed-variance quality report — torch port of ``scripts/seed_variance.py``.

Parity with dropout on is statistical (the negative sampling and the
dropout masks are seeded), so quality is reported as mean ± std over
seeds. The dataset and the offline features are built once (seed 0); the
embeddings, index, ranker and evaluate stages run at each seed, each into
its own models directory. Prints JAX's lines and writes JAX's JSON
(``<work-dir>/seed_variance.json``).

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.seed_variance --seeds 3 \\
      --data-dir /tmp/var/ml [--epochs 30]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

KEYS = ["ndcg@10", "recall@20", "mrr", "retrieval_only_ndcg@10",
        "popularity_ndcg@10"]


def parse_args(argv=None):
    tmp = os.path.join(tempfile.gettempdir(), "seedvar")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--data-dir", default=f"{tmp}/ml")
    ap.add_argument("--work-dir", default=tmp)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--eval-users", type=int, default=150)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def run(args) -> dict:
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator

    reports = []
    for seed in range(args.seeds):
        cfg = Settings(SEED=seed)
        if args.epochs:
            cfg = cfg.replace(TRAIN_EPOCHS=args.epochs)
        orch = PipelineOrchestrator(
            cfg=cfg,
            data_dir=args.data_dir,             # dataset shared across seeds
            models_dir=f"{args.work_dir}/models_s{seed}",
            features_dir=f"{args.work_dir}/features",
            synthetic=True,
            eval_users=args.eval_users,
            device=args.device,
        )
        # the dataset and the offline features are shared across seeds
        # (built once); only the seeded model training varies
        if seed == 0:
            orch.run_stage("data")
            orch.run_stage("features")
        for stage in ("embeddings", "index", "ranker"):
            orch.run_stage(stage)
        rep = orch.run_stage("evaluate")
        reports.append(rep)
        print(f"seed {seed}: ndcg@10={rep['ndcg@10']:.4f} "
              f"recall@20={rep['recall@20']:.4f} mrr={rep['mrr']:.4f}",
              flush=True)

    agg = {}
    print("\n=== seed variance (n=%d) ===" % args.seeds)
    for k in KEYS:
        vals = np.array([r.get(k, np.nan) for r in reports], float)
        agg[k] = {"mean": float(np.nanmean(vals)),
                  "std": float(np.nanstd(vals))}
        print(f"{k:<26} {np.nanmean(vals):.4f} ± {np.nanstd(vals):.4f}")
    out = f"{args.work_dir}/seed_variance.json"
    result = {"n_seeds": args.seeds, "metrics": agg, "reports": reports}
    with open(out, "w") as f:
        json.dump(result, f, indent=2, default=float)
    print(f"\nwritten → {out}")
    return result


def main(argv=None) -> int:
    from recommendit_tpu_torch.utils.logging import setup_logging

    setup_logging("WARNING")
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
