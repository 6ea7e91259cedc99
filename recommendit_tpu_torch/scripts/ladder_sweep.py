"""Two-stage quality-ladder sweep over the synthetic generator's weights —
torch port of ``scripts/ladder_sweep.py``.

The generator (``data/synthetic.py``) mixes tower-learnable signal
(bilinear latent, genre match), ranker-only signal (item quality, the
nonlinear loyalty bonus) and an exposure-quality correlation. For one
weight mix (``--weights``, a JSON dict of ``SynthWeights`` overrides) this
runs the whole pipeline — ``features``, ``embeddings``, ``index``, the
candidates-mode ``ranker``, the temporal ``evaluate`` — and reports the
three-row ladder (popularity, retrieval-only, full two-stage) with the
ranker's holdout metrics (``holdout_*``), one JSON line per seed and an
aggregate with ``ret_over_pop`` and ``full_over_ret``, each also appended
to ``--log``.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.ladder_sweep --name base --seeds 2 \\
      --weights '{"exposure_quality": 0.2, "latent": 1.1}' \\
      [--epochs 60] [--eval-users 300] [--ranker-type mlp]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

KEYS = ["ndcg@10", "recall@20", "mrr", "retrieval_only_ndcg@10",
        "retrieval_only_recall@20", "retrieval_only_mrr",
        "popularity_ndcg@10", "popularity_recall@20", "popularity_mrr"]


def run_one(name: str, weights: dict, seed: int, args) -> dict:
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.data.movielens import save_movielens
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides

    cfg = Settings(SEED=seed)
    overrides = {}
    if args.epochs:
        overrides["TRAIN_EPOCHS"] = args.epochs
    if args.ranker_type:
        overrides["RANKER_TYPE"] = args.ranker_type
    cfg = apply_overrides(cfg.replace(**overrides), args.cfg)

    work = f"{args.work_dir}/{name}_s{seed}"
    data_dir = f"{args.work_dir}/{name}_data"
    if not os.path.exists(f"{data_dir}/ratings.dat"):
        save_movielens(make_synthetic_movielens(
            n_users=cfg.SYNTH_USERS, n_items=cfg.SYNTH_ITEMS,
            n_ratings=cfg.SYNTH_RATINGS, seed=args.data_seed,
            weights=weights), data_dir)
    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=data_dir, models_dir=f"{work}/models",
        features_dir=f"{work}/features", synthetic=False,
        eval_users=args.eval_users, device=args.device,
    )
    t0 = time.time()
    holdout = {}
    for stage in ("features", "embeddings", "index", "ranker"):
        out = orch.run_stage(stage)
        if stage == "ranker" and isinstance(out, dict):
            holdout = {f"holdout_{k}": v for k, v in out.items()}
    rep = orch.run_stage("evaluate")
    rep = {k: v for k, v in rep.items() if isinstance(v, (int, float))}
    rep.update(holdout)
    rep["seconds"] = round(time.time() - t0, 1)
    return rep


def parse_args(argv=None):
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", required=True)
    ap.add_argument("--weights", default="{}",
                    help="JSON dict of SynthWeights field overrides")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--eval-users", type=int, default=300)
    ap.add_argument("--ranker-type", default=None)
    ap.add_argument("--cfg", action="append",
                    help="extra Settings override KEY=VALUE (repeatable)")
    ap.add_argument("--work-dir", default=os.path.join(tmp, "ladder"))
    ap.add_argument("--log", default=os.path.join(tmp, "ladder_sweep.jsonl"))
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def run(args) -> dict:
    """Every seed's line, then the aggregate, each printed and appended to
    ``--log`` → {"lines": the seeds' lines, "summary": the aggregate,
    "reports": each seed's whole numeric report}."""
    weights = json.loads(args.weights)

    def emit(line):
        print(json.dumps(line), flush=True)
        with open(args.log, "a") as f:
            f.write(json.dumps(line) + "\n")

    reports, lines = [], []
    for s in range(args.seed_base, args.seed_base + args.seeds):
        rep = run_one(args.name, weights, s, args)
        reports.append(rep)
        lines.append({"name": args.name, "seed": s, "weights": weights,
                      **{k: round(rep.get(k, float("nan")), 4) for k in KEYS},
                      **{k: round(v, 4) for k, v in rep.items()
                         if k.startswith("holdout_")},
                      "seconds": rep["seconds"]})
        emit(lines[-1])

    agg = {k: float(np.nanmean([r.get(k, np.nan) for r in reports]))
           for k in KEYS}
    pop, ret, full = (agg["popularity_ndcg@10"],
                      agg["retrieval_only_ndcg@10"], agg["ndcg@10"])
    summary = {
        "name": args.name, "agg": True, "n_seeds": args.seeds,
        "weights": weights,
        **{k: round(v, 4) for k, v in agg.items()},
        "ret_over_pop": round(ret / max(pop, 1e-9), 3),
        "full_over_ret": round(full / max(ret, 1e-9), 3),
        "std_ndcg@10": round(float(np.nanstd(
            [r.get("ndcg@10", np.nan) for r in reports])), 4),
    }
    emit(summary)
    return {"lines": lines, "summary": summary, "reports": reports}


def main(argv=None) -> int:
    from recommendit_tpu_torch.utils.logging import setup_logging

    setup_logging("WARNING")
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
