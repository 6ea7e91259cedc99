"""Ranker-config A/B over an existing ``quality_at_scale`` work-dir — torch
port of ``scripts/ranker_ab.py``.

Retrains only the ranker stage under ``--cfg`` overrides (the towers, the
index and the features are reused), saving it as
``<work-dir>/models/ranker_<name>.npz`` (``respect_cfg_paths=True`` keeps
that path), then evaluates at each serving blend β of ``--betas`` by
replacing the orchestrator's ``cfg``. Appends one JSON line to ``--log``.

One difference from JAX's script: JAX's ``inner_holdout`` is always ``{}``
— its ``run_ranker`` returns the holdout dict and the script reads
``holdout_metrics`` off that dict — while the port reports the holdout
dict the ranker stage returns.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.ranker_ab --name wide \\
      --work-dir /tmp/qscale --cfg RANKER_HIDDEN_DIMS=... --betas 1,2
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE


def parse_args(argv=None):
    tmp = os.path.join(tempfile.gettempdir(), "qscale")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", required=True)
    ap.add_argument("--work-dir", default=tmp)
    ap.add_argument("--users", type=int, default=40000)
    ap.add_argument("--items", type=int, default=62423)
    ap.add_argument("--eval-users", type=int, default=2000)
    ap.add_argument("--betas", default="1,2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg", action="append", default=[])
    ap.add_argument("--log", default=None,
                    help="JSON-lines log (default: <work-dir>/ranker_ab.jsonl)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    args.log = args.log or f"{args.work_dir}/ranker_ab.jsonl"
    return args


def run(args) -> dict:
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides

    ranker_path = f"{args.work_dir}/models/ranker_{args.name}.npz"
    cfg = Settings(
        SEED=args.seed, HOST_TABLE=True, TRAIN_EPOCHS=5,
        SYNTH_USERS=args.users, SYNTH_ITEMS=args.items,
        RANKER_MODEL_PATH=ranker_path,
    )
    cfg = apply_overrides(cfg, args.cfg)

    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=f"{args.work_dir}/ml",
        models_dir=f"{args.work_dir}/models",
        features_dir=f"{args.work_dir}/features",
        synthetic=False, eval_users=args.eval_users,
        respect_cfg_paths=True,  # keep the per-variant ranker path
        device=args.device,
    )
    t0 = time.time()
    holdout = dict(orch.run_stage("ranker") or {})
    train_s = time.time() - t0

    rows = []
    for beta in [float(b) for b in args.betas.split(",")]:
        # replace the orchestrator's cfg (it holds the models_dir-remapped
        # artifact paths; a cfg rebuilt from the raw one would point the
        # evaluate stage at relative paths)
        orch.cfg = orch.cfg.replace(RANKER_BLEND_RETRIEVAL=beta)
        rep = orch.run_stage("evaluate")
        rows.append({
            "beta": beta,
            "full_ndcg@10": rep.get("ndcg@10"),
            "full_recall@20": rep.get("recall@20"),
            "full_mrr": rep.get("mrr"),
            "retrieval_only_ndcg@10": rep.get("retrieval_only_ndcg@10"),
            "retrieval_only_recall@20": rep.get("retrieval_only_recall@20"),
            "paired_diff": rep.get("paired_ndcg10_full_minus_retrieval"),
            "paired_t": rep.get("paired_ndcg10_t"),
            "retrieval_only_mrr": rep.get("retrieval_only_mrr"),
        })
        print(json.dumps(rows[-1]), flush=True)

    result = {
        "name": args.name, "seed": args.seed,
        "cfg": dict(kv.split("=", 1) for kv in args.cfg),
        "ranker_train_s": round(train_s, 1),
        "inner_holdout": holdout,
        "serving": rows,
        "eval_users": args.eval_users,
    }
    with open(args.log, "a") as f:
        f.write(json.dumps(result, default=float) + "\n")
    return result


def main(argv=None) -> int:
    from recommendit_tpu_torch.utils.logging import setup_logging

    setup_logging("INFO")
    result = run(parse_args(argv))
    print(json.dumps(result, indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
