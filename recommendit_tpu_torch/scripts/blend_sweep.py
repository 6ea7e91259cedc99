"""Serving-blend (``RANKER_BLEND_RETRIEVAL``) sweep over existing artifacts —
torch port of ``scripts/blend_sweep.py``.

The blend weight β is applied when the serving pipeline is built, so a
sweep needs no retraining: this reuses a ``quality_at_scale`` work-dir
(towers, index, ranker, features) and re-runs only the ``evaluate`` stage
at each β of ``--betas``, printing one JSON row per β and writing the rows
to ``--out``.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.blend_sweep --work-dir /tmp/qscale \\
      --betas 0,0.5,1,2,4 [--eval-users 2000]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE


def parse_args(argv=None):
    tmp = os.path.join(tempfile.gettempdir(), "qscale")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work-dir", default=tmp)
    ap.add_argument("--betas", default="0,0.5,1,2,4")
    ap.add_argument("--eval-users", type=int, default=2000)
    ap.add_argument("--users", type=int, default=40000)
    ap.add_argument("--items", type=int, default=62423)
    ap.add_argument("--out", default=os.path.join(tmp, "blend_sweep.json"))
    ap.add_argument("--cfg", action="append", default=[])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def run(args) -> list:
    """One ``evaluate`` a β, each through a new orchestrator over the
    work-dir → the rows (also written to ``--out``)."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides

    rows = []
    for beta in [float(b) for b in args.betas.split(",")]:
        cfg = apply_overrides(Settings(
            SEED=0, HOST_TABLE=True,
            SYNTH_USERS=args.users, SYNTH_ITEMS=args.items,
            RANKER_BLEND_RETRIEVAL=beta,
        ), args.cfg)
        orch = PipelineOrchestrator(
            cfg=cfg, data_dir=f"{args.work_dir}/ml",
            models_dir=f"{args.work_dir}/models",
            features_dir=f"{args.work_dir}/features",
            synthetic=False, eval_users=args.eval_users, device=args.device,
        )
        rep = orch.run_stage("evaluate")
        row = {
            "beta": beta,
            "full_ndcg@10": rep.get("ndcg@10"),
            "full_recall@20": rep.get("recall@20"),
            "full_mrr": rep.get("mrr"),
            "retrieval_only_ndcg@10": rep.get("retrieval_only_ndcg@10"),
            "retrieval_only_recall@20": rep.get("retrieval_only_recall@20"),
            "paired_diff": rep.get("paired_ndcg10_full_minus_retrieval"),
            "paired_t": rep.get("paired_ndcg10_t"),
            "n_eval_users": rep.get("n_users"),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2, default=float)
    return rows


def main(argv=None) -> int:
    from recommendit_tpu_torch.utils.logging import setup_logging

    setup_logging("WARNING")
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
