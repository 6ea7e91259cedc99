"""Real-data parity run — torch port of ``scripts/real_data.py``, its
golden-fixture branch.

Runs the whole real-data path: parse → ``features`` → ``embeddings`` →
``index`` → ``ranker`` → the temporal ``evaluate`` → a report beside the
reference's published MovieLens-1M ladder (``REFERENCE_TARGETS``). The
port downloads nothing: when ``--data-dir`` holds no complete ML-1M set
(``ratings.dat``, ``users.dat``, ``movies.dat``, ``README``) the run falls
back to the golden ML-1M-format fixture (``tests/fixtures/ml1m_golden``:
real file quirks — latin-1 titles, non-contiguous ids, ZIP+4 codes), with
JAX's shrunk settings, so every byte of the real-data path still runs;
the report is then marked ``"mode": "golden-fixture"`` and its quality
rows are not comparable. Place the real files in ``--data-dir`` by hand
for the ``"real"`` mode.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.real_data [--data-dir DIR] \\
      [--epochs 10] [--cfg LOSS_MODE=in_batch] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

# the reference ladder, README.md:34-38 (popularity / retrieval-only / full)
REFERENCE_TARGETS = {
    "ndcg@10": [0.041, 0.089, 0.143],
    "recall@20": [0.089, 0.201, 0.312],
    "mrr": [0.052, 0.112, 0.178],
}

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "ml1m_golden"
DAT_FILES = ("ratings.dat", "users.dat", "movies.dat", "README")
STAGES = ("features", "embeddings", "index", "ranker")
NO_DOWNLOAD = ("none: the port has no download path; place the ML-1M files "
               "in --data-dir by hand")


def parse_args(argv=None):
    tmp = os.path.join(tempfile.gettempdir(), "real_data")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=f"{tmp}/ml-1m")
    ap.add_argument("--models-dir", default=f"{tmp}/models")
    ap.add_argument("--features-dir", default=f"{tmp}/features-real")
    ap.add_argument("--eval-users", type=int, default=2000)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--out", default=f"{tmp}/REALDATA.json")
    ap.add_argument("--cfg", action="append", default=[])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def run(args) -> dict:
    """→ the report, also written to ``--out``."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.data.movielens import verify_dataset
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides

    data_dir = Path(args.data_dir)
    mode = "real"
    if verify_dataset(data_dir):
        print(f"dataset present at {data_dir}")
    else:
        print(f"no ML-1M set at {data_dir} and no download in the port; "
              f"falling back to the golden ml-1m-format fixture at {GOLDEN}")
        mode = "golden-fixture"
        data_dir.mkdir(parents=True, exist_ok=True)
        for f in DAT_FILES:
            shutil.copy(GOLDEN / f, data_dir / f)
    assert verify_dataset(data_dir), "dataset incomplete after setup"

    cfg = Settings(TRAIN_EPOCHS=args.epochs)
    if mode == "golden-fixture":
        # the fixture is 30 users x 21 movies — shrink knobs so every stage
        # still runs (the candidates-mode ranker falls back to pairs there)
        cfg = cfg.replace(TRAIN_EPOCHS=2, TOP_K_CANDIDATES=10,
                          RANKER_EPOCHS=4, RANKER_LABEL_FRACTION=0.3,
                          RANKER_CAND_FOLDS=1)
    cfg = apply_overrides(cfg, args.cfg)

    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=str(data_dir), models_dir=args.models_dir,
        features_dir=args.features_dir, synthetic=False,
        eval_users=args.eval_users, device=args.device,
    )
    for stage in STAGES:
        orch.run_stage(stage)
    rep = orch.run_stage("evaluate")

    ladder = {
        "popularity": [rep.get("popularity_ndcg@10"),
                       rep.get("popularity_recall@20"),
                       rep.get("popularity_mrr")],
        "retrieval_only": [rep.get("retrieval_only_ndcg@10"),
                           rep.get("retrieval_only_recall@20"),
                           rep.get("retrieval_only_mrr")],
        "full": [rep.get("ndcg@10"), rep.get("recall@20"), rep.get("mrr")],
    }
    report = {
        "mode": mode,
        "comparable_to_reference": mode == "real",
        "reference_targets_ndcg10_recall20_mrr": REFERENCE_TARGETS,
        "measured_ladder_ndcg10_recall20_mrr": {
            k: [None if v is None else round(float(v), 4) for v in vals]
            for k, vals in ladder.items()
        },
        "eval_users": rep.get("n_users"),
        "stage_seconds": {k: round(v, 1)
                          for k, v in orch.stage_times.items()},
        "blocked_syscall": None if mode == "real" else NO_DOWNLOAD,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    from recommendit_tpu_torch.utils.logging import setup_logging

    setup_logging("INFO")
    report = run(parse_args(argv))
    print(json.dumps(report, indent=2))
    if report["mode"] == "golden-fixture":
        print("NOTE: golden-fixture mode — quality rows are NOT comparable "
              "to the reference ladder; place the real ML-1M files in "
              "--data-dir for the real parity report.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
