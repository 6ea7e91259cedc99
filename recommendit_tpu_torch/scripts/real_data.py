"""Real-data parity run — torch port of ``scripts/real_data.py``.

Runs the whole real-data path: download → parse → ``features`` →
``embeddings`` → ``index`` → ``ranker`` → the temporal ``evaluate`` → a
report beside the reference's published MovieLens-1M ladder
(``REFERENCE_TARGETS``). When ``--data-dir`` holds no complete ML-1M set
(``ratings.dat``, ``users.dat``, ``movies.dat``, ``README``) the run
downloads it into that directory's parent
(``data/movielens.download_movielens``, from ``MOVIELENS_1M_URL``); where
the download fails (``RuntimeError``: no network, or a URL that answers
nothing) it falls back to the golden ML-1M-format fixture
(``tests/fixtures/ml1m_golden``: real file quirks — latin-1 titles,
non-contiguous ids, ZIP+4 codes), with JAX's shrunk settings, so every
byte of the real-data path still runs; the report is then marked
``"mode": "golden-fixture"``, its quality rows are not comparable, and
``blocked_syscall`` holds the download's error.

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
    from recommendit_tpu_torch.data.movielens import download_movielens, verify_dataset
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides

    data_dir = Path(args.data_dir)
    mode, blocked = "real", None
    if verify_dataset(data_dir):
        print(f"dataset present at {data_dir}")
    else:
        try:
            download_movielens(str(data_dir.parent))
        except RuntimeError as exc:
            print(f"download blocked ({exc}); falling back to the golden "
                  f"ml-1m-format fixture at {GOLDEN}")
            mode, blocked = "golden-fixture", f"download_movielens: {exc}"
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
        "blocked_syscall": blocked,
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
              "to the reference ladder; re-run with network access, or place "
              "the real ML-1M files in --data-dir, for the real parity report.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
