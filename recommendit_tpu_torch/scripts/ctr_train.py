"""Criteo-style CTR training script (BASELINE config #5) — the counterpart of
``scripts/ctr_train.py``.

Generates a seeded synthetic Criteo-shaped impression log, trains the
DLRM-style CTR model — by default jointly with the retrieval towers that
share its stacked embedding table (end-to-end two-stage) — and prints one
JSON line with the JAX script's keys: AUC, logloss, CTR, retrieval
Recall@10/50 (joint), examples/s and ``joint``.

    python -m recommendit_tpu_torch.scripts.ctr_train [--examples N]
        [--epochs E] [--no-joint] [--users U] [--items I] [--save PATH]

Runs on the card (without one it fails; ``--device cpu`` runs here).
``make ctr``'s configuration is the default: 500,000 impressions over
20,000 users x 5,000 items, 5 epochs, batch 4,096.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from recommendit_tpu_torch.config import settings

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--examples", type=int, default=500_000)
    ap.add_argument("--users", type=int, default=20_000)
    ap.add_argument("--items", type=int, default=5_000)
    ap.add_argument("--epochs", type=int, default=settings.CTR_EPOCHS)
    ap.add_argument("--batch-size", type=int, default=settings.CTR_BATCH_SIZE)
    ap.add_argument("--no-joint", action="store_true",
                    help="plain CTR (no retrieval towers / softmax term)")
    ap.add_argument("--seed", type=int, default=settings.SEED)
    ap.add_argument("--save", type=str, default=None,
                    help="checkpoint path (npz) for the trained model")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs here)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, data=None):
    """Train and evaluate as ``args`` say (on ``data`` when given, else a
    fresh log from ``args.seed``); returns (report, trainer)."""
    from recommendit_tpu_torch.config import settings
    from recommendit_tpu_torch.data.ctr import make_ctr_dataset
    from recommendit_tpu_torch.training.train_ctr import CTRTrainer

    log = logging.getLogger("ctr_train")
    if data is None:
        log.info("Generating %d impressions (%d users x %d items)...",
                 args.examples, args.users, args.items)
        data = make_ctr_dataset(n_examples=args.examples, n_users=args.users,
                                n_items=args.items, seed=args.seed)
    cfg = settings.replace(CTR_EPOCHS=args.epochs, CTR_BATCH_SIZE=args.batch_size,
                           SEED=args.seed)
    trainer = CTRTrainer(data, cfg=cfg, joint=not args.no_joint,
                         model_output_path=args.save, device=args.device)
    trainer.train()
    report = trainer.evaluate()
    report["examples_per_s"] = round(trainer.examples_per_s)
    report["joint"] = not args.no_joint
    return report, trainer


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    report, _ = run(args)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
