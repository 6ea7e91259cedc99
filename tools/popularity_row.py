"""The evaluate stage's popularity row at ``seed_variance``'s defaults
(1,500 users x 1,200 items x 150,000 synthetic ratings, the first 150
evaluation users), with no training: the port's ``data`` stage writes the
synthetic set, then the row is computed as ``run_evaluate`` computes it
(the temporal 90/10 split, relevance = rating >= 4, each user's train-time
items filtered from the popularity order). It prints digests of the data
and of the split's row order beside the row, so two hosts can be told
apart by their data or by their sort. Host code only. A measurement tool,
outside the package; ``tests/test_torch_seed_variance.py`` holds
:func:`popularity_row` to the JAX package's evaluate code.

    python3 tools/popularity_row.py [--work-dir DIR] [--seed 0] [--eval-users 150]

Prints one JSON line.
"""
import argparse
import hashlib
import json
import sys
import tempfile
from itertools import islice
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def popularity_row(data_dir: str, seed: int = 0, eval_users: int = 150) -> dict:
    """The popularity row of the port's evaluate stage over the synthetic
    set the ``data`` stage writes to ``data_dir``, with the digests."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.data.movielens import timestamp_order
    from recommendit_tpu_torch.evaluation.metrics import evaluate_model
    from recommendit_tpu_torch.pipelines.run_pipeline import (
        EVAL_SPLIT,
        PipelineOrchestrator,
        _group_items,
    )
    from recommendit_tpu_torch.serving.recommender import popularity_order

    root = Path(data_dir)
    orch = PipelineOrchestrator(cfg=Settings(SEED=seed), data_dir=str(root / "ml"),
                                models_dir=str(root / "models"),
                                features_dir=str(root / "features"), synthetic=True,
                                eval_users=eval_users, device="cpu")
    orch.run_stage("data")
    data = orch._load_data()
    order = timestamp_order(data.timestamp)
    cut = int(len(order) * EVAL_SPLIT)
    train_rows, test_rows = order[:cut], order[cut:]
    test_rows = test_rows[data.rating[test_rows] >= 4]
    truth = {u: items.tolist() for u, items in _group_items(
        data.user_id[test_rows], data.item_id[test_rows]).items()}
    users = list(truth.keys())[:eval_users]
    seen = {u: set(items.tolist()) for u, items in _group_items(
        data.user_id[train_rows], data.item_id[train_rows]).items()}
    pop_all = popularity_order(data.item_id[train_rows]).tolist()
    recs = {u: list(islice((i for i in pop_all if i not in seen.get(u, ())), 20))
            for u in users}
    rep = evaluate_model(recs, truth, k_values=[10, 20])
    return {"popularity_ndcg@10": rep["ndcg@10"],
            "popularity_recall@20": rep["recall@20"], "popularity_mrr": rep["mrr"],
            "n_users": len(users), "numpy": np.__version__,
            "data_sha256": _digest(data.user_id, data.item_id, data.rating,
                                   data.timestamp),
            "order_sha256": _digest(order)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-users", type=int, default=150)
    args = ap.parse_args(argv)
    work = args.work_dir or tempfile.mkdtemp(prefix="popularity_row_")
    print(json.dumps(popularity_row(work, args.seed, args.eval_users)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
