"""Realized two-tower training throughput over whole epochs — torch port of
``scripts/train_scope_bench.py``.

Measures what the embedding trainer delivers end to end per epoch (host
batch sampling, the device step, the loss read back), not the bare kernel
step, at ML-1M shape (6,040 x 3,952 x 1M synthetic ratings, data seed 0):
examples/s of the first epoch (first-call costs included), the mean and
the best of the later ones, and the seconds of the whole run. It keeps
JAX's positional ``scope epochs``; the port's trainer has one scope (an
eager step a batch; ``TRAIN_JIT_SCOPE`` is read and ignored), so the line
also says ``"scope_applies": false``.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.train_scope_bench chunk 5 \\
      [--cfg LOSS_MODE=in_batch]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

ML1M = dict(n_users=6040, n_items=3952, n_ratings=1_000_000)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scope", nargs="?", default="chunk")
    ap.add_argument("epochs", nargs="?", type=int, default=5)
    ap.add_argument("--cfg", action="append", default=[],
                    help="Settings override KEY=VALUE (repeatable)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def run(scope: str = "chunk", epochs: int = 5, cfg=(), device=DEFAULT_DEVICE,
        n_users: int = ML1M["n_users"], n_items: int = ML1M["n_items"],
        n_ratings: int = ML1M["n_ratings"], seed: int = 0) -> dict:
    """Train ``epochs`` epochs on the synthetic set of these sizes → JAX's
    line (plus ``scope_applies`` and the trainer's ``history``)."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
    from recommendit_tpu_torch.scripts.quality_at_scale import apply_overrides
    from recommendit_tpu_torch.training.train_embeddings import EmbeddingTrainer
    from recommendit_tpu_torch.utils.device import resolve_device

    print("platform:", resolve_device(device).type, flush=True)
    data = make_synthetic_movielens(n_users=n_users, n_items=n_items,
                                    n_ratings=n_ratings, seed=seed)
    settings = apply_overrides(Settings(TRAIN_JIT_SCOPE=scope, TRAIN_EPOCHS=epochs,
                                        EMBEDDING_MODEL_PATH=""), list(cfg))
    tr = EmbeddingTrainer(data, cfg=settings, model_output_path="", device=device)
    t0 = time.time()
    tr.train(epochs=epochs)
    steady = [h["examples_per_s"] for h in tr.history[1:]]
    line = {
        "scope": scope,
        "epochs": epochs,
        "ex_s_epoch1_incl_compile": round(tr.history[0]["examples_per_s"]),
        "ex_s_steady_mean": round(float(np.mean(steady))),
        "ex_s_steady_max": round(float(np.max(steady))),
        "total_s": round(time.time() - t0, 1),
        "scope_applies": False,
    }
    print(json.dumps(line), flush=True)
    return {**line, "history": tr.history}


def main(argv=None) -> int:
    args = parse_args(argv)
    run(args.scope, args.epochs, args.cfg, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
