"""The feature snapshot's two readers side by side on the host: the numpy
reader and the C++ reader (``native/feature_snapshot.cpp``, built with
``g++`` at first use), behind ``FeatureStore`` as ``RecommendationPipeline``
attaches the snapshot. A snapshot of random rows at the ml25m catalog's
counts (162,541 users x 24 columns, 62,423 items x 23) is written under
``--work-dir``; then, in the order numpy, native, native, numpy: the time
to open the snapshot, one user's features (``get_user_features``, a miss
in the store's KV layer that falls through to the snapshot) over
``--reads`` random users, and one 500-item batch
(``get_item_features_batch``, the candidates of one request). The first
native open, which builds the library where it is not built yet, is
timed on its own. Host code only; no device. A measurement tool, outside
the package: nothing imports it.

    python3 tools/snapshot_reader_ab.py [--work-dir DIR] [--reads 20000]

Prints one JSON line per reader run and a summary line.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_USERS, N_ITEMS, BATCH = 162_541, 62_423, 500


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--reads", type=int, default=20_000)
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from recommendit_tpu_torch.features import schema
    from recommendit_tpu_torch.features.snapshot import FeatureSnapshot, write_snapshot
    from recommendit_tpu_torch.features.store import FeatureStore

    work = Path(args.work_dir or tempfile.mkdtemp(prefix="snapshot_ab_"))
    rng = np.random.default_rng(args.seed)
    user_cols = schema.USER_SCALAR_COLS + ["genre_pref"] * schema.N_GENRES
    item_cols = schema.ITEM_SCALAR_COLS + ["genre_vector"] * schema.N_GENRES
    path = work / "features.fsnap"
    write_snapshot(str(path), np.arange(1, N_USERS + 1),
                   rng.random((N_USERS, len(user_cols)), dtype=np.float32),
                   np.arange(1, N_ITEMS + 1),
                   rng.random((N_ITEMS, len(item_cols)), dtype=np.float32),
                   user_cols, item_cols)
    users = rng.integers(1, N_USERS + 1, args.reads).tolist()
    batches = [rng.integers(1, N_ITEMS + 1, BATCH).tolist() for _ in range(args.batches)]

    t0 = time.perf_counter()
    first = FeatureSnapshot(str(path))
    first_native_open_s = time.perf_counter() - t0
    native = first.native
    first.close()

    rows, lists = [], {}
    for prefer in (False, True, True, False):
        t0 = time.perf_counter()
        snap = FeatureSnapshot(str(path), prefer_native=prefer)
        open_ms = (time.perf_counter() - t0) * 1e3
        store = FeatureStore()
        store.attach_snapshot(snap)
        t0 = time.perf_counter()
        got_users = [store.get_user_features(u) for u in users]
        user_us = (time.perf_counter() - t0) / len(users) * 1e6
        t0 = time.perf_counter()
        got_items = [store.get_item_features_batch(b) for b in batches]
        batch_ms = (time.perf_counter() - t0) / len(batches) * 1e3
        name = "native" if snap.native else "numpy"
        lists.setdefault(name, (got_users, got_items))
        snap.close()
        row = {"reader": name, "open_ms": open_ms, "user_features_us": user_us,
               "item_batch_ms": batch_ms, "reads": len(users), "batch": BATCH}
        rows.append(row)
        print(json.dumps(row), flush=True)
    same = len(lists) == 1 or lists["native"] == lists["numpy"]
    summary = {"native_built": native, "first_native_open_s": first_native_open_s,
               "same_features": same}
    for name in ("numpy", "native"):
        mine = [r for r in rows if r["reader"] == name]
        if mine:
            summary[name] = {k: min(r[k] for r in mine)
                             for k in ("open_ms", "user_features_us", "item_batch_ms")}
    print(json.dumps({"snapshot_reader_ab": summary}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
