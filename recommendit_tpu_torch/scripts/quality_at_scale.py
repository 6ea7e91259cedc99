"""Two-stage quality ladder at ML-25M-shaped scale — torch port of
``scripts/quality_at_scale.py``.

Generates an ml25m-shaped synthetic dataset (162,541 users x 62,423
items), trains the towers through the host-table trainer
(``HOST_TABLE=True``, prefetch 2), builds the index from the streamed
catalog, trains the candidates-mode ranker (``RANKER_MAX_QUERIES=8000``)
and runs the temporal-protocol evaluation, in JAX's stage order and with
JAX's flags and report keys. Then the sharded retrieval check: the index's
real rows (``n_total`` rows, ``embedding_dim`` + bias columns) row-sharded
over ``--nproc`` ranks (``parallel/launch.spawn``: NCCL, one card a rank,
or gloo with ``--device cpu``), both merges called in JAX's form
``fn(q, shard, k, mesh, 4096)`` against a single-device exact top-k
that scores the corpus in shard-shaped blocks (:func:`shard_blocked_topk`,
C.60), with JAX's two assertions on the host-canonicalised lists and 5
timed calls of each merge.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.quality_at_scale --ratings 4000000 \\
      --epochs 10 --work-dir /tmp/qscale [--users 162541] [--items 62423] \\
      [--cfg LOSS_MODE=in_batch] [--nproc N]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

QUERIES = 256           # the sharded check's batch
TIMED_CALLS = 5
BLOCK = 4096            # the block JAX's script passes to every search
CPU_RANKS = 4           # gloo ranks of the sharded check with --device cpu


def apply_overrides(cfg, pairs):
    """``--cfg KEY=VALUE`` overrides as JAX's scripts apply them: a bool
    field is true for "1"/"true", a tuple takes comma-separated values of
    its first element's type (as JAX's ``tower_sweep``; its other drivers
    split the string into characters, which no tuple field accepts), any
    other field takes its type."""
    overrides = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            overrides[k] = v.lower() in ("1", "true")
        elif isinstance(cur, tuple):
            overrides[k] = tuple(type(cur[0])(x) for x in v.split(","))
        else:
            overrides[k] = type(cur)(v)
    return cfg.replace(**overrides) if overrides else cfg


def _canon(vv: np.ndarray, ii: np.ndarray):
    """Host-side (value desc, index asc) order: the timed calls keep
    ``canonical=False``, as JAX's script does."""
    order = np.lexsort((ii, -vv), axis=-1)
    return (np.take_along_axis(vv, order, axis=-1),
            np.take_along_axis(ii, order, axis=-1))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shard_blocked_topk(q: torch.Tensor, embs: torch.Tensor, k: int, nproc: int):
    """The single-device reference of the sharded check (C.60): the
    corpus scored in column blocks of exactly one shard's rows — each a
    fresh contiguous copy, as ``Sharding.shard`` makes it, scored by
    ``exact_scores``, the very products a rank's ``mips_topk`` takes over
    its shard — then one exact top-k over all the scores. A product's f32
    rounding may change with its shape (and on the CPU with the thread
    count), so only these blocks make the merges' values bit-equal to it
    on any host."""
    from recommendit_tpu_torch.ops.topk import exact_scores, fast_topk

    rows = embs.shape[0] // nproc
    scores = torch.cat([exact_scores(q, embs[r * rows:(r + 1) * rows].clone())
                        for r in range(nproc)], dim=1)
    return fast_topk(scores, k)


def sharded_rank(q: np.ndarray, embs: np.ndarray, k: int) -> dict:
    """One rank of the sharded check: this rank's rows of ``embs`` on a
    (1, world) mesh, both merges in JAX's call form, then ``TIMED_CALLS``
    calls of each → {merge: (values, ids, seconds a call)}; rank 0 adds
    ``reference``, :func:`shard_blocked_topk` on its own device and under
    the ranks' thread count."""
    from recommendit_tpu_torch.parallel import (
        create_mesh,
        row_sharded,
        sharded_mips_topk,
        sharded_mips_topk_ring,
    )
    from recommendit_tpu_torch.parallel.mesh import mesh_device

    import torch.distributed as dist

    mesh = create_mesh(shape=(1, dist.get_world_size()))
    dev = mesh_device(mesh)
    qd = torch.as_tensor(q, device=dev)
    shard = row_sharded(mesh).shard(torch.from_numpy(embs))
    out = {}
    for name, fn in (("allgather", sharded_mips_topk),
                     ("ring", sharded_mips_topk_ring)):
        v, i = fn(qd, shard, k, mesh, BLOCK)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        fn(qd, shard, k, mesh, BLOCK)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            fn(qd, shard, k, mesh, BLOCK)
        _sync(dev)
        out[name] = (v, i, (time.perf_counter() - t0) / TIMED_CALLS)
    if dist.get_rank() == 0:
        rv, ri = shard_blocked_topk(qd, torch.as_tensor(embs, device=dev), k,
                                    dist.get_world_size())
        out["reference"] = (rv.cpu().numpy(), ri.cpu().numpy())
    return out


def sharded_check(index, nproc: int, device) -> dict:
    """The sharded retrieval block of the report (JAX's keys), over the
    index's real rows padded to a multiple of ``nproc`` with JAX's rule:
    zero rows with a -1e9 bias, a bias column appended where the index has
    none."""
    from recommendit_tpu_torch.parallel.launch import spawn

    n = index.n_total
    dcol = index.embedding_dim + int(index.has_bias)
    embs = index._embs[:n, :dcol].float().cpu().numpy()
    pad = (-n) % nproc
    if pad:
        pad_rows = np.zeros((pad, dcol), np.float32)
        pad_rows[:, -1] = -1e9 if index.has_bias else 0.0
        if not index.has_bias:
            embs = np.concatenate([embs, np.zeros((n, 1), np.float32)], axis=1)
            pad_rows = np.zeros((pad, dcol + 1), np.float32)
            pad_rows[:, -1] = -1e9
        embs = np.concatenate([embs, pad_rows], axis=0)

    rng = np.random.default_rng(1)
    batch, k = QUERIES, min(500, n // 2)
    q = rng.normal(size=(batch, embs.shape[1] - 1)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q = np.concatenate([q, np.ones((batch, 1), np.float32)], axis=1)

    dev = torch.device(device)
    ranks = spawn(sharded_rank, nproc, (q, embs, k), device=dev.type)
    rv, ri = _canon(*ranks[0]["reference"])

    timings = {}
    for name in ("allgather", "ring"):
        for r in ranks:
            v, i, _ = r[name]
            cv, ci = _canon(v, i)
            # canonical order makes the paths element-identical except where
            # distinct items tie exactly at the k-th f32 score: there the
            # sets may differ, but the values must not
            mism = ci != ri
            vals_equal = cv == rv
            assert bool(vals_equal[mism].all()) if mism.any() else True, \
                f"sharded {name} index mismatch at non-tied scores"
            assert bool(vals_equal.all()), \
                f"sharded {name} values diverged from single-device"
        v, i, dt = ranks[0][name]
        mism = _canon(v, i)[1] != ri
        timings[name] = {
            "qps": round(batch / dt, 1), "batch_ms": round(dt * 1000, 2),
            "identical_to_single_device": bool(not mism.any()),
            "index_mismatches_at_tied_scores": int(mism.sum()),
        }
    return {"n_devices": nproc, "corpus": int(embs.shape[0]), "k": k,
            "platform": dev.type, **timings}


def run(args) -> dict:
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.data.movielens import save_movielens, verify_dataset
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
    from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator

    cfg = Settings(
        SEED=args.seed,
        HOST_TABLE=True,
        HOST_TABLE_PREFETCH=2,
        TRAIN_EPOCHS=args.epochs,
        EMBEDDING_DIM=args.embedding_dim,
        SYNTH_USERS=args.users, SYNTH_ITEMS=args.items,
        SYNTH_RATINGS=args.ratings,
        # candidate-mode ranker: cap queries so the feature frame stays
        # bounded; the inner towers inherit TRAIN_EPOCHS
        RANKER_MAX_QUERIES=8000,
    )
    cfg = apply_overrides(cfg, args.cfg)
    data_dir = f"{args.work_dir}/ml"
    t_gen = time.time()
    if not verify_dataset(Path(data_dir)):
        data = make_synthetic_movielens(
            n_users=args.users, n_items=args.items, n_ratings=args.ratings,
            seed=args.seed)
        save_movielens(data, data_dir)
    t_gen = time.time() - t_gen

    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=data_dir, models_dir=f"{args.work_dir}/models",
        features_dir=f"{args.work_dir}/features", synthetic=False,
        eval_users=args.eval_users, device=args.device)
    orch.run_stage("features")
    hist = orch.run_stage("embeddings")
    train_ex_s = float(np.mean([h["examples_per_s"] for h in hist])) \
        if hist else 0.0
    orch.run_stage("index")
    orch.run_stage("ranker")
    rep = orch.run_stage("evaluate")

    report = {
        "config": {
            "users": args.users, "items": args.items,
            "ratings": args.ratings, "epochs": args.epochs,
            "eval_users": args.eval_users, "dim": args.embedding_dim,
            "host_table": True, "gen_seconds": round(t_gen, 1),
        },
        "ladder": {
            "popularity_ndcg@10": rep.get("popularity_ndcg@10"),
            "retrieval_only_ndcg@10": rep.get("retrieval_only_ndcg@10"),
            "full_ndcg@10": rep.get("ndcg@10"),
            "popularity_recall@20": rep.get("popularity_recall@20"),
            "retrieval_only_recall@20": rep.get("retrieval_only_recall@20"),
            "full_recall@20": rep.get("recall@20"),
            "mrr": rep.get("mrr"),
        },
        "host_table_train_examples_per_s": round(train_ex_s, 1),
        "stage_seconds": {k: round(v, 1) for k, v in orch.stage_times.items()},
    }

    from recommendit_tpu_torch.models.retrieval import MIPSIndex

    index = MIPSIndex.load(orch.cfg.INDEX_PATH, device=orch.device)
    nproc = args.nproc or (torch.cuda.device_count()
                           if orch.device.type == "cuda" else CPU_RANKS)
    report["sharded_retrieval"] = sharded_check(index, nproc, orch.device)
    del index
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, default=float)
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--users", type=int, default=162_541)   # ml25m rows
    ap.add_argument("--items", type=int, default=62_423)
    ap.add_argument("--ratings", type=int, default=4_000_000)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--eval-users", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--embedding-dim", type=int, default=64)
    ap.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(), "qscale"))
    ap.add_argument("--out", default=None,
                    help="report file (default: <work-dir>/report.json)")
    ap.add_argument("--cfg", action="append",
                    help="Settings override KEY=VALUE (repeatable)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks of the sharded check (default: one a card; "
                         f"{CPU_RANKS} gloo ranks with --device cpu)")
    args = ap.parse_args(argv)
    args.out = args.out or f"{args.work_dir}/report.json"
    return args


def main(argv=None) -> int:
    from recommendit_tpu_torch.utils.logging import setup_logging

    setup_logging("INFO")
    report = run(parse_args(argv))
    print(json.dumps(report, indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
