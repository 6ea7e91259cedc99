#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Drives two paths of the port. First the fused two-stage serve path, at the
repository's large serve configuration (``bench.py::bench_serve_e2e_large``): 6,040
users, a 1,000,000-item catalog, two towers of width 128, a bf16 fused
index with the item-bias column, the MLP LambdaRank ranker (128, 64) over
52 features with query norm and blend 1, top-500 candidates, top-100
output, the seen filter. Weights and data are random, made from ``--seed``
and written in the JAX package's file formats.

Then the same serve path with the index stored in int8 (``INDEX_DTYPE=int8``,
the int8 window kernel for batches of 1,024 users), and the int8 capacity
shape of ``scripts/capacity_30m.py``: 30,000,000 random unit rows x 128,
window 512, k=500, Q=1024.

Then, over the same saved bf16 corpus, the three kernels no serve or train
path runs: the queries-major window kernel (``mips_topk_window``), the fold
kernel (``mips_topk_fused``) and the row gather (``gather_rows``) over the
serve's packed item table; then the kernel probe
(``recommendit_tpu_torch.scripts.kernel_probe``, the counterpart of
``scripts/pallas_probe.py``) in its four variants at 1M x 128, the path
that drives the queries-major window and fold kernels.

Then two-tower training, at the repository's BPR training configuration
(``bench.py::bench_bpr_train``, ML-1M shape): 6,040 users, 3,952 items,
towers 64/128, batch 1,024, dropout 0.2, AdamW under a cosine schedule with
global-norm clipping at 1.0, ``LOSS_MODE=in_batch``, on synthetic ML-1M
data (1,000,209 ratings requested) made from ``--seed``.

Phases (each failure raises, so the exit code is not 0):

1. build the CUDA kernels from ``recommendit_tpu_torch/csrc`` (one nvcc per
   source, all started together);
2. write the artifacts, embed the catalog with the port's item tower and
   build + save the fused bf16 index and, from the same embeddings and
   bias, the fused int8 index (quant seed ``--seed``);
3. kernel phase: at Q in {256, 1024} over the 1M x 129 (136 padded) bf16
   corpus, W=64, k=500, the kernel against its plain twin — window maxima
   within 1e-3, top-500 id overlap >= 0.99, recall@500 >= 0.98 against the
   exact top-500 of the same scores — and both times (CUDA events);
4. serve phase: ``batch_recommend`` for 2,048 users at batch 1,024 (the
   kernel route: one launch per batch) and 20 single requests (the scan
   route: none), with the launch counts read around exactly that run;
5. quantize phase: at 1M x 129, the catalog's augmented f32 rows, the
   quantize kernel against its twin (int8 values and scales equal), and
   the times of both and of the build quantizer (threefry);
6. int8 kernel phase: at Q in {256, 1024} over the saved 1M x 129 (144
   padded) int8 corpus, W=64, k=500, the int8 window kernel against its
   twin — window maxima and positions equal, top-500 ids equal — recall@500
   >= 0.98 against the exact top-500 of the same int8 scores and >= 0.95
   against the exact top-500 of the unquantised f32 rows, and both times;
7. int8 serve phase: the serve phase over the int8 index, with exactly one
   int8 window launch per batch and none of the bf16 kernel;
8. queries-major window phase: at Q in {256, 1024} over the saved bf16
   corpus, W=64, the queries-major kernel against its twin (maxima within
   1e-3, top-500 id overlap >= 0.99) and against the items-major kernel
   (maxima and positions equal to its transpose); then Q=1024 at W=128, its
   default, timed with its twin;
9. fold phase: ``mips_topk_fused`` at Q=1024 over the valid rows, block
   2048, R=64: candidates within 1e-4 (relative to the largest) of the
   twin, recall@500 >= 0.98 against the exact top-500 of the same f32-query
   scores; integer-valued inputs full of ties (f32 and bf16, bins narrower
   and wider than a tile, a bias pad) equal to the twin; both times;
10. gather phase: ``gather_rows`` of a (1024, 500) int64 index into the
   packed item table (1,000,001 x 64 f32) — the counted run — equal to the
   twin, and with out-of-range and int32 indices, a 23-wide f32 and a bf16
   table; the times of the kernel, the twin and ``torch.index_select``;
11. probe phase: the kernel probe's four variants in-process at N=1M,
   D=128, Q=1024, k=500, block 2048, W=64, bf16, each exiting 0, with the
   window and fold launch counts read around exactly that run;
12. capacity phase: 30M x 128 random unit rows made and quantised on the
   card in chunks, the int8 window kernel at Q=1024 and W=512 (windows
   wider than a tile) timed, and on 64 queries its maxima and positions
   equal to the twin's and recall@500 >= 0.98 against int8-exact;
13. BPR kernel phase: at B=1024 and a ragged B=1000, D=64 f32, the forward
   and backward kernels against their twins — the loss within 1e-5
   relative, du and dv within 1e-4 of the twin's largest entry — and all
   four times (CUDA events);
14. train phase: the synthetic data, its 0.9 temporal train view, 2 epochs
   of in-batch BPR (the loss finite, falling, below ln 2; one forward and
   one backward kernel launch per step, counted around exactly that run),
   then 1 epoch of the default softmax loss (no BPR launch);
15. index phase: ``IndexBuilder`` on the in-batch model (exact f32 index),
   ``batch_search`` for 1,024 users with held-out positives: valid ids,
   and Recall@20 of the held-out 10 % positives (train items filtered)
   above a random ranking's.

Usage, from the repository root: ``python3 chip_smoke.py [--seed N]``.
Prints the card's name and power limit, a ``{"kernels": [...]}`` line (each
kernel's launches on its path, error against its twin, time, twin's time,
bound and, where one PyTorch call computes the same function, that call's
time) and, last, ``{"ok": true, "device": {...}}``. Exits non-zero without a
GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

N_USERS, N_ITEMS, DIM, HIDDEN = 6040, 1_000_000, 128, 128
N_RATINGS = 1_000_209            # the ML-1M rating count
RANKER_HIDDEN = (128, 64)
TOP_K_CANDIDATES = 500
INDEX_BLOCK = 4096
WINDOW = 64
KERNEL_QS = (256, 1024)
BATCH = 1024
N_BATCH_USERS = 2048
N_REQUESTS = 20
REQUEST_K = 20

KERNEL_SOURCE = "recommendit_tpu_torch/csrc/window_mips.cu"
KERNEL_REPLACES = "recommendit_tpu/ops/pallas_mips.py:359"
BPR_SOURCE = "recommendit_tpu_torch/csrc/bpr.cu"
BPR_REPLACES = {"bpr_fwd": "recommendit_tpu/ops/bpr.py:53",
                "bpr_bwd": "recommendit_tpu/ops/bpr.py:123"}
I8_SOURCE = "recommendit_tpu_torch/csrc/window_mips_i8.cu"
I8_REPLACES = "recommendit_tpu/ops/pallas_mips.py:470"
QUANT_SOURCE = "recommendit_tpu_torch/csrc/quantize_i8.cu"
QUANT_REPLACES = "recommendit_tpu/ops/quantize.py:60"
QM_REPLACES = "recommendit_tpu/ops/pallas_mips.py:233"
FOLD_SOURCE = "recommendit_tpu_torch/csrc/fold_mips.cu"
FOLD_REPLACES = "recommendit_tpu/ops/pallas_mips.py:57"
GATHER_SOURCE = "recommendit_tpu_torch/csrc/gather_rows.cu"
GATHER_REPLACES = "recommendit_tpu/ops/gather.py:27"
LIBRARIES = ("window_mips", "bpr", "window_mips_i8", "quantize_i8",
             "fold_mips", "gather_rows")

# the kernels no serve or train path runs
QM_WINDOW = 128                   # mips_topk_window's default window
QM_BLOCK = 16384                  # ... and block
FOLD_Q, FOLD_BLOCK, FOLD_R = 1024, 2048, 64
GATHER_SHAPE = (1024, 500)        # a batch of users x their candidates
PROBE_ARGS = ("--n", "1000000", "--d", "128", "--q", "1024", "--k", "500",
              "--block", "2048", "--window", "64", "--dtype", "bfloat16")

# the H100 SXM's published peaks (dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
INDEX_PATHS = {"bfloat16": "index_path", "int8": "index_i8_path"}
SERVE_KERNELS = {"bfloat16": "window_mips", "int8": "window_mips_i8"}

# capacity: scripts/capacity_30m.py
CAPACITY_ROWS, CAPACITY_DIM, CAPACITY_WINDOW = 30_000_000, 128, 512
CAPACITY_Q, CAPACITY_CHECK_Q = 1024, 64
CAPACITY_CHUNK = 1 << 21          # rows made and quantised at a time

# training: bench.py::bench_bpr_train at ML-1M shape
TRAIN_USERS, TRAIN_ITEMS = 6040, 3952
TRAIN_DIM, TRAIN_HIDDEN, TRAIN_BATCH, TRAIN_DROPOUT = 64, 128, 1024, 0.2
TRAIN_EPOCHS = 2
TRAIN_SPLIT = 0.9
BPR_SHAPES = ((1024, TRAIN_DIM), (1000, TRAIN_DIM))
INDEX_USERS, RECALL_K = 1024, 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _glorot(rng, shape):
    limit = float(np.sqrt(6.0 / (shape[0] + shape[-1])))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def make_artifacts(workdir: Path, seed: int, device, n_users: int = N_USERS,
                   n_items: int = N_ITEMS, dim: int = DIM,
                   hidden: int = HIDDEN, n_ratings: int = N_RATINGS,
                   block_size: int = INDEX_BLOCK):
    """Random two-tower, fused bf16 and int8 indexes, ranker, packed
    feature tables and ratings, in the JAX package's formats, and the
    catalog's augmented f32 rows (normalised embedding and bias column) as
    ``catalog.npy``. Returns (paths, ServeData)."""
    from recommendit_tpu_torch.features.schema import (
        FEATURE_COLUMNS,
        ITEM_PACKED_DIM,
        N_GENRES,
        USER_PACKED_DIM,
    )
    from recommendit_tpu_torch.models import LambdaRankScorer, MIPSIndex, TwoTower
    from recommendit_tpu_torch.serving.recommender import ServeData

    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    params = {
        "user_embed": 0.1 * rng.standard_normal((n_users + 1, dim), np.float32),
        "item_embed": 0.1 * rng.standard_normal((n_items + 1, dim), np.float32),
        "user_w1": _glorot(rng, (dim, hidden)),
        "user_b1": np.zeros(hidden, np.float32),
        "user_w2": _glorot(rng, (hidden, dim)),
        "user_b2": np.zeros(dim, np.float32),
        "item_w1": _glorot(rng, (dim + N_GENRES, hidden)),
        "item_b1": np.zeros(hidden, np.float32),
        "item_w2": _glorot(rng, (hidden, dim)),
        "item_b2": np.zeros(dim, np.float32),
        "item_bias": rng.standard_normal(n_items + 1, np.float32),
    }
    params["user_embed"][0] = 0.0
    params["item_embed"][0] = 0.0
    model = TwoTower.from_numpy(params, n_users, n_items, dim, hidden,
                                device=device)
    paths = {"model_path": str(workdir / "two_tower.npz"),
             "index_path": str(workdir / "mips.index.npz"),
             "index_i8_path": str(workdir / "mips_i8.index.npz"),
             "catalog_path": str(workdir / "catalog.npy"),
             "ranker_path": str(workdir / "ranker.npz"),
             "features_dir": str(workdir / "features")}
    model.save(paths["model_path"])

    # catalog: 1-3 genres per item
    item_ids = np.arange(1, n_items + 1)
    genres = np.zeros((n_items, N_GENRES), np.float32)
    n_gen = rng.integers(1, 4, n_items)
    for j in range(3):
        g = rng.integers(0, N_GENRES, n_items)
        genres[np.arange(n_items)[n_gen > j], g[n_gen > j]] = 1.0
    embs = model.get_item_embeddings(item_ids, genres)
    bias = 0.05 * model.item_bias_np(item_ids)
    for dtype in INDEX_PATHS:
        index = MIPSIndex(dim, block_size, "fused", dtype, quant_seed=seed,
                          device=device)
        index.build(embs, item_ids, bias=bias)
        index.save(paths[INDEX_PATHS[dtype]])
    unit = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
    np.save(paths["catalog_path"],
            np.concatenate([unit, bias[:, None]], axis=1).astype(np.float32))
    del model, index, embs, unit

    names = FEATURE_COLUMNS + ["retrieval_score", "retrieval_rank"]
    ranker = LambdaRankScorer(feature_names=names, hidden_dims=RANKER_HIDDEN,
                              query_norm=True, device=device)
    dims = [len(names), *RANKER_HIDDEN, 1]
    ranker.params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ranker.params[f"w{i}"] = torch.as_tensor(_glorot(rng, (a, b)))
        ranker.params[f"b{i}"] = torch.zeros(b)
    ranker.feat_mean = rng.standard_normal(len(names), np.float32)
    ranker.feat_std = rng.uniform(0.5, 2.0, len(names)).astype(np.float32)
    ranker.save(paths["ranker_path"])

    feats = Path(paths["features_dir"])
    feats.mkdir(parents=True, exist_ok=True)
    np.save(feats / "user_packed.npy",
            rng.standard_normal((n_users + 1, USER_PACKED_DIM), np.float32))
    np.save(feats / "item_packed.npy",
            rng.standard_normal((n_items + 1, ITEM_PACKED_DIM), np.float32))

    # ratings: half uniform over the catalog, half on a popular head
    head = max(1, n_items // 50)
    users = rng.integers(1, n_users + 1, n_ratings)
    items = np.where(rng.random(n_ratings) < 0.5,
                     rng.integers(1, n_items + 1, n_ratings),
                     rng.integers(1, head + 1, n_ratings))
    return paths, ServeData(user_id=users, item_id=items, n_users=n_users,
                            n_items=n_items)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean per-row share of ``a``'s ids that are in ``b``'s row."""
    width = int(max(a.max(), b.max())) + 1
    rows = torch.arange(a.shape[0], device=a.device)[:, None] * width
    return float(torch.isin(a + rows, b + rows).float().mean())


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(paths, device, seed: int, qs=KERNEL_QS, k=TOP_K_CANDIDATES,
                 window=WINDOW, timer=cuda_ms, min_recall=0.98):
    """The kernel against its twin on the index's own corpus and user-tower
    queries; recall@k against the exact top-k of the same scores must reach
    ``min_recall`` (the bin model gives 0.984 at the serve shape). Returns
    one record per batch size."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import fast_topk, score_matrix

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_path"], device=device)
    corpus, n_valid = index._embs, index.n_total
    rng = np.random.default_rng(seed + 1)
    out = []
    for n_q in qs:
        uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q),
                               device=device)
        q = index._augment(model.user_tower(uids))
        kv, ka = mw.window_candidates(q, corpus, window, n_valid)
        rv, ra = mw.window_candidates_ref(q, corpus, window, n_valid)
        err = float((kv - rv).abs().max())
        v, i = mw.mips_topk_window_im(q, corpus, k, INDEX_BLOCK, window,
                                      n_valid=n_valid)
        tv, ti = mw.mips_topk_window_im_ref(q, corpus, k, INDEX_BLOCK, window,
                                            n_valid=n_valid)
        _, ei = fast_topk(score_matrix(q, corpus[:n_valid], "default"), k)
        _, fi = fast_topk(score_matrix(q, corpus[:n_valid], "highest"), k)
        rec = {
            "q": n_q, "n": n_valid, "d": int(corpus.shape[1]),
            "d_func": index._width, "window": window, "k": k,
            "dtype": str(corpus.dtype), "window_max_abs_err": err,
            "topk_value_abs_err": float((v - tv).abs().max()),
            "id_overlap_vs_twin": _overlap(i, ti),
            "recall_vs_exact": _overlap(i, ei),
            "recall_vs_exact_f32_queries": _overlap(i, fi),
            "bin_model_recall": 1 - (k - 1) * window / (2 * n_valid),
            "args_equal_share": float((ka == ra).float().mean()),
        }
        del kv, ka, rv, ra, ei, fi
        reps = 20 if n_q <= 256 else 10
        rec["kernel_ms"] = timer(
            lambda: mw.window_candidates(q, corpus, window, n_valid), reps)
        rec["twin_ms"] = timer(
            lambda: mw.window_candidates_ref(q, corpus, window, n_valid), 3)
        rec["kernel_topk_ms"] = timer(
            lambda: mw.mips_topk_window_im(q, corpus, k, INDEX_BLOCK, window,
                                           n_valid=n_valid), reps)
        rec["twin_topk_ms"] = timer(
            lambda: mw.mips_topk_window_im_ref(q, corpus, k, INDEX_BLOCK,
                                               window, n_valid=n_valid), 3)
        print(json.dumps({"kernel_check": rec}), flush=True)
        if err > 1e-3:
            raise AssertionError(f"window maxima differ by {err} (> 1e-3)")
        if rec["topk_value_abs_err"] > 1e-3:
            raise AssertionError(f"top-{k} values differ: {rec}")
        if rec["id_overlap_vs_twin"] < 0.99:
            raise AssertionError(f"top-{k} id overlap with the twin < 0.99: {rec}")
        if rec["recall_vs_exact"] < min_recall:
            raise AssertionError(f"recall@{k} < {min_recall}: {rec}")
        out.append(rec)
    return out


def serve_phase(paths, data, device, n_batch_users: int = N_BATCH_USERS,
                batch: int = BATCH, n_requests: int = N_REQUESTS,
                k: int = REQUEST_K, dtype: str = "bfloat16"):
    """Load the port's pipeline over the fused index of ``dtype`` and drive
    its main path: batch_recommend at ``batch`` and ``n_requests`` single
    requests. Checks what comes out and the launch counts of exactly that
    run — on the card one launch of the dtype's window kernel per batch,
    none for the single requests (the scan route) and none of the other
    kernel — and returns the measurements and the counts."""
    from recommendit_tpu_torch.config import Settings
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import quantize_queries
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    cfg = Settings(EMBEDDING_DIM=DIM, HIDDEN_DIM=HIDDEN, INDEX_MODE="fused",
                   INDEX_DTYPE=dtype, TOP_K_CANDIDATES=TOP_K_CANDIDATES,
                   TOP_K_RESULTS=k, FILTER_SEEN=True,
                   RANKER_BLEND_RETRIEVAL=1.0, RANKER_QUERY_NORM=True,
                   STAGE_RECAL_EVERY=0)
    files = {key: paths[key] for key in ("model_path", "ranker_path",
                                         "features_dir")}
    t0 = time.perf_counter()
    pipe = RecommendationPipeline(cfg=cfg, device=device,
                                  index_path=paths[INDEX_PATHS[dtype]], **files)
    pipe.load(data)
    load_s = time.perf_counter() - t0
    n_users, n_items = pipe._n_users, pipe.index.n_total
    rng = np.random.default_rng(7)
    users = rng.choice(np.arange(1, n_users + 1), size=n_batch_users,
                       replace=n_batch_users > n_users).tolist()

    # a warm batch (outside the counted run), then the checks on its output
    ids, scores, rvals = pipe.serve_batch(users[:batch])
    if ids.shape != (batch, min(100, TOP_K_CANDIDATES)):
        raise AssertionError(f"serve_batch shape {tuple(ids.shape)}")
    fin = torch.isfinite(scores)
    if not bool(fin[:, 0].all()):
        raise AssertionError("a user has no unseen candidate")
    if not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        raise AssertionError("serve_batch scores are not sorted")
    if int(ids.min()) < 1 or int(ids.max()) > n_items:
        raise AssertionError("item id out of range")
    # each returned retrieval score is the tower query times the item's
    # row; over int8, (q_i8 · e_i8) · s_item · s_q
    pos = torch.searchsorted(pipe.index._ids_dev, ids)
    q = pipe.index._augment(pipe.model.user_tower(
        torch.as_tensor(users[:batch], device=device)))
    rows = pipe.index._embs[pos]
    if dtype == "int8":
        q8, q_scale = quantize_queries(q)
        dot = (rows.float() * q8.float()[:, None, :]).sum(-1)
        want = dot * pipe.index._scales[pos] * q_scale[:, None]
    else:
        want = (rows.float() * q.to(rows.dtype).float()[:, None, :]).sum(-1)
    rerr = float((want - rvals).abs().max())
    if rerr > 1e-3:
        raise AssertionError(f"retrieval scores disagree with the corpus: {rerr}")

    for name in mw.LAUNCHES:
        mw.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    recs = pipe.batch_recommend(users, k=k, batch_size=batch)
    batch_s = time.perf_counter() - t0
    batch_launches = dict(mw.LAUNCHES)
    lat = []
    singles = {}
    for u in users[:n_requests]:
        t0 = time.perf_counter()
        singles[u] = pipe.get_recommendations(u, k=k, use_cache=False)
        lat.append((time.perf_counter() - t0) * 1e3)
    cold = pipe.get_recommendations(n_users + 1000, k=k, use_cache=False)
    launches = dict(mw.LAUNCHES)

    n_batches = -(-len(users) // batch)
    expect = {name: 0 for name in mw.LAUNCHES}
    if torch.device(device).type == "cuda":
        expect[SERVE_KERNELS[dtype]] = n_batches
    if batch_launches != expect or launches != expect:
        raise AssertionError(
            f"expected launches {expect} ({n_batches} batches, none for the "
            f"single requests), got {batch_launches} after the batches and "
            f"{launches} after the requests")

    for u, got in singles.items():
        ids_u = [r.item_id for r in got]
        if len(ids_u) != k or len(set(ids_u)) != k:
            raise AssertionError(f"user {u}: {len(ids_u)} items, expected {k}")
        if min(ids_u) < 1 or max(ids_u) > n_items:
            raise AssertionError(f"user {u}: item id out of range")
        if pipe._seen.contains(np.full(k, u), np.asarray(ids_u)).any():
            raise AssertionError(f"user {u}: a seen item was recommended")
    if [r.item_id for r in cold] != pipe._popularity_fallback[:k]:
        raise AssertionError("unknown user did not get the popularity fallback")
    if len(recs) != len(set(users)) or any(len(v) != k for v in recs.values()):
        raise AssertionError("batch_recommend returned short lists")
    agree = float(np.mean([
        len(set(recs[u]) & {r.item_id for r in singles[u]}) / k
        for u in singles]))
    return {
        "index_dtype": dtype, "load_s": load_s,
        "batch_users": len(users), "batch_size": batch,
        "batch_s": batch_s, "users_per_s": len(users) / batch_s,
        "requests": len(lat), "request_p50_ms": float(np.median(lat)),
        "request_max_ms": float(np.max(lat)),
        "batch_vs_single_top_k_agreement": agree,
        "retrieval_score_abs_err": rerr,
        "stage_split": pipe.get_stats()["stage_split"],
        "launches": launches,
    }


def quantize_phase(paths, device, seed: int, timer=cuda_ms):
    """Kernel 7 on the catalog's augmented f32 rows: one launch through its
    wrapper (the counted run), then its int8 values and scales against the
    twin's, which must be equal, and the times of the kernel, the twin and
    the build quantizer (threefry, ``quantize_int8``), whose scales must
    equal the kernel's and whose rows must be the saved int8 index's."""
    from recommendit_tpu_torch.ops import quantize as qz

    x = torch.as_tensor(np.load(paths["catalog_path"]), device=device)
    for name in qz.LAUNCHES:
        qz.LAUNCHES[name] = 0
    vals, scales = qz.quantize_int8_hash(x, seed)
    launches = dict(qz.LAUNCHES)
    rv, rs = qz.quantize_int8_hash_ref(x, seed)
    bv, bs = qz.quantize_int8(x, seed)
    with np.load(paths["index_i8_path"]) as saved:
        built_equal = bool(np.array_equal(
            saved["embeddings_i8"][: x.shape[0]], bv.cpu().numpy()))
    rec = {
        "n": x.shape[0], "d": x.shape[1], "seed": seed,
        "values_equal": bool(torch.equal(vals, rv)),
        "scales_equal": bool(torch.equal(scales, rs)),
        "max_abs_err": float(max((vals.int() - rv.int()).abs().max(),
                                 (scales - rs).abs().max())),
        "build_scales_equal": bool(torch.equal(bs, scales)),
        "build_equals_saved_index": built_equal,
        "mean_abs_dequant_err": float(
            (qz.dequantize_int8(vals, scales) - x).abs().mean()),
        "launches": launches,
    }
    del rv, rs, bv, bs
    rec["kernel_ms"] = timer(lambda: qz.quantize_int8_hash(x, seed), 20)
    rec["twin_ms"] = timer(lambda: qz.quantize_int8_hash_ref(x, seed), 3)
    rec["build_quantizer_ms"] = timer(lambda: qz.quantize_int8(x, seed), 3)
    print(json.dumps({"quantize_check": rec}), flush=True)
    if not (rec["values_equal"] and rec["scales_equal"]):
        raise AssertionError(f"the quantize kernel differs from its twin: {rec}")
    if not (rec["build_scales_equal"] and built_equal):
        raise AssertionError(f"the build quantizer disagrees: {rec}")
    want = 1 if torch.device(device).type == "cuda" else 0
    if launches != {"quantize_i8": want}:
        raise AssertionError(f"expected {want} quantize launch, got {launches}")
    return rec


def int8_kernel_phase(paths, device, seed: int, qs=KERNEL_QS,
                      k=TOP_K_CANDIDATES, window=WINDOW, timer=cuda_ms,
                      min_recall=0.98, min_f32_recall=0.95):
    """The int8 window kernel against its twin on the saved int8 index and
    user-tower queries: window maxima and positions equal, the top-k ids
    equal after ``canonical_tie_order``; recall@k against the exact top-k
    of the same int8 scores (``min_recall``) and of the unquantised f32
    rows (``min_f32_recall``). Returns one record per batch size."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import (
        canonical_tie_order,
        fast_topk,
        mips_topk_int8,
        quantize_queries,
        score_matrix,
    )

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_i8_path"], device=device)
    corpus, scales, n_valid = index._embs, index._scales, index.n_total
    rows_f32 = torch.as_tensor(np.load(paths["catalog_path"]), device=device)
    width = rows_f32.shape[1]
    rng = np.random.default_rng(seed + 1)
    out = []
    for n_q in qs:
        uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q),
                               device=device)
        q = index._augment(model.user_tower(uids))
        q8, _ = quantize_queries(q)
        kv, ka = mw.window_candidates_i8(q8, corpus, scales, window, n_valid)
        rv, ra = mw.window_candidates_i8_ref(q8, corpus, scales, window, n_valid)
        args = (q, corpus, scales, k, INDEX_BLOCK, window, n_valid)
        v, i = mw.mips_topk_window_im_int8(*args)
        tv, ti = mw.mips_topk_window_im_int8_ref(*args)
        (cv, ci), (ctv, cti) = canonical_tie_order(v, i), canonical_tie_order(tv, ti)
        _, ei = mips_topk_int8(q, corpus[:n_valid], scales[:n_valid], k)
        _, fi = fast_topk(score_matrix(q[:, :width], rows_f32, "highest"), k)
        rec = {
            "q": n_q, "n": n_valid, "d": int(corpus.shape[1]),
            "d_func": index._width, "window": window, "k": k,
            "dtype": str(corpus.dtype),
            "window_max_equal": bool(torch.equal(kv, rv)),
            "window_arg_equal": bool(torch.equal(ka, ra)),
            "window_max_abs_err": float((kv - rv).abs().max()),
            "topk_ids_equal": bool(torch.equal(ci, cti)),
            "topk_values_equal": bool(torch.equal(cv, ctv)),
            "recall_vs_int8_exact": _overlap(i, ei),
            "recall_vs_f32_exact": _overlap(i, fi),
            "bin_model_recall": 1 - (k - 1) * window / (2 * n_valid),
        }
        del kv, ka, rv, ra, ei, fi
        reps = 20 if n_q <= 256 else 10
        rec["kernel_ms"] = timer(
            lambda: mw.window_candidates_i8(q8, corpus, scales, window, n_valid),
            reps)
        rec["twin_ms"] = timer(
            lambda: mw.window_candidates_i8_ref(q8, corpus, scales, window,
                                                n_valid), 3)
        rec["kernel_topk_ms"] = timer(lambda: mw.mips_topk_window_im_int8(*args),
                                      reps)
        rec["twin_topk_ms"] = timer(
            lambda: mw.mips_topk_window_im_int8_ref(*args), 3)
        print(json.dumps({"int8_kernel_check": rec}), flush=True)
        if not (rec["window_max_equal"] and rec["window_arg_equal"]):
            raise AssertionError(f"int8 window maxima differ from the twin: {rec}")
        if not (rec["topk_ids_equal"] and rec["topk_values_equal"]):
            raise AssertionError(f"int8 top-{k} differs from the twin: {rec}")
        if rec["recall_vs_int8_exact"] < min_recall:
            raise AssertionError(f"recall@{k} vs int8-exact < {min_recall}: {rec}")
        if rec["recall_vs_f32_exact"] < min_f32_recall:
            raise AssertionError(f"recall@{k} vs f32-exact < {min_f32_recall}: {rec}")
        out.append(rec)
    return out


def qm_window_phase(paths, device, seed: int, qs=KERNEL_QS, k=TOP_K_CANDIDATES,
                    window=WINDOW, default_window=QM_WINDOW, block=QM_BLOCK,
                    timer=cuda_ms):
    """Kernel 2 (the queries-major window kernel) on the saved bf16 corpus
    and user-tower queries: at each Q and ``window`` its maxima within 1e-3
    of the twin, its top-k ids overlapping the twin's by >= 0.99, and its
    maxima and positions equal to kernel 1's transposed (the same tiles and
    arithmetic); then at the largest Q and ``default_window`` the same
    checks and both times. Returns one record per (Q, window)."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.topk import fast_topk, score_matrix

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_path"], device=device)
    corpus, n_valid = index._embs, index.n_total
    rng = np.random.default_rng(seed + 6)
    out = []
    for n_q, w in [(n_q, window) for n_q in qs] + [(qs[-1], default_window)]:
        uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q),
                               device=device)
        q = index._augment(model.user_tower(uids))
        kv, ka = mw.window_candidates_qm(q, corpus, w, n_valid)
        rv, ra = mw.window_candidates_qm_ref(q, corpus, w, n_valid)
        iv, ia = mw.window_candidates(q, corpus, w, n_valid)
        v, i = mw.mips_topk_window(q, corpus, k, block, w, n_valid=n_valid)
        tv, ti = mw.mips_topk_window_ref(q, corpus, k, block, w, n_valid=n_valid)
        _, ei = fast_topk(score_matrix(q, corpus[:n_valid], "default"), k)
        rec = {
            "q": n_q, "n": n_valid, "d": int(corpus.shape[1]),
            "d_func": index._width, "window": w, "k": k,
            "dtype": str(corpus.dtype),
            "window_max_abs_err": float((kv - rv).abs().max()),
            "equals_items_major_transposed": bool(
                torch.equal(kv, iv.T) and torch.equal(ka, ia.T)),
            "args_equal_share": float((ka == ra).float().mean()),
            "topk_value_abs_err": float((v - tv).abs().max()),
            "id_overlap_vs_twin": _overlap(i, ti),
            "recall_vs_exact": _overlap(i, ei),
            "bin_model_recall": 1 - (k - 1) * w / (2 * n_valid),
        }
        del kv, ka, rv, ra, iv, ia, ei
        if w == default_window:
            rec["kernel_ms"] = timer(
                lambda: mw.window_candidates_qm(q, corpus, w, n_valid), 10)
            rec["twin_ms"] = timer(
                lambda: mw.window_candidates_qm_ref(q, corpus, w, n_valid), 3)
        print(json.dumps({"qm_window_check": rec}), flush=True)
        if rec["window_max_abs_err"] > 1e-3:
            raise AssertionError(f"queries-major maxima differ from the twin: {rec}")
        if not rec["equals_items_major_transposed"]:
            raise AssertionError(f"kernel 2 differs from kernel 1 transposed: {rec}")
        if rec["id_overlap_vs_twin"] < 0.99:
            raise AssertionError(f"top-{k} id overlap with the twin < 0.99: {rec}")
        out.append(rec)
    return out


def _tie_inputs(n, d, n_q, dtype, device, seed):
    """Integer-valued queries and rows in {-1, 0, 1}: every score is an
    exact small integer, so bins are full of ties."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-1, 2, (n_q, d), generator=g).float()
    items = torch.randint(-1, 2, (n, d), generator=g).float().to(dtype)
    return q.to(device), items.to(device)


# (N, D, Q, block, R): bins narrower than a 64-row tile (bn/R = 32) and
# wider (256), both with a bias pad (N % bn != 0), and a tiny block
TIE_CASES = ((5000, 8, 100, 256, 8), (9000, 12, 70, 2048, 8),
             (301, 4, 3, 16, 4))


def fold_phase(paths, device, seed: int, n_q: int = FOLD_Q,
               k: int = TOP_K_CANDIDATES, block: int = FOLD_BLOCK,
               reduction: int = FOLD_R, timer=cuda_ms, min_recall=0.98,
               tie_cases=TIE_CASES):
    """Kernel 4 (the fold) through ``mips_topk_fused`` on the valid rows of
    the saved bf16 corpus and user-tower queries: candidates within 1e-4 of
    the twin relative to the largest, recall@k against the exact top-k of
    the same f32-query scores; on integer-valued inputs full of ties the
    candidates equal to the twin's (values and ids); both times."""
    from recommendit_tpu_torch.models import MIPSIndex, TwoTower
    from recommendit_tpu_torch.ops import mips_fold as mf
    from recommendit_tpu_torch.ops.topk import fast_topk, score_matrix

    model = TwoTower.load(paths["model_path"], device=device)
    index = MIPSIndex.load(paths["index_path"], device=device)
    corpus = index._embs[:index.n_total]
    n = corpus.shape[0]
    rng = np.random.default_rng(seed + 7)
    uids = torch.as_tensor(rng.integers(1, model.n_users + 1, n_q), device=device)
    q = index._augment(model.user_tower(uids))
    cv, ci = mf.fold_candidates(q, corpus, block, reduction)
    rv, ri = mf.fold_candidates_ref(q, corpus, block, reduction)
    v, i = mf.mips_topk_fused(q, corpus, k, block, reduction)
    _, ei = fast_topk(score_matrix(q, corpus, "highest"), k)
    bn, out, n_blocks = mf.fold_shape(n, k, block, reduction)
    rec = {
        "q": n_q, "n": n, "d": int(corpus.shape[1]), "d_func": index._width,
        "block": bn,
        "reduction": reduction, "k": k, "dtype": str(corpus.dtype),
        "n_cand": n_blocks * out,
        "max_abs_err": float((cv - rv).abs().max()),
        "rel_err": float((cv - rv).abs().max() / rv.abs().max()),
        "ids_equal_share": float((ci == ri).float().mean()),
        "recall_vs_exact": _overlap(i, ei),
        "bin_model_recall": 1 - (k - 1) * reduction / (2 * n),
    }
    del cv, ci, rv, ri, ei
    ties = []
    for j, (tn, td, tq, tb, tr) in enumerate(tie_cases):
        for dtype in (torch.float32, torch.bfloat16):
            tq_, ti_ = _tie_inputs(tn, td, tq, dtype, device, seed + j)
            a = mf.fold_candidates(tq_, ti_, tb, tr)
            b = mf.fold_candidates_ref(tq_, ti_, tb, tr)
            ties.append(bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])))
    rec["ties_equal"] = ties
    rec["kernel_ms"] = timer(
        lambda: mf.fold_candidates(q, corpus, block, reduction), 10)
    rec["twin_ms"] = timer(
        lambda: mf.fold_candidates_ref(q, corpus, block, reduction), 3)
    rec["kernel_topk_ms"] = timer(
        lambda: mf.mips_topk_fused(q, corpus, k, block, reduction), 10)
    print(json.dumps({"fold_check": rec}), flush=True)
    if rec["rel_err"] > 1e-4:
        raise AssertionError(f"fold candidates differ from the twin: {rec}")
    if rec["ids_equal_share"] < 0.999:
        raise AssertionError(f"fold rows differ from the twin's: {rec}")
    if not all(ties):
        raise AssertionError(f"fold ties differ from the twin: {rec}")
    if rec["recall_vs_exact"] < min_recall:
        raise AssertionError(f"recall@{k} < {min_recall}: {rec}")
    return rec


def gather_phase(paths, device, seed: int, shape=GATHER_SHAPE, timer=cuda_ms):
    """Kernel 8 on the serve's packed item table (padded to 64 columns):
    one launch through ``gather_rows`` with a ``shape`` int64 index (the
    counted run), equal to the twin; out-of-range and int32 indices, the
    unpadded 23-wide f32 table and a bf16 table, each equal to the twin;
    the times of the kernel, the twin and ``torch.index_select``, and the
    bytes this index must move (each distinct row read once, the output
    written once, the index read once)."""
    from recommendit_tpu_torch.features.schema import pad_packed_width
    from recommendit_tpu_torch.ops import gather

    raw = np.load(Path(paths["features_dir"]) / "item_packed.npy")
    table = torch.as_tensor(pad_packed_width(raw), device=device)
    rng = np.random.default_rng(seed + 8)
    idx = torch.as_tensor(rng.integers(0, table.shape[0], size=shape),
                          device=device)
    for name in gather.LAUNCHES:
        gather.LAUNCHES[name] = 0
    got = gather.gather_rows(table, idx)
    launches = dict(gather.LAUNCHES)
    want = gather.gather_rows_ref(table, idx)
    bad = torch.tensor([-5, table.shape[0], 10 ** 12, -10 ** 12], device=device)
    wild = idx.clone()
    at = torch.arange(0, wild.numel(), 997, device=device)
    wild.view(-1)[at] = bad[torch.arange(len(at), device=device) % len(bad)]
    narrow = torch.as_tensor(raw, device=device)
    variants = {
        "out_of_range": (table, wild),
        "int32": (table, wild.clamp(-2 ** 31, 2 ** 31 - 1).int()),
        "f32_23_wide": (narrow, wild),
        "bf16": (table.to(torch.bfloat16), wild),
        "zero_dim": (narrow, idx[0, 0]),
    }
    equal = {k: bool(torch.equal(gather.gather_rows(t, i), gather.gather_rows_ref(t, i)))
             for k, (t, i) in variants.items()}
    row_bytes = table.shape[1] * table.element_size()
    rec = {
        "table": list(table.shape), "index": list(shape),
        "equal": bool(torch.equal(got, want)), "variants_equal": equal,
        "max_abs_err": float((got - want).abs().max()),
        "bytes": (int(torch.unique(idx).numel()) * row_bytes
                  + idx.numel() * row_bytes + idx.numel() * idx.element_size()),
        "launches": launches,
    }
    flat = idx.view(-1)
    rec["kernel_ms"] = timer(lambda: gather.gather_rows(table, idx), 50)
    rec["twin_ms"] = timer(lambda: gather.gather_rows_ref(table, idx), 20)
    rec["library_ms"] = timer(lambda: torch.index_select(table, 0, flat), 50)
    print(json.dumps({"gather_check": rec}), flush=True)
    if not rec["equal"] or not all(equal.values()):
        raise AssertionError(f"gather_rows differs from its twin: {rec}")
    want_launches = 1 if torch.device(device).type == "cuda" else 0
    if launches != {"gather_rows": want_launches}:
        raise AssertionError(f"expected {want_launches} gather launch, got {launches}")
    return rec


def probe_phase(device, probe_args=PROBE_ARGS):
    """The kernel probe's four variants in-process (the path of kernels 2
    and 4), each of which must exit 0; the window and fold launch counts
    are read around exactly this run. Returns (records, launches)."""
    from recommendit_tpu_torch.ops import mips_fold as mf
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.scripts import kernel_probe

    dev = torch.device(device).type
    for counts in (mw.LAUNCHES, mf.LAUNCHES):
        for name in counts:
            counts[name] = 0
    recs = []
    for variant in kernel_probe.VARIANTS:
        code, rec = kernel_probe.probe(["--variant", variant, *probe_args,
                                        "--device", dev])
        print(json.dumps(rec), flush=True)
        if code != 0:
            raise AssertionError(f"kernel probe {variant} exited {code}: {rec}")
        recs.append(rec)
    launches = {**mw.LAUNCHES, **mf.LAUNCHES}
    if dev == "cuda" and not all(launches.values()):
        raise AssertionError(f"the probe missed a kernel: {launches}")
    return recs, launches


def capacity_phase(device, seed: int, n_rows: int = CAPACITY_ROWS,
                   dim: int = CAPACITY_DIM, window: int = CAPACITY_WINDOW,
                   n_q: int = CAPACITY_Q, n_check: int = CAPACITY_CHECK_Q,
                   k: int = TOP_K_CANDIDATES, chunk: int = CAPACITY_CHUNK,
                   block: int = INDEX_BLOCK, timer=cuda_ms, min_recall=0.98):
    """The shape of ``scripts/capacity_30m.py``: ``n_rows`` random unit rows
    made, normalised and quantised on the device chunk by chunk (the
    threefry counter offset by each chunk's first row), padded with scale-0
    rows to a ``block`` multiple; the int8 window kernel timed at ``n_q``
    queries; on ``n_check`` of them its maxima and positions equal to the
    twin's (row-chunked) and recall@k against int8-exact."""
    from recommendit_tpu_torch.ops import mips_window as mw
    from recommendit_tpu_torch.ops.quantize import quantize_int8
    from recommendit_tpu_torch.ops.topk import mips_topk_int8, quantize_queries

    t0 = time.perf_counter()
    n_pad = n_rows + (-n_rows % block)
    corpus = torch.zeros((n_pad, dim), dtype=torch.int8, device=device)
    scales = torch.zeros(n_pad, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    for r0 in range(0, n_rows, chunk):
        r1 = min(n_rows, r0 + chunk)
        x = torch.randn((r1 - r0, dim), generator=gen, device=device)
        x = x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)
        corpus[r0:r1], scales[r0:r1] = quantize_int8(x, seed, row_offset=r0)
        del x
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    q = torch.randn((n_q, dim), generator=gen, device=device)
    q8, _ = quantize_queries(q[:n_check])
    kv, ka = mw.window_candidates_i8(q8, corpus, scales, window, n_rows)
    rv, ra = mw.window_candidates_i8_ref(q8, corpus, scales, window, n_rows)
    _, i = mw.mips_topk_window_im_int8(q[:n_check], corpus, scales, k, block,
                                       window, n_rows)
    _, ei = mips_topk_int8(q[:n_check], corpus, scales, k, n_valid=n_rows)
    rec = {
        "n": n_rows, "d": dim, "window": window, "k": k, "q": n_q,
        "check_q": n_check, "corpus_bytes": corpus.numel() + 4 * scales.numel(),
        "build_s": build_s,
        "window_max_equal": bool(torch.equal(kv, rv)),
        "window_arg_equal": bool(torch.equal(ka, ra)),
        "recall_vs_int8_exact": _overlap(i, ei),
        "bin_model_recall": 1 - (k - 1) * window / (2 * n_rows),
    }
    del kv, ka, rv, ra, i, ei
    q8, _ = quantize_queries(q)
    rec["kernel_ms"] = timer(
        lambda: mw.window_candidates_i8(q8, corpus, scales, window, n_rows), 3)
    rec["kernel_topk_ms"] = timer(
        lambda: mw.mips_topk_window_im_int8(q, corpus, scales, k, block, window,
                                            n_rows), 3)
    rec["queries_per_s"] = n_q / (rec["kernel_topk_ms"] / 1e3)
    print(json.dumps({"capacity_check": rec}), flush=True)
    if not (rec["window_max_equal"] and rec["window_arg_equal"]):
        raise AssertionError(f"int8 window maxima differ from the twin: {rec}")
    if rec["recall_vs_int8_exact"] < min_recall:
        raise AssertionError(f"recall@{k} vs int8-exact < {min_recall}: {rec}")
    return rec


def bpr_kernel_phase(device, seed: int, shapes=BPR_SHAPES, timer=cuda_ms):
    """The BPR forward and backward (kernels on the card) against their
    twins on seeded unit rows. Returns one record per (B, D)."""
    from recommendit_tpu_torch.ops import bpr

    gen = torch.Generator().manual_seed(seed + 2)
    out = []
    for b, d in shapes:
        u, v = (torch.nn.functional.normalize(torch.randn(b, d, generator=gen),
                                              dim=1).to(device) for _ in "uv")
        g = torch.tensor(1.0, device=device)
        loss = bpr.bpr_forward(u, v)
        ref = bpr.in_batch_bpr_loss_ref(u, v)
        du, dv = bpr.bpr_backward(u, v, g)
        rdu, rdv = bpr._bpr_bwd_ref(u, v, g)
        rec = {
            "b": b, "d": d, "loss": float(loss), "twin_loss": float(ref),
            "loss_rel_err": abs(float(loss) - float(ref)) / abs(float(ref)),
            "du_err": float((du - rdu).abs().max() / rdu.abs().max()),
            "dv_err": float((dv - rdv).abs().max() / rdv.abs().max()),
            "grad_max_abs_err": float(max((du - rdu).abs().max(),
                                          (dv - rdv).abs().max())),
        }
        rec["fwd_ms"] = timer(lambda: bpr.bpr_forward(u, v), 50)
        rec["twin_fwd_ms"] = timer(lambda: bpr.in_batch_bpr_loss_ref(u, v), 50)
        rec["bwd_ms"] = timer(lambda: bpr.bpr_backward(u, v, g), 50)
        rec["twin_bwd_ms"] = timer(lambda: bpr._bpr_bwd_ref(u, v, g), 50)
        print(json.dumps({"bpr_check": rec}), flush=True)
        if not rec["loss_rel_err"] <= 1e-5:
            raise AssertionError(f"BPR loss differs from the twin: {rec}")
        if not max(rec["du_err"], rec["dv_err"]) <= 1e-4:
            raise AssertionError(f"BPR gradients differ from the twin: {rec}")
        out.append(rec)
    return out


def bound(n_bytes: float, ops: float = 0.0, kind: str = "f32"):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``n_bytes`` over the HBM rate and ``ops`` over the peak rate of
    their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_bound(rec, corpus_bytes: int, query_bytes: int, kind: str,
                 scales: bool = False):
    """Bound of a window kernel call: the valid corpus rows (and their
    scales), the queries and the (n_cand, Q) values and positions moved
    once; 2·Q·N·D multiply-adds of ``kind``. D is the function's width
    (``d_func``: the embedding and the bias column), not the device rows'
    zero-padded one."""
    q, n, d = rec["q"], rec["n"], rec["d_func"]
    n_cand = -(-n // rec["window"])
    n_bytes = (n * d * corpus_bytes + q * d * query_bytes + n_cand * q * 8
               + (4 * n if scales else 0))
    return bound(n_bytes, 2.0 * q * n * d, kind)


def make_train_data(seed: int, n_users: int = TRAIN_USERS,
                    n_items: int = TRAIN_ITEMS, n_ratings: int = N_RATINGS):
    """Synthetic ML-1M-shaped data and its temporal train view."""
    from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens

    data = make_synthetic_movielens(n_users, n_items, n_ratings, seed=seed)
    return data, data.train_view(TRAIN_SPLIT)


def _train_cfg(seed: int, loss_mode: str, dim: int, hidden: int, batch: int):
    from recommendit_tpu_torch.config import Settings

    return Settings(LOSS_MODE=loss_mode, EMBEDDING_DIM=dim, HIDDEN_DIM=hidden,
                    BATCH_SIZE=batch, DROPOUT=TRAIN_DROPOUT, USE_PALLAS=True,
                    SEED=seed, INDEX_MODE="exact", INDEX_DTYPE="float32")


def train_phase(view, device, seed: int, workdir: Path, epochs: int = TRAIN_EPOCHS,
                dim: int = TRAIN_DIM, hidden: int = TRAIN_HIDDEN,
                batch: int = TRAIN_BATCH):
    """In-batch BPR training (the main path), with the kernel launch counts
    read around exactly that run — one forward and one backward launch per
    step on the card, none on the CPU (the twins) — then one softmax epoch.
    Returns the in-batch model and the measurements."""
    from recommendit_tpu_torch.ops import bpr
    from recommendit_tpu_torch.training import EmbeddingTrainer

    workdir.mkdir(parents=True, exist_ok=True)
    trainer = EmbeddingTrainer(view, _train_cfg(seed, "in_batch", dim, hidden,
                                                batch),
                               model_output_path=str(workdir / "two_tower_bpr.npz"),
                               device=device)
    for name in bpr.LAUNCHES:
        bpr.LAUNCHES[name] = 0
    model = trainer.train(epochs=epochs)
    launches = dict(bpr.LAUNCHES)
    hist = trainer.history
    steps = sum(h["steps"] for h in hist)
    losses = [h["loss"] for h in hist]
    rec = {
        "positives": len(trainer.pos_users), "steps": steps,
        "losses": losses, "seconds": [h["seconds"] for h in hist],
        "examples_per_s": [h["examples_per_s"] for h in hist],
        "ms_per_step": [1e3 * h["seconds"] / h["steps"] for h in hist],
        "launches": launches,
    }
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not losses[-1] < np.log(2.0):
        raise AssertionError(f"the loss {losses[-1]} is not below ln 2")
    per_step = steps if torch.device(device).type == "cuda" else 0
    if launches != {"bpr_fwd": per_step, "bpr_bwd": per_step}:
        raise AssertionError(
            f"expected {per_step} forward and backward launches ({steps} "
            f"steps), got {launches}")

    soft = EmbeddingTrainer(view, _train_cfg(seed, "softmax", dim, hidden, batch),
                            model_output_path="", device=device)
    soft.train(epochs=1)
    rec["softmax_loss"] = soft.history[0]["loss"]
    rec["softmax_examples_per_s"] = soft.history[0]["examples_per_s"]
    rec["softmax_launches"] = dict(bpr.LAUNCHES)
    if not np.isfinite(rec["softmax_loss"]):
        raise AssertionError(f"non-finite softmax loss: {rec['softmax_loss']}")
    if rec["softmax_launches"] != launches:
        raise AssertionError("the softmax epoch launched a BPR kernel")
    return model, rec


def index_phase(model, data, view, device, seed: int, workdir: Path,
                n_users: int = INDEX_USERS, k: int = RECALL_K):
    """Build the exact f32 index from the trained towers and search it for
    users with held-out positives: Recall@k of those positives, the items
    each user rated in the train view filtered out, against a random
    ranking of the same unrated items."""
    from recommendit_tpu_torch.data.movielens import timestamp_order
    from recommendit_tpu_torch.training import IndexBuilder

    cfg = _train_cfg(seed, "in_batch", model.embed_dim, model.hidden_dim, 0)
    index = IndexBuilder(view, cfg, index_output_path=str(workdir / "bpr.index.npz"),
                         device=device).build(model=model)
    n_items = model.n_items
    seen = np.zeros((model.n_users + 1, n_items + 1), dtype=bool)
    seen[view.user_id, view.item_id] = True
    # held out: the positives past the train view's timestamp cut
    rows = timestamp_order(data.timestamp)[len(view):]
    rows = rows[data.rating[rows] >= 4]
    held = np.zeros_like(seen)
    held[data.user_id[rows], data.item_id[rows]] = True
    held &= ~seen
    cand = np.flatnonzero(held.any(axis=1))
    users = np.random.default_rng(seed + 3).choice(
        cand, size=min(n_users, len(cand)), replace=False)

    q = model.user_tower(torch.as_tensor(users, device=device)).cpu().numpy()
    scores, ids = index.batch_search(q, k=n_items)
    if ids.shape != (len(users), n_items):
        raise AssertionError(f"batch_search returned {ids.shape}")
    if ids.min() < 1 or ids.max() > n_items or not np.isfinite(scores).all():
        raise AssertionError("batch_search returned an invalid id or score")
    if not (np.sort(ids, axis=1) == np.arange(1, n_items + 1)).all():
        raise AssertionError("a full-catalog search repeated or lost an item")

    def recall(ranked):
        unseen = ~seen[users[:, None], ranked]
        top = unseen & (np.cumsum(unseen, axis=1) <= k)
        hits = (held[users[:, None], ranked] & top).sum(axis=1)
        return float(np.mean(hits / held[users].sum(axis=1)))

    rnd = np.argsort(np.random.default_rng(seed + 4).random(ids.shape), axis=1) + 1
    rec = {"users": len(users), "index_items": index.n_total,
           "index_has_bias": index.has_bias,
           f"recall@{k}": recall(ids), f"random_recall@{k}": recall(rnd)}
    if not rec[f"recall@{k}"] > rec[f"random_recall@{k}"]:
        raise AssertionError(f"retrieval does not beat a random ranking: {rec}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="artifact directory (default: "
                         "recommendit_tpu_torch/build/chip_smoke)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from recommendit_tpu_torch.ops import _build

    root = Path(__file__).resolve().parent
    workdir = Path(args.workdir or root / "recommendit_tpu_torch" / "build"
                   / "chip_smoke")
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    t_start = t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(_build.load_library, LIBRARIES))
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "nvcc_s": {n: _build.build_seconds[n] for n in LIBRARIES}}),
          flush=True)

    t0 = time.perf_counter()
    paths, data = make_artifacts(workdir, args.seed, device)
    print(json.dumps({"artifacts_s": time.perf_counter() - t0}), flush=True)

    checks = kernel_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    serve = serve_phase(paths, data, device)
    print(json.dumps({"serve": serve, "card": card}), flush=True)
    torch.cuda.empty_cache()

    quant = quantize_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    checks_i8 = int8_kernel_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    serve_i8 = serve_phase(paths, data, device, dtype="int8")
    print(json.dumps({"serve_int8": serve_i8, "card": card}), flush=True)
    torch.cuda.empty_cache()

    checks_qm = qm_window_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    fold = fold_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    gath = gather_phase(paths, device, args.seed)
    torch.cuda.empty_cache()
    probes, probe_launches = probe_phase(device)
    print(json.dumps({"probe_launches": probe_launches, "card": card}),
          flush=True)
    del paths, data
    torch.cuda.empty_cache()

    capacity = capacity_phase(device, args.seed)
    print(json.dumps({"capacity": capacity, "card": card}), flush=True)
    torch.cuda.empty_cache()

    bpr_checks = bpr_kernel_phase(device, args.seed)
    t0 = time.perf_counter()
    data, view = make_train_data(args.seed)
    print(json.dumps({"train_data": {
        "ratings": len(data), "train_view": len(view), "users": data.n_users,
        "items": data.n_items, "seconds": time.perf_counter() - t0}}),
        flush=True)
    model, train = train_phase(view, device, args.seed, workdir)
    print(json.dumps({"train": train, "card": card}), flush=True)
    index = index_phase(model, data, view, device, args.seed, workdir)
    print(json.dumps({"index": index}), flush=True)

    print(json.dumps({"total_s": time.perf_counter() - t_start}), flush=True)
    main_q = checks[-1]
    main_i8 = checks_i8[-1]
    main_b = bpr_checks[0]
    main_qm = checks_qm[-1]
    b, d = main_b["b"], main_b["d"]
    kernels = [{
        "name": "window_mips", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": serve["launches"]["window_mips"],
        "max_abs_err": max(c["window_max_abs_err"] for c in checks),
        "ms": main_q["kernel_ms"], "plain_ms": main_q["twin_ms"],
        "bound": window_bound(main_q, 2, 4, "bf16"), "library_ms": None,
    }, {
        "name": "window_mips_qm", "source": KERNEL_SOURCE, "replaces": QM_REPLACES,
        "launches": probe_launches["window_mips_qm"],
        "max_abs_err": max(c["window_max_abs_err"] for c in checks_qm),
        "ms": main_qm["kernel_ms"], "plain_ms": main_qm["twin_ms"],
        "bound": window_bound(main_qm, 2, 4, "bf16"), "library_ms": None,
    }, {
        "name": "window_mips_i8", "source": I8_SOURCE, "replaces": I8_REPLACES,
        "launches": serve_i8["launches"]["window_mips_i8"],
        "max_abs_err": max(c["window_max_abs_err"] for c in checks_i8),
        "ms": main_i8["kernel_ms"], "plain_ms": main_i8["twin_ms"],
        "bound": window_bound(main_i8, 1, 1, "int8", scales=True),
        "library_ms": None,
    }, {
        "name": "fold_mips", "source": FOLD_SOURCE, "replaces": FOLD_REPLACES,
        "launches": probe_launches["fold_mips"],
        "max_abs_err": fold["max_abs_err"],
        "ms": fold["kernel_ms"], "plain_ms": fold["twin_ms"],
        "bound": bound(fold["n"] * fold["d_func"] * 2
                       + fold["q"] * fold["d_func"] * 4
                       + fold["n_cand"] * fold["q"] * 8,
                       2.0 * fold["q"] * fold["n"] * fold["d_func"], "f32"),
        "library_ms": None,
    }, {
        "name": "bpr_fwd", "source": BPR_SOURCE, "replaces": BPR_REPLACES["bpr_fwd"],
        "launches": train["launches"]["bpr_fwd"],
        "max_abs_err": max(abs(c["loss"] - c["twin_loss"]) for c in bpr_checks),
        "ms": main_b["fwd_ms"], "plain_ms": main_b["twin_fwd_ms"],
        # the (B, B) score matrix; the softplus per pair is not counted
        "bound": bound(2 * b * d * 4 + 4, 2.0 * b * b * d, "f32"),
        "library_ms": None,
    }, {
        "name": "bpr_bwd", "source": BPR_SOURCE, "replaces": BPR_REPLACES["bpr_bwd"],
        "launches": train["launches"]["bpr_bwd"],
        "max_abs_err": max(c["grad_max_abs_err"] for c in bpr_checks),
        "ms": main_b["bwd_ms"], "plain_ms": main_b["twin_bwd_ms"],
        # the scores again, then du = G V and dv = G^T U
        "bound": bound(4 * b * d * 4 + 4, 6.0 * b * b * d, "f32"),
        "library_ms": None,
    }, {
        "name": "quantize_i8", "source": QUANT_SOURCE, "replaces": QUANT_REPLACES,
        "launches": quant["launches"]["quantize_i8"],
        "max_abs_err": quant["max_abs_err"],
        "ms": quant["kernel_ms"], "plain_ms": quant["twin_ms"],
        "bound": bound(quant["n"] * quant["d"] * 5 + quant["n"] * 4),
        "library_ms": None,
    }, {
        "name": "gather_rows", "source": GATHER_SOURCE, "replaces": GATHER_REPLACES,
        "launches": gath["launches"]["gather_rows"],
        "max_abs_err": gath["max_abs_err"],
        "ms": gath["kernel_ms"], "plain_ms": gath["twin_ms"],
        "bound": bound(gath["bytes"]), "library_ms": gath["library_ms"],
    }]
    for kern in kernels:
        kern["route"] = "cuda"
        kern["bound_ms"], kern["bound_by"] = kern.pop("bound")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
