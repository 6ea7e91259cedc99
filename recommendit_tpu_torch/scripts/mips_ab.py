"""Window kernel against the dense route, in one process — torch port of
``scripts/mips_ab.py``.

JAX's arrays: ``--n`` x ``--d`` normal rows from numpy's
``default_rng(0)``, normalised (f32, and a bf16 copy), ``--recall-queries``
raw normal queries whose exact top-k sets come from a numpy f32 product,
then at each of ``--qs`` a batch of raw normal queries. Three variants,
under JAX's names, each timed chained (``utils/profiling.device_loop_time``,
``--iters`` a round, best of 4) and its recall@k taken on the recall
queries:

* ``xla_approx_rt0.95_f32`` — the port's dense route
  (``mips_topk_dense(q, items, k, 0.95)``: one score matrix and one top-k;
  its selection is exact, C.4, where JAX's is ``approx_max_k``);
* ``fused_window_im_f32`` — kernel 1 over the f32 corpus (on the card its
  CUDA-core body, f32 FMAs);
* ``fused_window_im_bf16`` — kernel 1 over the bf16 corpus (on the card
  its tensor-core body),

both at ``--window`` with no mask (2^20 rows fill every window). One JSON
report with JAX's keys; ``platform`` names the card and its power limit.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.mips_ab [--n 1048576] [--d 128] \\
      [--qs 256 1024] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from recommendit_tpu_torch.scripts.retrieval_common import default_out, timed_ms, write_report
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, platform_name, resolve_device

ROUNDS = 4


def variants(args, items, items_bf16):
    """[(name, fn(q, it), corpus)] in JAX's order."""
    from recommendit_tpu_torch.ops.mips_window import mips_topk_window_im
    from recommendit_tpu_torch.ops.topk import mips_topk_dense

    def fused(qq, it):
        return mips_topk_window_im(qq, it, args.k, args.block, args.window, "default")

    def dense(qq, it):
        return mips_topk_dense(qq, it, args.k, 0.95)

    return [("xla_approx_rt0.95_f32", dense, items),
            ("fused_window_im_f32", fused, items),
            ("fused_window_im_bf16", fused, items_bf16)]


def make_corpus(args):
    """(``default_rng(0)``, JAX's normalised f32 corpus): the generator goes
    on to the recall queries and the timed batches."""
    rng = np.random.default_rng(0)
    items_np = rng.normal(size=(args.n, args.d)).astype(np.float32)
    items_np /= np.linalg.norm(items_np, axis=1, keepdims=True)
    return rng, items_np


def run(args, data=None) -> dict:
    """The report; ``data`` is :func:`make_corpus`'s pair when the caller
    made it already."""
    dev = resolve_device(args.device)
    rng, items_np = data if data is not None else make_corpus(args)
    items = torch.as_tensor(items_np, device=dev)
    items_bf16 = items.to(torch.bfloat16)

    # exact reference sets for recall (numpy, on a query subset)
    nq_r = args.recall_queries
    q_recall = rng.normal(size=(nq_r, args.d)).astype(np.float32)
    scores_ref = q_recall @ items_np.T
    exact_sets = [set(np.argpartition(-scores_ref[r], args.k)[:args.k].tolist())
                  for r in range(nq_r)]
    del items_np, scores_ref
    q_recall_t = torch.as_tensor(q_recall, device=dev)

    def recall_of(fn, it):
        i = fn(q_recall_t, it)[1].cpu().numpy()
        return float(np.mean([len(set(i[r].tolist()) & exact_sets[r]) / args.k
                              for r in range(nq_r)]))

    rows = []
    with torch.no_grad():
        for q in args.qs:
            q0 = torch.as_tensor(rng.normal(size=(q, args.d)).astype(np.float32),
                                 device=dev)
            for name, fn, it in variants(args, items, items_bf16):
                ms = timed_ms(f"{name} q={q}", fn, q0, it, iters=args.iters,
                              rounds=ROUNDS)
                row = {"variant": name, "q": q, "n": args.n, "d": args.d, "k": args.k,
                       "batch_ms": round(ms, 3), "qps": round(q / (ms / 1000), 1),
                       "recall_at_k": round(recall_of(fn, it), 4)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return {"n": args.n, "d": args.d, "k": args.k, "block": args.block,
            "window": args.window, "platform": platform_name(dev), "rows": rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--qs", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--recall-queries", type=int, default=64)
    ap.add_argument("--out", default=default_out("mips_ab.json"))
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    write_report(out, args.out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
