"""Recall and QPS per retrieval mode — torch port of
``scripts/recall_curve.py``.

One corpus, JAX's: ``--n-items`` x ``--dim`` normal rows from numpy's
``default_rng(0)``, normalised, f32, and a batch of ``--batch`` unit
queries from the same generator. The truth is exact mode's top-k
(``mips_topk``). Each mode's recall@k against it and its chained batch time
(``utils/profiling.device_loop_time``, ``--iters`` a round, best of 3):

* ``exact`` — ``mips_topk`` (full f32);
* ``verified`` — ``mips_topk_certified`` (count method);
* ``approx_rt{t}`` for each ``--recall-targets`` value — ``fast_topk`` of
  the f32 scores at target t. JAX selects there with ``approx_max_k``;
  the port's selection is exact at every target (C.4), so each such row
  is the exact top-k of the same scores, and its recall is exact mode's;
* ``int8_exact`` — ``mips_topk_int8`` over ``quantize_int8(items, 0)``
  (JAX's ``quantize_int8_jnp`` at ``PRNGKey(0)``, byte for byte, rule 1).

No kernel of the port runs here: every mode is plain PyTorch. One JSON
report with JAX's keys; ``platform`` names the card and its power limit.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.recall_curve [--n-items 1000000] \\
      [--dim 128] [--k 500] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from recommendit_tpu_torch.scripts.retrieval_common import (
    default_out,
    recall_rows,
    timed_ms,
    write_report,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, platform_name, resolve_device

ROUNDS = 3            # timed rounds a mode (JAX's device_loop_time default)


def make_data(n: int, d: int, b: int):
    """JAX's corpus and queries, as numpy f32 arrays."""
    rng = np.random.default_rng(0)
    items_np = rng.normal(size=(n, d)).astype(np.float32)
    items_np /= np.linalg.norm(items_np, axis=1, keepdims=True)
    q0 = rng.normal(size=(b, d)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    return items_np, q0


def modes(args, items):
    """[(mode, fn(q, *operands), operands)] in JAX's order."""
    from recommendit_tpu_torch.ops.quantize import quantize_int8
    from recommendit_tpu_torch.ops.topk import (
        fast_topk,
        mips_topk,
        mips_topk_certified,
        mips_topk_int8,
        score_matrix,
    )

    k, block = args.k, args.block
    out = [("exact", lambda q, it: mips_topk(q, it, k, block), (items,)),
           ("verified", lambda q, it: mips_topk_certified(q, it, k, block), (items,))]
    for rt in [float(x) for x in args.recall_targets.split(",")]:
        out.append((f"approx_rt{rt}",
                    lambda q, it, _rt=rt: fast_topk(score_matrix(q, it, "default"), k, _rt),
                    (items,)))
    items_i8, scales = quantize_int8(items, 0)
    out.append(("int8_exact",
                lambda q, it_i8, sc: mips_topk_int8(q, it_i8, sc, k), (items_i8, scales)))
    return out


def run(args) -> dict:
    from recommendit_tpu_torch.ops.topk import mips_topk

    dev = resolve_device(args.device)
    n, d, k, b = args.n_items, args.dim, args.k, args.batch
    items_np, q_np = make_data(n, d, b)
    items = torch.as_tensor(items_np, device=dev)
    q0 = torch.as_tensor(q_np, device=dev)
    del items_np
    platform = platform_name(dev)
    print(f"platform: {platform}; corpus {n}x{d}, k={k}", flush=True)

    rows = []
    with torch.no_grad():
        truth = mips_topk(q0, items, k, args.block)[1].cpu().numpy()
        for name, fn, operands in modes(args, items):
            t0 = time.time()
            _, idx = fn(q0, *operands)
            recall = float(np.mean(recall_rows(idx.cpu().numpy(), truth, k)))
            dt = timed_ms(name, fn, q0, *operands, iters=args.iters, rounds=ROUNDS) / 1e3
            row = {
                "mode": name,
                "recall@k": round(recall, 5),
                "qps": round(b / dt, 1),
                "batch_ms": round(dt * 1000, 3),
                "setup_s": round(time.time() - t0, 1),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    return {"n_items": n, "dim": d, "k": k, "batch": b, "platform": platform,
            "rows": rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-items", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--recall-targets", default="0.80,0.90,0.95,0.99")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=default_out("recall_curve.json"))
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    write_report(out, args.out)
    print(f"written -> {args.out}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
