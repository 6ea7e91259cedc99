"""Exact, count-verified and bound-verified top-k across widths — torch
port of ``scripts/bound_turf.py``.

At each of ``--dims`` the corpus keeps ``--n`` x 128 f32 entries (so
``n * 128 / d`` rows of ``d`` columns): JAX's arrays, normal rows and then
``--q`` normal queries from one numpy ``default_rng(0)``, both normalised.
Three searches, each timed chained (``utils/profiling.device_loop_time``,
``--iters`` a round, best of 3): ``mips_topk`` exact mode,
``mips_topk_verified`` (the count certificate: a second full-f32 pass) and
``mips_topk_bound_verified`` (one bf16-input pass, an exact rescore of
``--m`` candidates, a rounding-error certificate); for the two verified
ones the share of queries certified on the unchained batch. No kernel of
the port runs here: all three are plain PyTorch. One JSON report with JAX's
keys; ``platform`` names the card and its power limit.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.bound_turf [--n 262144] \\
      [--dims 128 512 1024] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from recommendit_tpu_torch.scripts.retrieval_common import default_out, timed_ms, write_report
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, platform_name, resolve_device

EXACT_BLOCK = 65536   # the block JAX's exact and count-verified calls pass
ROUNDS = 3


def make_data(rng, n: int, d: int, n_q: int):
    """One width's corpus and queries from ``rng``, as numpy f32 arrays."""
    items_np = rng.normal(size=(n, d)).astype(np.float32)
    items_np /= np.linalg.norm(items_np, axis=1, keepdims=True)
    q0 = rng.normal(size=(n_q, d)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    return items_np, q0


def variants(args):
    from recommendit_tpu_torch.ops.topk import (
        mips_topk,
        mips_topk_bound_verified,
        mips_topk_verified,
    )

    return {
        "exact": lambda qq, it: mips_topk(qq, it, args.k, EXACT_BLOCK),
        "count_verified": lambda qq, it: mips_topk_verified(qq, it, args.k, EXACT_BLOCK),
        "bound_verified": lambda qq, it: mips_topk_bound_verified(qq, it, args.k, args.m),
    }


def run(args) -> dict:
    dev = resolve_device(args.device)
    rows = []
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for d in args.dims:
            n = args.n * 128 // d     # the corpus slab keeps its bytes across widths
            items_np, q_np = make_data(rng, n, d, args.q)
            items = torch.as_tensor(items_np, device=dev)
            q0 = torch.as_tensor(q_np, device=dev)
            del items_np
            for name, fn in variants(args).items():
                ms = timed_ms(f"{name} d={d}", fn, q0, items, iters=args.iters,
                              rounds=ROUNDS)
                row = {"dim": d, "n": n, "variant": name, "batch_ms": round(ms, 2),
                       "qps": round(args.q / (ms / 1000), 1)}
                if name.endswith("verified"):
                    row["certified_frac"] = float(fn(q0, items)[2].float().mean())
                rows.append(row)
                print(json.dumps(row), flush=True)
            del items
    return {"q": args.q, "k": args.k, "m": args.m, "platform": platform_name(dev),
            "rows": rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--dims", type=int, nargs="+", default=[128, 512, 1024])
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=default_out("bound_turf.json"))
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
