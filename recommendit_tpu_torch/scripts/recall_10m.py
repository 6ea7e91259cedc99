"""Recall@500 of the window kernel at 10M x 128 bf16 — torch port of
``scripts/recall_10m.py``.

The corpus is ``--n`` unit rows of ``--d`` columns in bf16, made on the
device in 1M-row chunks from a seeded ``torch.Generator`` (``--seed``;
JAX's ``jax.random.normal`` stream cannot be replayed, so the rows are
other rows of the same distribution), zero-padded to a ``--block``
multiple. ``--queries`` unit queries come from numpy's ``default_rng(1)``,
as in JAX. Three searches of the same queries:

* kernel 1 directly at window 512 (``mips_topk_window_im`` with
  ``n_valid``: the padded tail masked) — on the card its tensor-core body;
* the production entry ``mips_topk_fused_auto``, which routes a batch
  this small to the dense scan;
* the exact top-k over the same bf16 rows (``mips_topk`` exact mode, f32
  scores in column chunks),

and recall@k of the first two against the third, beside the bin model's
``1 - (k - 1) * 512 / (2 n)``. One JSON report with JAX's keys;
``platform`` names the card and its power limit.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.recall_10m [--n 10000000] \\
      [--queries 64] [--out FILE]
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
    write_report,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, platform_name, resolve_device

WINDOW = 512          # the auto rule's ceiling, which 10M rows take
CHUNK = 1_000_000     # rows made at a time, as JAX makes them
EXACT_BLOCK = 65536   # the block JAX's exact reference passes


def make_corpus(n: int, d: int, block: int, seed: int, device) -> torch.Tensor:
    """(n + pad, d) bf16: ``n`` unit rows from a seeded generator on
    ``device``, made ``CHUNK`` rows at a time, then zero rows up to a
    ``block`` multiple."""
    items = torch.zeros((n + (-n) % block, d), dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for r0 in range(0, n, CHUNK):
        x = torch.randn((min(CHUNK, n - r0), d), generator=gen, device=device)
        items[r0:r0 + x.shape[0]] = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    return items


def make_queries(n_q: int, d: int, device) -> torch.Tensor:
    """JAX's queries: ``default_rng(1)`` normals, f32, unit rows."""
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(n_q, d)).astype(np.float32), device=device)
    return q / q.norm(dim=1, keepdim=True)


def _timed(dev, fn):
    t0 = time.time()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.time() - t0


def run(args, items_padded=None) -> dict:
    """The report; ``items_padded`` is :func:`make_corpus`'s corpus when
    the caller made it already."""
    from recommendit_tpu_torch.ops.mips_window import (
        mips_topk_fused_auto,
        mips_topk_window_im,
    )
    from recommendit_tpu_torch.ops.topk import mips_topk

    dev = resolve_device(args.device)
    n, d, k = args.n, args.d, args.k
    if items_padded is None:
        items_padded = make_corpus(n, d, args.block, args.seed, dev)
    items = items_padded[:n]
    print(f"corpus on device: {tuple(items_padded.shape)} bf16", flush=True)
    q = make_queries(args.queries, d, dev)

    with torch.no_grad():
        (_, fi), t_fused = _timed(dev, lambda: mips_topk_window_im(
            q, items_padded, k, args.block, WINDOW, "default", n))
        print(f"fused kernel (w={WINDOW}) done in {t_fused:.1f}s", flush=True)
        (_, ai), t_approx = _timed(dev, lambda: mips_topk_fused_auto(
            q, items_padded, k, args.block, n_valid=n))
        print(f"approx-scan engine done in {t_approx:.1f}s", flush=True)
        (_, ei), t_exact = _timed(dev, lambda: mips_topk(
            q, items, k, EXACT_BLOCK, "exact"))
        print(f"exact done in {t_exact:.1f}s", flush=True)

    ei = ei.cpu().numpy()
    rk = recall_rows(fi.cpu().numpy(), ei, k)
    ra = recall_rows(ai.cpu().numpy(), ei, k)
    return {
        "n": n, "d": d, "k": k, "queries": args.queries,
        "corpus_dtype": "bfloat16",
        "kernel_recall_at_500_mean": round(float(np.mean(rk)), 4),
        "kernel_recall_at_500_min": round(float(np.min(rk)), 4),
        "kernel_recall_at_500_p10": round(float(np.percentile(rk, 10)), 4),
        "approx_scan_recall_at_500_mean": round(float(np.mean(ra)), 4),
        "bin_model_recall": round(1 - (k - 1) * WINDOW / (2 * n), 4),
        "window_used": WINDOW,
        "platform": platform_name(dev),
        "kernel_wall_s": round(t_fused, 1),
        "approx_wall_s": round(t_approx, 1),
        "exact_wall_s": round(t_exact, 1),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--out", default=default_out("recall_10m.json"))
    ap.add_argument("--seed", type=int, default=0, help="the corpus generator's seed")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    print(json.dumps(out), flush=True)
    write_report(out, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
