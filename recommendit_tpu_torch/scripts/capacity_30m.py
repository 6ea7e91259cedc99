"""30M x 128 int8 items on one card — torch port of
``scripts/capacity_30m.py``.

The corpus is ``--n`` unit rows of ``--d`` columns made on the device
``CHUNK`` rows at a time from a seeded ``torch.Generator`` (``--seed``;
JAX's ``jax.random.normal`` stream cannot be replayed, so the rows are
other rows of the same distribution) and quantised there to int8 with
per-row scales by ``quantize_int8(x, seed, row_offset=r0)`` (JAX's
threefry build, stochastic rounding, rule 1), then padded with zero rows
of scale 0 to a ``--block`` multiple. Kernel 3 (``mips_topk_window_im_int8``
at window 512, the padded tail masked by ``n_valid``): recall@k on
``--recall-queries`` queries against the exact top-k of the same int8
scores (``mips_topk_int8`` exact mode), and batch ms and QPS at ``--q``
queries, chained (``utils/profiling.device_loop_time``, ``--iters`` a
round, best of 3). Queries from numpy's ``default_rng(1)``, as in JAX. One
JSON report with JAX's keys; ``platform`` names the card and its power
limit.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.capacity_30m [--n 30000000] \\
      [--q 1024] [--out FILE]
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

WINDOW = 512          # the auto rule's ceiling; n_cand = ceil(n / 512)
CHUNK = 1 << 21       # rows made and quantised at a time
EXACT_BLOCK = 65536   # the block JAX's exact reference passes
ROUNDS = 3


def make_corpus(n: int, d: int, block: int, seed: int, device, chunk: int = CHUNK):
    """((n + pad, d) int8, (n + pad,) f32 scales): ``n`` unit rows from a
    seeded generator on ``device``, quantised ``chunk`` rows at a time with
    the threefry counter offset by each chunk's first row, then zero rows
    of scale 0 up to a ``block`` multiple."""
    from recommendit_tpu_torch.ops.quantize import quantize_int8

    n_pad = n + (-n) % block
    corpus = torch.zeros((n_pad, d), dtype=torch.int8, device=device)
    scales = torch.zeros(n_pad, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for r0 in range(0, n, chunk):
        x = torch.randn((min(chunk, n - r0), d), generator=gen, device=device)
        x = x / x.norm(dim=1, keepdim=True)
        corpus[r0:r0 + x.shape[0]], scales[r0:r0 + x.shape[0]] = \
            quantize_int8(x, seed, row_offset=r0)
        del x
    return corpus, scales


def make_queries(args, device):
    """JAX's queries from ``default_rng(1)``: the recall queries, then the
    timed batch."""
    rng = np.random.default_rng(1)
    qr = rng.normal(size=(args.recall_queries, args.d)).astype(np.float32)
    q0 = rng.normal(size=(args.q, args.d)).astype(np.float32)
    return torch.as_tensor(qr, device=device), torch.as_tensor(q0, device=device)


def run(args, corpus=None, window: int = WINDOW) -> dict:
    """The report; ``corpus`` is :func:`make_corpus`'s (rows, scales) when
    the caller made it already. ``window`` stays JAX's 512 but for small
    rehearsals."""
    from recommendit_tpu_torch.ops.mips_window import mips_topk_window_im_int8
    from recommendit_tpu_torch.ops.topk import mips_topk_int8

    dev = resolve_device(args.device)
    n, d, k = args.n, args.d, args.k
    items, scales = corpus if corpus is not None else \
        make_corpus(n, d, args.block, args.seed, dev)
    print(f"corpus on device: {tuple(items.shape)} int8 "
          f"({items.numel() / 2**30:.2f} GiB)", flush=True)

    def fn(qq, it):
        return mips_topk_window_im_int8(qq, it, scales, k, args.block, window, n)

    qr, q0 = make_queries(args, dev)
    with torch.no_grad():
        t0 = time.time()
        _, fi = fn(qr, items)
        fi = fi.cpu().numpy()
        t_k = time.time() - t0
        _, ei = mips_topk_int8(qr, items, scales, k, "exact", n_valid=n)
        recalls = recall_rows(fi, ei.cpu().numpy(), k)
        ms = timed_ms(f"capacity q={args.q}", fn, q0, items, iters=args.iters,
                      rounds=ROUNDS)

    return {
        "n": n, "d": d, "k": k, "q": args.q, "window": window,
        "corpus_gib_int8": round(items.numel() / 2**30, 2),
        "batch_ms": round(ms, 2),
        "qps": round(args.q / (ms / 1000), 1),
        "recall_at_500_vs_int8_exact_mean": round(float(np.mean(recalls)), 4),
        "recall_at_500_min": round(float(np.min(recalls)), 4),
        "platform": platform_name(dev),
        "single_call_s": round(t_k, 2),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--recall-queries", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=default_out("capacity_30m.json"))
    ap.add_argument("--seed", type=int, default=0,
                    help="the corpus generator's and the quantiser's seed")
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
