"""The fused route's parts, timed in one process — torch port of
``scripts/fused_decomp.py``.

JAX's arrays from numpy's ``default_rng(0)``: a decimal corpus of
``--n-dec`` (1,000,000) and a binary one of ``--n-bin`` (2^20) normal rows,
normalised, bf16, the decimal one zero-padded to a ``--block`` multiple;
then at each of ``--qs`` a batch of raw normal queries. Each timed chained
(``utils/profiling.device_loop_time``, ``--iters`` a round, best of 4):

* ``dec1M_w64_masked`` / ``dec1M_w32_masked`` — kernel 1 over the decimal
  corpus at window 64 and 32, the padded tail masked (``n_valid``);
* ``bin1M_w64_nomask`` — kernel 1 over the binary corpus, no mask;
* ``auto_dec1M`` — the production entry ``mips_topk_fused_auto``;
* ``tail_fast_topk_{15680,31360}`` — the top-k tail alone (``fast_topk``)
  over as many normal candidates as windows 64 and 32 give at 1M rows.

On the card kernel 1 takes its tensor-core body (bf16). One JSON report
with JAX's keys; ``platform`` names the card and its power limit.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.fused_decomp [--qs 256 1024] \\
      [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from recommendit_tpu_torch.scripts.retrieval_common import default_out, timed_ms, write_report
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, platform_name, resolve_device

TAIL_CANDS = (15_680, 31_360)   # window maxima of 1M padded rows at W = 64, 32
ROUNDS = 4


def make_corpora(rng, args, device):
    """(decimal corpus padded to a block multiple, binary corpus), bf16."""
    def corpus(n):
        it = rng.normal(size=(n, args.d)).astype(np.float32)
        it /= np.linalg.norm(it, axis=1, keepdims=True)
        return torch.as_tensor(it, device=device).to(torch.bfloat16)

    items_dec = corpus(args.n_dec)
    items_dec = torch.nn.functional.pad(items_dec, (0, 0, 0, (-args.n_dec) % args.block))
    return items_dec, corpus(args.n_bin)


def variants(args, items_dec, items_bin):
    """[(name, fn(q, it), corpus)] in JAX's order."""
    from recommendit_tpu_torch.ops.mips_window import (
        mips_topk_fused_auto,
        mips_topk_window_im,
    )

    k, blk, n_dec = args.k, args.block, args.n_dec
    return [
        ("dec1M_w64_masked", lambda qq, it: mips_topk_window_im(
            qq, it, k, blk, 64, "default", n_dec), items_dec),
        ("dec1M_w32_masked", lambda qq, it: mips_topk_window_im(
            qq, it, k, blk, 32, "default", n_dec), items_dec),
        ("bin1M_w64_nomask", lambda qq, it: mips_topk_window_im(
            qq, it, k, blk, 64, "default", None), items_bin),
        ("auto_dec1M", lambda qq, it: mips_topk_fused_auto(
            qq, it, k, blk, n_valid=n_dec), items_dec),
    ]


def run(args, data=None) -> dict:
    """The report; ``data`` is (``default_rng(0)`` after
    :func:`make_corpora`, the decimal corpus, the binary one) when the
    caller made the corpora already."""
    from recommendit_tpu_torch.ops.topk import fast_topk

    dev = resolve_device(args.device)
    k = args.k
    if data is None:
        rng = np.random.default_rng(0)
        data = (rng, *make_corpora(rng, args, dev))
    rng, items_dec, items_bin = data

    rows = []
    with torch.no_grad():
        for q in args.qs:
            q0 = torch.as_tensor(rng.normal(size=(q, args.d)).astype(np.float32),
                                 device=dev)
            for name, fn, it in variants(args, items_dec, items_bin):
                ms = timed_ms(f"{name} q={q}", fn, q0, it, iters=args.iters,
                              rounds=ROUNDS)
                row = {"variant": name, "q": q, "batch_ms": round(ms, 3),
                       "qps": round(q / (ms / 1000), 1)}
                rows.append(row)
                print(json.dumps(row), flush=True)
            for n_cand in TAIL_CANDS:
                cand = torch.as_tensor(rng.normal(size=(q, n_cand)).astype(np.float32),
                                       device=dev)
                ms = timed_ms(f"tail_fast_topk_{n_cand} q={q}",
                              lambda c, _: fast_topk(c, k), cand, items_bin,
                              iters=args.iters, rounds=ROUNDS)
                row = {"variant": f"tail_fast_topk_{n_cand}", "q": q,
                       "batch_ms": round(ms, 3)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return {"platform": platform_name(dev), "k": k, "d": args.d, "block": args.block,
            "rows": rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qs", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--n-dec", type=int, default=1_000_000,
                    help="rows of the decimal (padded, masked) corpus")
    ap.add_argument("--n-bin", type=int, default=1 << 20,
                    help="rows of the binary (unmasked) corpus")
    ap.add_argument("--out", default=default_out("fused_decomp.json"))
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
