"""Exact ``mips_topk`` in three forms, on the card, in one call: the old
body (one (Q, N) full-f32 product and one ``torch.topk``), the windowed
path (``_exact_topk``: column chunks of at most ``_SCORE_BUDGET`` entries,
window-max selection) and ``ops/topk.mips_topk`` as it dispatches (the old
body below ``_WINDOWED_MIN_Q`` queries within one chunk, else the windowed
path), over N x 129 f32 unit rows (the serve catalog's width with its bias
column) at each Q of ``--qs``, k = 500, by CUDA events in the order old,
windowed, new, new, windowed, old per Q; the lists equal in
``canonical_tie_order``. A measurement tool, outside the package: nothing
imports it.

    python3 tools/exact_topk_ab.py [--n 1000000] [--reps 5] [--qs 1,4,16,...]

Prints the card's name and power limit, one JSON line per Q and a summary.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=129)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--qs", default="1,2,4,8,16,32,64,128,256,1024")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exact_topk_ab: no CUDA device", file=sys.stderr)
        return 2
    from recommendit_tpu_torch.ops import topk
    from recommendit_tpu_torch.ops.topk import (
        canonical_tie_order,
        fast_topk,
        mips_topk,
        score_matrix,
    )

    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    items = torch.nn.functional.normalize(
        torch.randn(args.n, args.d, device=dev, generator=gen), dim=1)

    def old(q):
        return fast_topk(score_matrix(q, items, "highest"), args.k)

    def windowed(q):
        return topk._exact_topk(q, items, args.k)

    def new(q):
        return mips_topk(q, items, args.k)

    forms = {"old": old, "windowed": windowed, "new": new}
    rows = []
    for n_q in (int(x) for x in args.qs.split(",")):
        q = torch.nn.functional.normalize(
            torch.randn(n_q, args.d, device=dev, generator=gen), dim=1)
        lists = {name: canonical_tie_order(*fn(q)) for name, fn in forms.items()}
        times = {name: [] for name in forms}
        for name in ("old", "windowed", "new", "new", "windowed", "old"):
            times[name].append(chip_smoke.cuda_ms(lambda: forms[name](q), args.reps))
        ov, oi = lists["old"]
        row = {"q": n_q, "n": args.n, "d": args.d, "k": args.k,
               "min_q_windowed": topk._WINDOWED_MIN_Q,
               **{f"{name}_ms": t for name, t in times.items()},
               "ids_equal": all(bool(torch.equal(oi, i)) for _, i in lists.values()),
               "values_equal": all(bool(torch.equal(ov, v)) for v, _ in lists.values()),
               "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"exact_topk_ab": [
        {"q": r["q"], **{f"{name}_ms": min(r[f"{name}_ms"]) for name in forms}}
        for r in rows]}), flush=True)
    return 0 if all(r["ids_equal"] and r["values_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
