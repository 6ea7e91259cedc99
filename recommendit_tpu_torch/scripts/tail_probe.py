"""Top-k tail strategies over window maxima — torch port of
``scripts/tail_probe.py``.

JAX's candidates: a (``--q``, ``--n-cand``) f32 normal matrix from numpy's
``default_rng(0)`` (15,680 is the count of window maxima of 1M padded rows
at window 64). Each strategy timed chained
(``utils/profiling.device_loop_time``, ``--iters`` a round, best of 4):

* ``fast_topk_rt1`` — one exact top-k (``fast_topk``);
* ``halves_merge`` / ``quarters_merge`` — the top-k of each half or
  quarter of the row, merged by one more top-k;
* ``approx_rt099`` / ``approx_rt095`` — ``fast_topk`` at recall target
  0.99 and 0.95: exact here (C.4), where JAX's is ``approx_max_k``;
* ``lax_top_k`` — ``torch.topk``, the counterpart of ``lax.top_k``.

No kernel of the port runs here. One JSON report with JAX's keys;
``platform`` names the card and its power limit.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m recommendit_tpu_torch.scripts.tail_probe [--q 256] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from recommendit_tpu_torch.scripts.retrieval_common import default_out, timed_ms, write_report
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, platform_name, resolve_device

ROUNDS = 4


def variants(k: int):
    """[(name, fn(scores) -> (values, ids))] in JAX's order."""
    from recommendit_tpu_torch.ops.topk import fast_topk

    def halves_merge(s):
        h = s.shape[1] // 2
        v1, i1 = fast_topk(s[:, :h], k)
        v2, i2 = fast_topk(s[:, h:], k)
        mv, ms = fast_topk(torch.cat([v1, v2], dim=1), k)
        return mv, torch.gather(torch.cat([i1, i2 + h], dim=1), 1, ms)

    def quarters_merge(s, ncn=4):
        q, w = s.shape
        chunk = -(-w // ncn)
        sp = torch.nn.functional.pad(s, (0, ncn * chunk - w), value=float("-inf"))
        cv, ci = fast_topk(sp.view(q, ncn, chunk), k)
        base = (torch.arange(ncn, device=s.device) * chunk)[None, :, None]
        mv, ms = fast_topk(cv.reshape(q, -1), k)
        return mv, torch.gather((ci + base).reshape(q, -1), 1, ms)

    return [("fast_topk_rt1", lambda s: fast_topk(s, k)),
            ("halves_merge", halves_merge),
            ("quarters_merge", quarters_merge),
            ("approx_rt099", lambda s: fast_topk(s, k, 0.99)),
            ("approx_rt095", lambda s: fast_topk(s, k, 0.95)),
            ("lax_top_k", lambda s: torch.topk(s, k))]


def make_candidates(q: int, n_cand: int) -> np.ndarray:
    return np.random.default_rng(0).normal(size=(q, n_cand)).astype(np.float32)


def run(args) -> dict:
    dev = resolve_device(args.device)
    cand = torch.as_tensor(make_candidates(args.q, args.n_cand), device=dev)
    rows = []
    with torch.no_grad():
        for name, fn in variants(args.k):
            ms = timed_ms(name, fn, cand, iters=args.iters, rounds=ROUNDS)
            row = {"variant": name, "q": args.q, "n_cand": args.n_cand, "k": args.k,
                   "ms": round(ms, 3)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return {"rows": rows, "platform": platform_name(dev)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--n-cand", type=int, default=15680)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=default_out("tail_probe.json"))
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
